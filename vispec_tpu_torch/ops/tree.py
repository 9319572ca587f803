"""Static-shape draft-tree algebra: tree construction from the flat beam
pool, the accepted path, and the acceptance walks (greedy, and the
rejection-sampling walk of T > 0).

The tree is a parent-pointer array of static size T = total_tokens: node 0 is
the sampled root, nodes follow ascending flat-candidate order so
parent[i] < i, and every step is a vectorized gather — no host round trip.
Every function also takes a leading slot dim (one tree per slot of a batch,
as ``jax.vmap`` gives the JAX versions).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .kv_cache import take_rows
from .topk import top_k


class Tree(NamedTuple):
    """tokens [B?, T] int32 (tokens[..., 0] is the root), parent [B?, T]
    int32 (parent[..., 0] = 0), mask [B?, T, T] bool ancestor closure incl.
    self, depth [B?, T] int32 (root = 0)."""

    tokens: torch.Tensor
    parent: torch.Tensor
    mask: torch.Tensor
    depth: torch.Tensor

    @property
    def size(self) -> int:
        return self.tokens.shape[-1]


def build_tree(
    sample_token: torch.Tensor,  # [B?] int32 — the committed root token
    tokens_flat: torch.Tensor,  # [B?, C] int32 — candidate tokens, flat order
    scores_flat: torch.Tensor,  # [B?, C] float — cumulative log-probs
    parent1_flat: torch.Tensor,  # [B?, C] int32 — 1-based flat parent (0 = root)
    total_tokens: int,
    max_depth: int,  # deepest possible node depth (= cfg.depth + 1)
) -> Tree:
    """Global top-(T-1) re-ranking + parent-pointer tree construction."""
    device = tokens_flat.device
    lead = tokens_flat.shape[:-1]
    _, sel = top_k(scores_flat, total_tokens - 1)
    sel = torch.sort(sel.to(torch.int64), dim=-1).values  # ascending: parents first

    tokens = torch.cat([sample_token.unsqueeze(-1).to(torch.int32),
                        take_rows(tokens_flat, -1, sel).to(torch.int32)], dim=-1)
    par1 = take_rows(parent1_flat, -1, sel).to(torch.int64)
    ppos = torch.searchsorted(sel, par1 - 1) + 1
    parent_tail = torch.where(par1 == 0, 0, ppos)
    parent = torch.cat([torch.zeros(*lead, 1, dtype=torch.int64, device=device),
                        parent_tail], dim=-1)

    eye = torch.eye(total_tokens, dtype=torch.bool, device=device)
    mask = eye
    cursor = torch.arange(total_tokens, device=device).expand_as(parent)
    for _ in range(max_depth):
        cursor = torch.gather(parent, -1, cursor)
        mask = mask | eye[cursor]
    depth = mask.sum(dim=-1).to(torch.int32) - 1
    return Tree(tokens=tokens, parent=parent.to(torch.int32), mask=mask, depth=depth)


def path_to_root(tree: Tree, node: torch.Tensor, max_path: int) -> torch.Tensor:
    """[B?, max_path] int32 — node indices root..node ordered by depth; slots
    past depth(node) padded with the node itself."""
    device = tree.tokens.device
    node = node.unsqueeze(-1).to(torch.int64)  # [B?, 1]
    t = tree.size
    anc = torch.gather(tree.mask, -2, node[..., None].expand(*node.shape, t))
    anc = anc.squeeze(-2)  # [B?, T] the chain root..node
    idx = torch.arange(t, dtype=torch.int32, device=device)
    cols = torch.arange(max_path, dtype=torch.int32, device=device)
    onehot = anc.unsqueeze(-2) & (tree.depth.unsqueeze(-2) == cols[:, None])  # [B?, P, T]
    path = torch.where(onehot, idx, 0).sum(dim=-1).to(torch.int32)
    node_depth = take_rows(tree.depth, -1, node)
    return torch.where(cols <= node_depth, path, node.to(torch.int32))


def greedy_accept(
    tree: Tree,
    argmax_tokens: torch.Tensor,  # [B?, T] int32 — argmax of target logits per node
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (T=0) acceptance: node i is accepted iff every node on its root
    path matched its parent's argmax.  Returns (best_node, accept_length),
    each [B?], accept_length counting accepted non-root nodes; among equally
    deep accepted nodes the first wins, as ``jnp.argmax`` picks."""
    idx = torch.arange(tree.size, device=tree.tokens.device)
    match = (tree.tokens == take_rows(argmax_tokens, -1, tree.parent)) | (idx == 0)
    accepted = ~torch.any(tree.mask & ~match.unsqueeze(-2), dim=-1)
    depth_if = torch.where(accepted, tree.depth, -1)
    best = torch.argmax(depth_if, dim=-1).to(torch.int32)
    return best, take_rows(depth_if, -1, best.unsqueeze(-1)).squeeze(-1)


def sampling_accept(
    tree: Tree,
    probs: torch.Tensor,  # [B?, T, V] — processed target probabilities per node
    uniforms: torch.Tensor,  # [B?, max_depth, T] in [0, 1)
    max_depth: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Temperature > 0 acceptance: multi-candidate rejection sampling down
    the tree.  At the current node, its children in node order: child j is
    accepted iff ``u_j * (1 - sum_{i<j} p(x_i)) <= p(x_j)`` (the closed form
    of reject-and-renormalise), evaluated for all children of a depth at
    once.  A child of probability 0 is never accepted, even at u = 0, so
    one-hot probabilities (greedy slots) give the greedy walk.

    Returns (best_node [B?], accept_length [B?], residual [B?, V]): the
    distribution of the bonus token, the leftover of the node where the
    walk stopped with its children's tokens removed and renormalised, or
    the last node's own p if the walk accepted at every depth."""
    device = tree.tokens.device
    node_ids = torch.arange(tree.size, device=device)
    lead = tree.tokens.shape[:-1]
    cur = torch.zeros(lead, dtype=torch.int64, device=device)
    alive = torch.ones(lead, dtype=torch.bool, device=device)
    resid = probs[..., 0, :]
    # an id past the vocab is clamped, as JAX's gather clamps (only the
    # root's id can be one, and the root is nobody's child)
    tokens = tree.tokens.to(torch.int64).clamp(0, probs.shape[-1] - 1)
    for d in range(max_depth):
        is_child = ((tree.parent == cur.unsqueeze(-1)) & (node_ids != 0)
                    & (tree.depth == d + 1))
        p_cur = take_rows(probs, -2, cur.unsqueeze(-1)).squeeze(-2)  # [B?, V]
        child_p = torch.where(is_child, torch.gather(p_cur, -1, tokens), 0.0)
        before = torch.cumsum(child_p, dim=-1) - child_p  # earlier children's mass
        accept = is_child & (child_p > 0) & (
            uniforms[..., d, :] * torch.clamp(1.0 - before, min=1e-20) <= child_p)
        any_accept = torch.any(accept, dim=-1) & alive
        first = torch.argmax(accept.to(torch.uint8), dim=-1)  # first True in node order
        dies_here = alive & ~any_accept
        resid = torch.where(dies_here.unsqueeze(-1), _residual(p_cur, tokens, is_child),
                            resid)
        cur = torch.where(any_accept, first, cur)
        alive = alive & any_accept
    p_last = take_rows(probs, -2, cur.unsqueeze(-1)).squeeze(-2)
    resid = torch.where(alive.unsqueeze(-1), p_last, resid)
    accept_length = take_rows(tree.depth, -1, cur.unsqueeze(-1)).squeeze(-1)
    return cur.to(torch.int32), accept_length, resid


def _residual(p: torch.Tensor, tokens: torch.Tensor, is_child: torch.Tensor) -> torch.Tensor:
    """p with every child token's mass removed, renormalised.  A non-child
    node carrying a child's token must not clear its mark: the marks are
    scattered with ``amax``, as JAX's ``.at[tokens].max``."""
    removed = torch.zeros_like(p).scatter_reduce(-1, tokens, is_child.to(p.dtype), "amax")
    out = p * (1.0 - removed)
    return out / torch.clamp(out.sum(dim=-1, keepdim=True), min=1e-20)
