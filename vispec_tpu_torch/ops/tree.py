"""Static-shape draft-tree algebra (greedy half): tree construction from the
flat beam pool, the accepted path, and the greedy acceptance walk.

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
