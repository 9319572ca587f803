"""Static-shape draft-tree algebra (greedy half): tree construction from the
flat beam pool, the accepted path, and the greedy acceptance walk.

The tree is a parent-pointer array of static size T = total_tokens: node 0 is
the sampled root, nodes follow ascending flat-candidate order so
parent[i] < i, and every step is a vectorized gather — no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .topk import top_k


class Tree(NamedTuple):
    """tokens [T] int32 (tokens[0] is the root), parent [T] int32
    (parent[0] = 0), mask [T, T] bool ancestor closure incl. self,
    depth [T] int32 (root = 0)."""

    tokens: torch.Tensor
    parent: torch.Tensor
    mask: torch.Tensor
    depth: torch.Tensor

    @property
    def size(self) -> int:
        return self.tokens.shape[0]


def build_tree(
    sample_token: torch.Tensor,  # [] int32 — the committed root token
    tokens_flat: torch.Tensor,  # [C] int32 — candidate tokens, flat order
    scores_flat: torch.Tensor,  # [C] float — cumulative log-probs
    parent1_flat: torch.Tensor,  # [C] int32 — 1-based flat parent (0 = root)
    total_tokens: int,
    max_depth: int,  # deepest possible node depth (= cfg.depth + 1)
) -> Tree:
    """Global top-(T-1) re-ranking + parent-pointer tree construction."""
    device = tokens_flat.device
    _, sel = top_k(scores_flat, total_tokens - 1)
    sel = torch.sort(sel.to(torch.int64)).values  # ascending: parents first

    tokens = torch.cat([sample_token.reshape(1).to(torch.int32),
                        tokens_flat[sel].to(torch.int32)])
    par1 = parent1_flat[sel].to(torch.int64)
    ppos = torch.searchsorted(sel, par1 - 1) + 1
    parent_tail = torch.where(par1 == 0, 0, ppos)
    parent = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), parent_tail])

    eye = torch.eye(total_tokens, dtype=torch.bool, device=device)
    mask = eye
    cursor = torch.arange(total_tokens, device=device)
    for _ in range(max_depth):
        cursor = parent[cursor]
        mask = mask | eye[cursor]
    depth = mask.sum(dim=1).to(torch.int32) - 1
    return Tree(tokens=tokens, parent=parent.to(torch.int32), mask=mask, depth=depth)


def path_to_root(tree: Tree, node: torch.Tensor, max_path: int) -> torch.Tensor:
    """[max_path] int32 — node indices root..node ordered by depth; slots past
    depth(node) padded with the node itself."""
    device = tree.tokens.device
    node = node.reshape(1).to(torch.int64)
    anc = tree.mask.index_select(0, node)[0]  # [T] the chain root..node
    idx = torch.arange(tree.size, dtype=torch.int32, device=device)
    cols = torch.arange(max_path, dtype=torch.int32, device=device)
    onehot = anc[None, :] & (tree.depth[None, :] == cols[:, None])  # [P, T]
    path = torch.where(onehot, idx[None, :], 0).sum(dim=1).to(torch.int32)
    node_depth = tree.depth.index_select(0, node)
    return torch.where(cols <= node_depth, path, node.to(torch.int32))


def greedy_accept(
    tree: Tree,
    argmax_tokens: torch.Tensor,  # [T] int32 — argmax of target logits per node
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (T=0) acceptance: node i is accepted iff every node on its root
    path matched its parent's argmax.  Returns (best_node, accept_length),
    accept_length counting accepted non-root nodes."""
    idx = torch.arange(tree.size, device=tree.tokens.device)
    match = (tree.tokens == argmax_tokens[tree.parent.to(torch.int64)]) | (idx == 0)
    accepted = ~torch.any(tree.mask & ~match[None, :], dim=1)
    depth_if = torch.where(accepted, tree.depth, -1)
    best = torch.argmax(depth_if).to(torch.int32)
    return best, depth_if.index_select(0, best.reshape(1).to(torch.int64))[0]
