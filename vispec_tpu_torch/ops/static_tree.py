"""Static (hand-designed) draft trees: the JAX package's
``ops/static_tree.py``.

A static tree is a ``tree.Tree`` built once on the host from a list of
root-relative paths of child ranks, the "choices" format of the Medusa and
EAGLE repositories, sorted by (depth, path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .tree import Tree

# the published 25-node static tree (Medusa / EAGLE ``mc_sim_7b_63``):
# root-relative paths of child ranks
MC_SIM_7B_63: Tuple[Tuple[int, ...], ...] = (
    (0,), (1,), (2,), (3,),
    (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0),
    (0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 0), (0, 1, 1), (0, 2, 0),
    (0, 2, 1), (1, 0, 0),
    (0, 0, 0, 0), (0, 0, 0, 1), (0, 0, 0, 2),
    (0, 0, 0, 0, 0), (0, 0, 0, 0, 1),
)


def _sorted_paths(choices: Sequence[Tuple[int, ...]]):
    return sorted(choices, key=lambda x: (len(x), x))


def from_choices(choices: Sequence[Tuple[int, ...]], tokens=None, device="cuda") -> Tree:
    """A Tree of ``len(choices) + 1`` nodes from a choices-style path list;
    node 0 is the root and nodes sort by (depth, path).  ``tokens``
    optionally fills the token ids (``[len(choices) + 1]``)."""
    paths = _sorted_paths(choices)
    n = len(paths) + 1
    index_of = {(): 0}
    parent = np.zeros(n, np.int32)
    for i, path in enumerate(paths):
        index_of[tuple(path)] = i + 1
        parent[i + 1] = index_of[tuple(path[:-1])]
    mask = np.eye(n, dtype=bool)
    for i in range(1, n):
        mask[i] |= mask[parent[i]]
    depth = mask.sum(1).astype(np.int32) - 1
    if tokens is None:
        tokens = np.zeros(n, np.int32)
    return Tree(tokens=torch.as_tensor(np.asarray(tokens), dtype=torch.int32, device=device),
                parent=torch.as_tensor(parent, device=device),
                mask=torch.as_tensor(mask, device=device),
                depth=torch.as_tensor(depth, device=device))


def fill_tokens(tree: Tree, per_level_topk: torch.Tensor,
                choices: Sequence[Tuple[int, ...]], sample_token) -> Tree:
    """The static tree with its tokens filled from per-(parent, rank) top-k
    ids: ``per_level_topk [n_nodes, k_max]`` (row 0 the root); the node of
    path p takes ``per_level_topk[parent(p), p[-1]]``."""
    paths = _sorted_paths(choices)
    index_of = {(): 0}
    rows, cols = [], []
    for i, path in enumerate(paths):
        index_of[tuple(path)] = i + 1
        rows.append(index_of[tuple(path[:-1])])
        cols.append(path[-1])
    device = per_level_topk.device
    picked = per_level_topk[torch.as_tensor(rows, device=device),
                            torch.as_tensor(cols, device=device)]
    root = torch.as_tensor(sample_token, device=device).reshape(1)
    return tree._replace(tokens=torch.cat([root, picked]).to(torch.int32))
