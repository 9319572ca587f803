"""Weights bridge: nested dicts of numpy arrays, keyed as the JAX package's
parameter pytrees, to the port's tensors.

Accepts the output of the JAX ``llama.init_params`` / ``draft.init_params``
(converted leaf by leaf with ``numpy.asarray``) or the ``t/...`` and
``d/...`` keys of an ``.npz`` file such as ``tests/data/tau_fixture.npz``.
Layouts are unchanged: ``[in, out]`` matrices, layer-stacked ``[L, ...]``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def from_numpy(tree: Mapping, device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of arrays -> nested dict of tensors on ``device``.

    ``dtype`` casts floating leaves, except the norm weights (keys containing
    ``norm``), which stay float32 as in the JAX pytrees; None keeps each
    array's own dtype."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = from_numpy(leaf, device, dtype)
            continue
        t = torch.from_numpy(np.array(leaf))  # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(torch.float32 if "norm" in key else dtype)
        out[key] = t.to(device)
    return out


def npz_side(z: Mapping, side: str) -> dict:
    """The nested dict under one side's prefix of a flat ``a/b/c`` keyed
    archive (``side`` is ``"t"`` for the target, ``"d"`` for the draft)."""
    out: dict = {}
    prefix = side + "/"
    for key in z:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(z[key])
    return out
