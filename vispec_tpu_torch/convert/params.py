"""Weights bridge: nested dicts of numpy arrays, keyed as the JAX package's
parameter pytrees, to the port's tensors.

Accepts the output of the JAX ``llama.init_params`` / ``draft.init_params``
/ ``clip_vit.init_params`` / ``llava.init_projector_params``, a Qwen2.5-VL
vision tree (``patch_w``, ``blocks``, ``merger``) (converted
leaf by leaf with ``numpy.asarray``) or the ``t/...`` and
``d/...`` keys of an ``.npz`` file such as ``tests/data/tau_fixture.npz``.
Layouts are unchanged: ``[in, out]`` matrices, layer-stacked ``[L, ...]``.
Quantized leaves (the JAX ``QTensor`` / ``Q4Tensor`` NamedTuples of arrays)
cross field by field into the port's ``ops.quant`` containers.  A JAX
Mixtral tree (``router``, ``we_gate``, ``we_up``, ``we_down``) carries
across with its expert gate and up weights laid out as ``models/mixtral.py``
holds them.  ``adam_state_from_numpy`` carries optax's Adam state across
into the port's optimizer (``train/step.py``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..ops.quant import Q4Tensor, QTensor

# NamedTuple field names -> the port's container for them
_QUANT_LEAVES = {("q", "s"): QTensor, ("packed", "s"): Q4Tensor}
# Mixtral's expert gate and up weights (models/mixtral.py lays them out as
# one [hidden, E * inter] matrix a layer)
_EXPERT_IN = ("we_gate", "we_up")


def _keeps_float32(key: str) -> bool:
    """Leaves the JAX pytrees hold in float32 whatever the model dtype: the
    norm weights (``input_norm``, ``final_norm``, CLIP's ``pre_norm_w`` /
    ``_b``, the Qwen2.5-VL tower's ``norm1`` / ``norm2``, ...), CLIP's
    LayerNorm weights and biases (``ln1_w``, ``ln1_b``, ``ln2_w``,
    ``ln2_b``) and the Qwen2.5-VL merger's RMSNorm weight (``ln_q``)."""
    return "norm" in key or key == "ln_q" or key.startswith(("ln1_", "ln2_"))


def _tensor(key: str, leaf) -> torch.Tensor:
    """One array leaf as a tensor (a copy); bfloat16 arrays keep their dtype."""
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"from_numpy: leaf {key!r} ({type(leaf).__name__}, dtype "
                        f"{arr.dtype}) is not a numeric array")
    return torch.from_numpy(np.array(arr))


def from_numpy(tree: Mapping, device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of arrays -> nested dict of tensors on ``device``.

    ``dtype`` casts floating leaves, except those the JAX pytrees keep in
    float32: the norm weights (keys containing ``norm``), the CLIP
    tower's LayerNorm weights and biases (``ln1_*``, ``ln2_*``) and the Qwen
    merger's ``ln_q``; None keeps
    each array's own dtype.  Quantized leaves keep their stored dtypes (int8 or
    uint8 values, float32 scales).  A leaf that is neither raises TypeError."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = from_numpy(leaf, device, dtype)
            continue
        if isinstance(leaf, tuple) and hasattr(leaf, "_fields"):
            cls = _QUANT_LEAVES.get(tuple(leaf._fields))
            if cls is None:
                raise TypeError(f"from_numpy: leaf {key!r} is a {type(leaf).__name__} "
                                f"with fields {leaf._fields}; only quantized weights "
                                f"{sorted(_QUANT_LEAVES)} are carried")
            out[key] = cls(*(_tensor(f"{key}.{f}", getattr(leaf, f)).to(device)
                             for f in leaf._fields))
            continue
        t = _tensor(key, leaf)
        if dtype is not None and t.is_floating_point():
            t = t.to(torch.float32 if _keeps_float32(key) else dtype)
        if key in _EXPERT_IN and t.dim() == 4:
            # Mixtral's [L, E, hidden, inter] -> the port's [L, hidden, E * inter]
            t = t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], -1)
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


def adam_state_from_numpy(count, mu: Mapping, nu: Mapping, device="cuda"):
    """Adam's state handed over as numpy (optax's ``ScaleByAdamState``:
    the step ``count`` and the moment trees ``mu``, ``nu``, each leaf as an
    array) -> the port's ``train.step.AdamState``, so that both optimizers
    can start from one state."""
    from ..train.step import AdamState

    return AdamState(int(np.asarray(count)), from_numpy(mu, device), from_numpy(nu, device))
