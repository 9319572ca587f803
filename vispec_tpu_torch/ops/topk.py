"""Exact top-k along the last axis with the JAX package's tie order.

``lax.top_k`` and the JAX package's iterated-argmax ``top_k`` let the lowest
index win among equal values; tree identity depends on it.  ``torch.topk``
promises no order for ties, so this takes a stable descending sort instead.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest entries along the last axis;
    ties broken by lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)
