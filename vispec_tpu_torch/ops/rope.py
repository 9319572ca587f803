"""Rotary position embeddings, computed on the fly from position ids (no
cos/sin table), with linear and dynamic-NTK scaling."""

from __future__ import annotations

from typing import Tuple

import torch


def inv_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim//2] float32 inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def cos_sin(
    position_ids: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    linear_scale: float = 1.0,
    dynamic_ntk: "Tuple[float, int] | None" = None,
    seq_len=None,  # real (unpadded) kv sequence length for the NTK stretch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin of shape [..., head_dim] for the given integer positions
    (frequencies duplicated along the last axis so rotate_half applies).

    ``dynamic_ntk=(factor, max_position_embeddings)`` stretches theta by
    ``((factor*s/max) - (factor-1)) ** (dim/(dim-2))`` once the sequence
    length ``s`` exceeds ``max``; the stretch is clamped at 1, which is the
    HF gate without a data-dependent branch.  ``seq_len`` is the real kv
    length (a tensor or int); None falls back to ``max(position_ids)+1``."""
    device = position_ids.device
    if dynamic_ntk is not None:
        factor, max_pos = dynamic_ntk
        if seq_len is None:
            seq_len = position_ids.max() + 1
        s = torch.as_tensor(seq_len, device=device).to(torch.float32)
        stretch = torch.clamp(factor * s / float(max_pos) - (factor - 1.0), min=1.0)
        theta_eff = theta * stretch ** (head_dim / (head_dim - 2))
        exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
        inv = 1.0 / (theta_eff ** exponent)
    else:
        inv = inv_frequencies(head_dim, theta, device)
    pos = position_ids.to(torch.float32) / linear_scale
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q[..., S, D] and k[..., S, D] with cos/sin broadcastable to [S, D]."""
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
