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
    length (a tensor or int); None falls back to ``max(position_ids)+1``.

    Batched: positions ``[B, S]`` with a per-slot ``seq_len [B]``; under
    dynamic NTK every slot then has its own theta (``inv`` is ``[B, 1,
    D/2]``, as ``jax.vmap`` gives it)."""
    device = position_ids.device
    if dynamic_ntk is not None:
        factor, max_pos = dynamic_ntk
        if seq_len is None:
            seq_len = position_ids.amax(dim=-1) + 1
        s = torch.as_tensor(seq_len, device=device).to(torch.float32)
        stretch = torch.clamp(factor * s / float(max_pos) - (factor - 1.0), min=1.0)
        theta_eff = theta * stretch ** (head_dim / (head_dim - 2))
        exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
        inv = 1.0 / (theta_eff[..., None] ** exponent)
        if s.dim():
            inv = inv.unsqueeze(-2)
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
    """Rotate q[..., S, D] and k[..., S, D] with cos/sin broadcastable to
    them (``[S, D]``, or ``[B, 1, S, D]`` for slot-stacked heads)."""
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def mrope_cos_sin(
    position_ids_3d: torch.Tensor,
    head_dim: int,
    mrope_section: Tuple[int, int, int],
    theta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2.5-VL multimodal rotary: (t, h, w) positions ``[..., 3, S]`` ->
    cos, sin ``[..., S, head_dim]``.

    Frequency slot ``d`` follows the position stream that ``mrope_section``
    (in half-dim units, the pattern repeating over the duplicated half)
    assigns it: ``searchsorted(cumsum((0,) + section), d % (head_dim // 2),
    side="right") - 1``, clipped to [0, 2], as the JAX package selects it.
    A leading dim carries one request per slot (the batched prefill)."""
    cos3, sin3 = cos_sin(position_ids_3d, head_dim, theta)  # [..., 3, S, head_dim]
    device = position_ids_3d.device
    half = head_dim // 2
    sec = torch.cumsum(torch.tensor((0,) + tuple(mrope_section), dtype=torch.int32,
                                    device=device), 0).to(torch.int32)
    slot = (torch.arange(head_dim, dtype=torch.int32, device=device) % half).contiguous()
    stream = torch.clamp(torch.searchsorted(sec, slot, right=True) - 1, 0, 2)
    idx = stream.to(torch.int64).expand(*cos3.shape[:-3], 1, cos3.shape[-2], head_dim)
    return (torch.gather(cos3, -3, idx).squeeze(-3),
            torch.gather(sin3, -3, idx).squeeze(-3))
