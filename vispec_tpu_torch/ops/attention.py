"""Attention over the preallocated KV cache: the plain masked path and the
mask builders.

``attend`` is plain PyTorch over a full boolean mask; prefill and the image
adaptor use it, as the JAX package leaves them to XLA.  ``attend_region``
describes decode/verify visibility as a committed prefix plus a masked region
and hands it to ``ops.verify_attention``, whose wrapper launches the CUDA
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e9


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[H_kv, S, D] -> [H_kv*groups, S, D] (GQA broadcast)."""
    if groups == 1:
        return x
    h, s, d = x.shape
    return x[:, None].expand(h, groups, s, d).reshape(h * groups, s, d)


def attend(
    q: torch.Tensor,  # [num_heads, q_len, head_dim]
    k: torch.Tensor,  # [num_kv_heads, kv_len, head_dim]
    v: torch.Tensor,  # [num_kv_heads, kv_len, head_dim]
    mask: torch.Tensor,  # [q_len, kv_len] bool (True = attend)
) -> torch.Tensor:
    """Masked attention with float32 scores and softmax; returns [H, q_len, D]."""
    groups = q.shape[0] // k.shape[0]
    k = repeat_kv(k, groups)
    v = repeat_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def causal_mask(q_len: int, kv_len: int, q_start, device=None) -> torch.Tensor:
    """[q_len, kv_len] bool: query i (absolute pos q_start+i) sees cols <= its pos."""
    q_pos = torch.arange(q_len, dtype=torch.int32, device=device) + q_start
    k_pos = torch.arange(kv_len, dtype=torch.int32, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def tree_verify_mask(
    tree_mask: torch.Tensor,  # [S, T_reg] bool region visibility
    tree_start,  # scalar: row where the region was appended
    kv_len: int,
) -> torch.Tensor:
    """[S, kv_len] bool: every committed row (< tree_start) plus the region
    columns ``tree_start + t`` where ``tree_mask[s, t]``."""
    s, t = tree_mask.shape
    k_pos = torch.arange(kv_len, dtype=torch.int64, device=tree_mask.device)
    start = torch.as_tensor(tree_start, device=tree_mask.device).to(torch.int64)
    committed = k_pos[None, :] < start
    in_tree = (k_pos[None, :] >= start) & (k_pos[None, :] < start + t)
    rel = torch.clamp(k_pos - start, 0, t - 1)
    tree_ok = tree_mask[:, rel]
    return committed | (in_tree & tree_ok)


def attend_region(
    q: torch.Tensor,  # [num_heads, S, head_dim]
    k_full: torch.Tensor,  # [num_kv_heads, max_len, head_dim] (new rows written)
    v_full: torch.Tensor,
    attn_mask: Optional[torch.Tensor],  # [S, max_len] — used when region is None
    region: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (start, mask[S, T_reg])
) -> torch.Tensor:
    """Decode/verify attention.  With a ``region`` it goes through
    ``verify_attention`` (the CUDA kernel on a CUDA tensor); without one
    (prefill) through the plain masked ``attend``."""
    if region is None:
        return attend(q, k_full, v_full, attn_mask)
    from .verify_attention import verify_attention

    start, small_mask = region
    return verify_attention(q, k_full, v_full, start, small_mask)
