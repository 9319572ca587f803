"""Preallocated KV cache for speculative decoding.

Same layout as the JAX package: one pair of buffers per model, stacked over
layers, ``k, v: [num_layers, num_kv_heads, max_len, head_dim]``.  The JAX
cache is functional; here the buffers are written in place (PyTorch has no
buffer donation, and copying a multi-GB cache per round is what the JAX
version works hard to avoid).  Only the small length scalars are replaced
functionally, so a caller that keeps an old ``KVCache`` keeps its lengths.

``length`` and ``real_length`` are separate int32 scalars on the cache's
device: the draft's image compression stores fewer rows (``length``) than the
sequence has positions (``real_length``).  Both stay on the device, and every
write at a device-held offset uses ``index_copy_`` with indices computed on
the device, so the decode loop never reads a length back to the host.

``init_cache(quantized=True)`` holds int8 K/V with per-row float32 scales
(the int8-KV serving mode): rows are quantized as they are written, and the
attention kernel reads the int8 tiles directly.

The batched and serving paths stack one cache per slot, the JAX serving
layout: ``k, v: [B, num_layers, num_kv_heads, max_len, head_dim]``, scales
``[B, num_layers, num_kv_heads, max_len]``, lengths ``[B]``.  The same
functions serve both layouts: a ``[B]`` start (or ``[B, n]`` index) means one
entry per slot along the leading dim, a scalar start means one request.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass
class KVCache:
    """Stacked per-layer KV buffers plus committed lengths.

    k, v: [num_layers, num_kv_heads, max_len, head_dim]
    length: int32 scalar tensor — committed (attendable) rows.
    real_length: int32 scalar tensor — logical sequence position count.
    k_scale, v_scale: [num_layers, num_kv_heads, max_len] float32 per-row
        dequantization scales, present iff k/v are int8.
    """

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    real_length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[-2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[-4]

    def _replace(self, **kw) -> "KVCache":
        return replace(self, **kw)


def init_cache(
    num_layers: int,
    num_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cuda",
    quantized: bool = False,
    slots: Optional[int] = None,
) -> KVCache:
    """``quantized=True`` allocates int8 k/v plus per-row float32 scales
    (half the bytes of a bf16 cache); ``dtype`` is then unused.  ``slots``
    allocates the slot-stacked layout (a leading ``[slots]`` dim on every
    buffer and length)."""
    lead = () if slots is None else (slots,)
    shape = (*lead, num_layers, num_kv_heads, max_len, head_dim)
    zero = torch.zeros(lead, dtype=torch.int32, device=device)
    if quantized:
        sshape = (*lead, num_layers, num_kv_heads, max_len)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            length=zero,
            real_length=zero.clone(),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=device),
        )
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"KV cache dtype must be bfloat16 or float32, got {dtype}")
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=zero,
        real_length=zero.clone(),
    )


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8: ``x [..., D] -> (int8 [..., D], scale [...])``,
    bit-identical to the JAX package's.  The scale of a row factors out of
    both attention products: scores scale per key column, P.V per row of p."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def reset(cache: KVCache) -> KVCache:
    """Logical reset: zero the lengths, keep the buffers."""
    zero = torch.zeros_like(cache.length)
    return cache._replace(length=zero, real_length=zero.clone())


def advance(cache: KVCache, valid_rows, real_rows=None) -> KVCache:
    """Advance lengths after a block append; only ``valid_rows`` of it count."""
    if real_rows is None:
        real_rows = valid_rows
    return cache._replace(
        length=(cache.length + valid_rows).to(torch.int32),
        real_length=(cache.real_length + real_rows).to(torch.int32),
    )


def write_rows(buf: torch.Tensor, dim: int, start, rows: torch.Tensor) -> None:
    """In-place ``buf[..., start:start+n, ...] = rows`` along ``dim`` at a
    device-held ``start``.  Like ``lax.dynamic_update_slice`` the start is
    clamped so the block fits (an out-of-range CUDA index would be a device
    assert, not an exception).

    A ``[B]`` start writes each slot of the leading dim at its own start,
    clamped per slot as ``dynamic_update_slice`` clamps under ``vmap``, in
    one ``index_put_``; ``rows`` then carries the slot dim too."""
    n = rows.shape[dim]
    start = torch.as_tensor(start, device=buf.device)
    start = start.clamp(0, buf.shape[dim] - n)
    idx = start.to(torch.int64)[..., None] + torch.arange(n, device=buf.device)
    if start.dim() == 0:
        buf.index_copy_(dim, idx, rows.to(buf.dtype))
        return
    slots = torch.arange(buf.shape[0], device=buf.device)[:, None]
    # slot and row dims first: buf[b, idx[b, j]] = rows[b, j]
    buf.movedim(dim, 1).index_put_((slots, idx), rows.to(buf.dtype).movedim(dim, 1))


def take_rows(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, idx)`` for a 1-D ``idx``; for an ``[B, n]`` idx,
    slot b's rows ``idx[b]`` of ``x[b]`` (``dim`` counts in x's frame, whose
    leading dim is the slot)."""
    idx = idx.to(torch.int64)
    if idx.dim() == 1:
        return x.index_select(dim, idx)
    dim = dim % x.dim()
    view = [1] * x.dim()
    view[0], view[dim] = idx.shape
    full = list(x.shape)
    full[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.reshape(view).expand(full))


def commit_from_blocks(
    cache: KVCache,
    tree_start: torch.Tensor,
    k_blocks: torch.Tensor,  # [B?, L, H_kv, T, D] — the verify pass's appended rows
    v_blocks: torch.Tensor,
    node_indices: torch.Tensor,  # [B?, max_path] accepted node offsets in the tree
    num_accepted: torch.Tensor,
) -> KVCache:
    """Accept-compaction: gather the accepted rows from the small tree blocks
    and write them back at the committed frontier ``tree_start``.  An int8
    cache re-quantizes the accepted (pre-quantization) rows, which gives the
    same bytes as an append of the same rows, so spec and AR caches agree on
    every committed row.  With a slot dim every slot commits its own path at
    its own frontier."""
    k_sel = take_rows(k_blocks, -2, node_indices)
    v_sel = take_rows(v_blocks, -2, node_indices)
    if cache.k_scale is not None:
        k_sel, ks_sel = quantize_rows(k_sel)
        v_sel, vs_sel = quantize_rows(v_sel)
        write_rows(cache.k_scale, -1, tree_start, ks_sel)
        write_rows(cache.v_scale, -1, tree_start, vs_sel)
    write_rows(cache.k, -2, tree_start, k_sel)
    write_rows(cache.v, -2, tree_start, v_sel)
    new_len = (tree_start + num_accepted).to(torch.int32)
    delta = new_len - cache.length
    return cache._replace(length=new_len,
                          real_length=(cache.real_length + delta).to(torch.int32))
