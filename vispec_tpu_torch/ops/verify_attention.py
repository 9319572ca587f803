"""Length-aware tree-verify / decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/verify_attention.cu``) replaces the JAX package's Pallas
kernel ``ops/pallas_attention.py::_kernel`` for a single request, over a
bf16/f32 cache or an int8 cache with per-row float32 scales.  It is compiled
with ``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``) and bound
with ``ctypes``.

``verify_attention`` launches the kernel for CUDA tensors and runs
``verify_attention_ref`` for CPU tensors; there is no other switch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .attention import attend, tree_verify_mask
from .kv_cache import dequantize_rows

HEAD_DIMS = (16, 128)  # the instantiations in the source

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load("verify_attention")
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.vispec_verify_attention.argtypes = [
            p, p, p, p, p, p, p, p, p, p, p, p,  # q k v ks vs mask start layer m l acc out
            i, i, i, i, i, ll, ll, i, i, i, p]
        lib.vispec_verify_attention.restype = i
        lib.vispec_verify_attention_tile.argtypes = []
        lib.vispec_verify_attention_tile.restype = i
        _lib = lib
    return _lib


def _device_index(x, device, name: str) -> torch.Tensor:
    """An int32 scalar on ``device``; a tensor there passes through without a
    copy to the host."""
    t = torch.as_tensor(x, device=device)
    if t.numel() != 1:
        raise ValueError(f"{name} must be a scalar, got shape {tuple(t.shape)}")
    return t.reshape(()).to(torch.int32).contiguous()


def verify_attention_ref(
    q: torch.Tensor,  # [H, S, D]
    k_cache: torch.Tensor,  # [Hkv, max_len, D] or [L, Hkv, max_len, D]
    v_cache: torch.Tensor,
    tree_start,  # int32 scalar — committed prefix length
    tree_mask: torch.Tensor,  # [S, T_reg] bool — region visibility
    layer_idx=None,  # scalar layer index when the cache has a layer dim
    k_scale: Optional[torch.Tensor] = None,  # [L?, Hkv, max_len] f32 iff int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel: the same visibility over the full cache
    (f32 scores and softmax, p cast to the value dtype before P.V).  An int8
    cache is dequantized to float32 first, so p stays float32."""
    if k_cache.dim() == 4:
        layer = _device_index(layer_idx, k_cache.device, "layer_idx").to(torch.int64)
        k_cache = k_cache.index_select(0, layer.view(1))[0]
        v_cache = v_cache.index_select(0, layer.view(1))[0]
        if k_scale is not None:
            k_scale = k_scale.index_select(0, layer.view(1))[0]
            v_scale = v_scale.index_select(0, layer.view(1))[0]
    if k_scale is not None:
        k_cache = dequantize_rows(k_cache, k_scale)
        v_cache = dequantize_rows(v_cache, v_scale)
    mask = tree_verify_mask(tree_mask.to(torch.bool), tree_start, k_cache.shape[1])
    return attend(q, k_cache, v_cache, mask)


def verify_attention(
    q: torch.Tensor,  # [H, S, D]
    k_cache: torch.Tensor,  # [Hkv, max_len, D] or [L, Hkv, max_len, D]
    v_cache: torch.Tensor,
    tree_start,  # int32 scalar on q's device — committed prefix length
    tree_mask: torch.Tensor,  # [S, T_reg] bool — region visibility
    layer_idx=None,  # int32 scalar on q's device; required for a 4-D cache
    k_scale: Optional[torch.Tensor] = None,  # [L?, Hkv, max_len] f32 iff int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Length-aware attention over the cache; returns [H, S, D] in q's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  Launches over a bf16/f32 cache count in
    ``verify_attention.launches``, over an int8 cache in
    ``verify_attention.launches_int8``."""
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_cache, v_cache, tree_start, tree_mask,
                                    layer_idx, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention: unsupported device {q.device}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("verify_attention: give both k_scale and v_scale, or neither")
    operands = [("k_cache", k_cache), ("v_cache", v_cache), ("tree_mask", tree_mask)]
    if quantized:
        operands += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in operands:
        if t.device != q.device:
            raise ValueError(f"verify_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"verify_attention: dtype {q.dtype} not supported")
    cache_dtype = torch.int8 if quantized else q.dtype
    if k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise ValueError(f"verify_attention: cache dtypes {k_cache.dtype} / "
                         f"{v_cache.dtype}, expected {cache_dtype}")
    if k_cache.shape != v_cache.shape or k_cache.dim() not in (3, 4):
        raise ValueError(f"verify_attention: bad cache shapes "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != k_cache.shape[:-1]:
                raise ValueError(f"verify_attention: {name} must be float32 "
                                 f"{tuple(k_cache.shape[:-1])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"verify_attention: {name} must be contiguous")
    h, s, d = q.shape
    hkv, max_len, dk = k_cache.shape[-3:]
    if dk != d or h % hkv != 0:
        raise ValueError(f"verify_attention: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"verify_attention: head_dim {d} not in {HEAD_DIMS}")
    if tree_mask.dtype != torch.bool or tree_mask.dim() != 2 or tree_mask.shape[0] != s:
        raise ValueError(f"verify_attention: mask must be bool [S={s}, T_reg], "
                         f"got {tree_mask.dtype} {tuple(tree_mask.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and tree_mask.is_contiguous()):
        raise ValueError("verify_attention: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("verify_attention: q and the caches must be 16-byte aligned")
    start = _device_index(tree_start, q.device, "tree_start")
    if k_cache.dim() == 4:
        if layer_idx is None:
            raise ValueError("verify_attention: layer_idx required for a 4-D cache")
        layer = _device_index(layer_idx, q.device, "layer_idx")
        layer_ptr = layer.data_ptr()
        layer_stride = k_cache.stride(0)
        scale_stride = k_scale.stride(0) if quantized else 0
    else:
        layer, layer_ptr, layer_stride, scale_stride = None, None, 0, 0

    lib = _library()
    gs = (h // hkv) * s
    nc = -(-max_len // lib.vispec_verify_attention_tile())
    part_m = torch.empty((hkv, nc, gs), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((hkv, nc, gs, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = lib.vispec_verify_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tree_mask.data_ptr(), start.data_ptr(), layer_ptr,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), hkv, gs, s, tree_mask.shape[1], max_len, layer_stride,
        scale_stride, d, int(q.dtype == torch.bfloat16), int(quantized),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verify_attention: kernel launch failed "
                           f"(CUDA error {err})")
    if quantized:
        verify_attention.launches_int8 += 1
    else:
        verify_attention.launches += 1
    return out


verify_attention.launches = 0
verify_attention.launches_int8 = 0
