"""Length-aware tree-verify / decode attention: the CUDA kernel's wrapper, its
build, and its plain PyTorch version.

The kernel (``csrc/verify_attention.cu``) replaces the JAX package's Pallas
kernel ``ops/pallas_attention.py::_kernel`` for bf16/f32 caches and a single
request.  It is compiled with ``nvcc`` for ``sm_90a`` at first use, from the
source in this package, into ``build/kernels/`` beside the package, and bound
with ``ctypes``.

``verify_attention`` launches the kernel for CUDA tensors and runs
``verify_attention_ref`` for CPU tensors; there is no other switch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from .attention import attend, tree_verify_mask

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "verify_attention.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (16, 128)  # the instantiations in the source

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> Path:
    """Compile the kernel library unless a build of this exact source and
    these flags exists; returns the ``.so`` path.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it in a
    ``.log`` file."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    so = BUILD_DIR / f"libverify_attention_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.vispec_verify_attention.argtypes = [
            p, p, p, p, p, p, p, p, p, p,  # q k v mask start layer m l acc out
            i, i, i, i, i, ctypes.c_longlong, i, i, p]
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
) -> torch.Tensor:
    """Plain version of the kernel: the same visibility over the full cache
    (f32 scores and softmax, p cast to the value dtype before P.V)."""
    if k_cache.dim() == 4:
        layer = _device_index(layer_idx, k_cache.device, "layer_idx").to(torch.int64)
        k_cache = k_cache.index_select(0, layer.view(1))[0]
        v_cache = v_cache.index_select(0, layer.view(1))[0]
    mask = tree_verify_mask(tree_mask.to(torch.bool), tree_start, k_cache.shape[1])
    return attend(q, k_cache, v_cache, mask)


def verify_attention(
    q: torch.Tensor,  # [H, S, D]
    k_cache: torch.Tensor,  # [Hkv, max_len, D] or [L, Hkv, max_len, D]
    v_cache: torch.Tensor,
    tree_start,  # int32 scalar on q's device — committed prefix length
    tree_mask: torch.Tensor,  # [S, T_reg] bool — region visibility
    layer_idx=None,  # int32 scalar on q's device; required for a 4-D cache
) -> torch.Tensor:
    """Length-aware attention over the cache; returns [H, S, D] in q's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``verify_attention.launches``) or raises."""
    if q.device.type == "cpu":
        return verify_attention_ref(q, k_cache, v_cache, tree_start, tree_mask,
                                    layer_idx)
    if q.device.type != "cuda":
        raise ValueError(f"verify_attention: unsupported device {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("tree_mask", tree_mask)):
        if t.device != q.device:
            raise ValueError(f"verify_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"verify_attention: dtype {q.dtype} not supported")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("verify_attention: q, k_cache and v_cache dtypes differ")
    if k_cache.shape != v_cache.shape or k_cache.dim() not in (3, 4):
        raise ValueError(f"verify_attention: bad cache shapes "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
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
    else:
        layer, layer_ptr, layer_stride = None, None, 0

    lib = _library()
    gs = (h // hkv) * s
    nc = -(-max_len // lib.vispec_verify_attention_tile())
    part_m = torch.empty((hkv, nc, gs), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((hkv, nc, gs, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = lib.vispec_verify_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        tree_mask.data_ptr(), start.data_ptr(), layer_ptr,
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), hkv, gs, s, tree_mask.shape[1], max_len, layer_stride,
        d, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verify_attention: kernel launch failed "
                           f"(CUDA error {err})")
    verify_attention.launches += 1
    return out


verify_attention.launches = 0
