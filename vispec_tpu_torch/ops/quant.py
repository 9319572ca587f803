"""Weight-only quantization (int8 per output channel, int4 per group) and the
matrix products over quantized weights, with the int4 CUDA kernel's wrapper
and its plain PyTorch version.

The port's copy of the JAX package's ``ops/quant.py``: the same containers,
quantizers (bit-identical: the same op order, and ``torch.round`` rounds half
to even as ``jnp.round`` does), representation choices and dispatch rule.

``qdot`` is the single matrix-product entry of the models: it returns the
product in float32 (or ``out_dtype``) without rounding to the activation
dtype in between, as ``jnp.dot(..., preferred_element_type=jnp.float32)``
does.  Plain and int8 weights go to a library GEMM (the JAX package leaves
them to XLA); int4 weights at decode shapes go to the hand-written kernel
``csrc/q4_matmul.cu``, which replaces the Pallas kernel
``vispec_tpu/ops/quant.py::_q4_kernel``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Union

import torch

from . import cuda_build


@dataclass(frozen=True)
class QTensor:
    """int8 weight + per-output-channel float32 scale: ``w ~= q * s[..., None, :]``.

    Indexing slices every field along the leading (layer) dim, so a
    layer-stacked ``[L, in, out]`` QTensor yields each layer's 2-D QTensor,
    as ``lax.scan`` slices the JAX NamedTuple's fields."""

    q: torch.Tensor  # int8 [..., in, out]
    s: torch.Tensor  # float32 [..., out]

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, i) -> "QTensor":
        return QTensor(self.q[i], self.s[i])


@dataclass(frozen=True)
class Q4Tensor:
    """Packed int4 weight (two rows per byte) + per-group float32 scales.

    ``packed[r, n]`` holds original row ``r`` in its low nibble and row
    ``r + K//2`` in its high nibble.  Group ``g`` covers original rows
    ``[g*group_size, (g+1)*group_size)``, ``group_size = K // s.shape[-2]``."""

    packed: torch.Tensor  # uint8 [..., K//2, N]
    s: torch.Tensor  # float32 [..., G, N]

    @property
    def shape(self) -> torch.Size:
        p = self.packed.shape
        return torch.Size((*p[:-2], 2 * p[-2], p[-1]))

    def __getitem__(self, i) -> "Q4Tensor":
        return Q4Tensor(self.packed[i], self.s[i])


MaybeQuant = Union[torch.Tensor, QTensor, Q4Tensor]


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


def quantize_q8(w: torch.Tensor, chunk_cols: int = 8192) -> QTensor:
    """Per-output-channel symmetric int8 of a 2-D or layer-stacked
    ``[L, in, out]`` weight.  Column-chunked so the float32 transient stays
    small next to a full-size model in device memory."""

    def _scale(block):
        s = torch.amax(torch.abs(block).float(), dim=-2) / 127.0
        return torch.where(s == 0, torch.ones_like(s), s)

    def _q(block, sblock):
        return torch.clamp(torch.round(block.float() / sblock[..., None, :]),
                           -127, 127).to(torch.int8)

    if w.shape[-1] > chunk_cols:
        s_parts, q_parts = [], []
        for i in range(0, w.shape[-1], chunk_cols):
            block = w[..., i:i + chunk_cols]
            sb = _scale(block)
            q_parts.append(_q(block, sb))
            s_parts.append(sb)
        return QTensor(q=torch.cat(q_parts, dim=-1), s=torch.cat(s_parts, dim=-1))
    s = _scale(w)
    return QTensor(q=_q(w, s), s=s)


def quantize_q4(w: torch.Tensor, group_size: int = 128,
                chunk_cols: int = 8192) -> Q4Tensor:
    """Per-group symmetric int4 of a 2-D weight: ``w[k, n] ~= q[k, n] *
    s[k // group_size, n]`` with q in [-8, 7], packed two rows per byte (see
    Q4Tensor).  ``group_size`` halves until it divides ``K // 2``.
    Column-chunked like quantize_q8."""
    k, n = w.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {k}")
    group_size = min(group_size, k // 2)
    while (k // 2) % group_size:
        group_size //= 2
    g = k // group_size

    def _block(wb):
        nb = wb.shape[1]
        wf = wb.float().reshape(g, group_size, nb)
        s = torch.amax(torch.abs(wf), dim=1) / 7.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(wf / s[:, None, :]), -8, 7).to(torch.int32)
        q = q.reshape(k, nb)
        lo = (q[: k // 2] & 0xF).to(torch.uint8)
        hi = (q[k // 2:] & 0xF).to(torch.uint8)
        return lo | (hi << 4), s

    if n > chunk_cols:
        p_parts, s_parts = [], []
        for i in range(0, n, chunk_cols):
            pb, sb = _block(w[:, i:i + chunk_cols])
            p_parts.append(pb)
            s_parts.append(sb)
        return Q4Tensor(packed=torch.cat(p_parts, dim=1), s=torch.cat(s_parts, dim=1))
    packed, s = _block(w)
    return Q4Tensor(packed=packed, s=s)


def _q4_unpack_halves(packed: torch.Tensor):
    """(lo, hi) int32 values in [-8, 7] for the two stacked half-matrices."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    return lo, hi


def _q4_dequant(w: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    lo, hi = _q4_unpack_halves(w.packed)
    k = w.packed.shape[0] * 2
    g = w.s.shape[0]
    n = w.packed.shape[1]
    vals = torch.cat([lo, hi], dim=0).float()
    vals = vals.reshape(g, k // g, n) * w.s[:, None, :]
    return vals.reshape(k, n).to(dtype)


def dequantize(w: MaybeQuant, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(w, QTensor):
        return (w.q.float() * w.s[..., None, :]).to(dtype)
    if isinstance(w, Q4Tensor):
        return _q4_dequant(w, dtype)
    return w


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w 2-D) accumulated and returned in float32, never rounded
    to the inputs' dtype in between.  bf16 on the card: one cuBLAS GEMM with
    a float32 output (``aten::mm.dtype``); otherwise a float32 product."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def qdot(x: torch.Tensor, w: MaybeQuant, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` for a plain, int8 or int4 rhs, returned in ``out_dtype``.
    int8 values up to +-127 are exact in bf16, so the int8 product is a bf16
    GEMM over the converted weight, scaled per output channel."""
    if isinstance(w, QTensor):
        y = _matmul_f32(x, w.q.to(torch.bfloat16)) * w.s
    elif isinstance(w, Q4Tensor):
        return qdot4(x, w, out_dtype)
    else:
        y = _matmul_f32(x, w)
    return y.to(out_dtype)


def qdot4_ref(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """Plain version of the int4 kernel: bf16 ``x [M, K]`` times the weight
    dequantized to bf16, float32 out (the JAX package's fallback)."""
    return _matmul_f32(x.to(torch.bfloat16), _q4_dequant(w))


def _q4_supports_kernel(m: int, w: Q4Tensor) -> bool:
    """The JAX package's dispatch rule (``_q4_supports_pallas``), decided by
    shape alone: small-M decode shapes go to the kernel; larger M (prefill)
    is compute-bound and goes through a one-shot dequant + GEMM."""
    kh, n = w.packed.shape
    group_size = (2 * kh) // w.s.shape[0]
    return (m <= 64 and n % 128 == 0 and kh % group_size == 0
            and group_size % 8 == 0)


def qdot4(x: torch.Tensor, w: Q4Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` for an int4-packed rhs; ``x`` is cast to bf16 as in JAX."""
    squeeze = x.dim() == 1
    x2 = x[None] if squeeze else x.reshape(-1, x.shape[-1])
    x2 = x2.to(torch.bfloat16)
    if _q4_supports_kernel(x2.shape[0], w):
        y = q4_matmul(x2, w)
    else:
        y = qdot4_ref(x2, w)
    y = y.to(out_dtype)
    if squeeze:
        return y[0]
    return y.reshape(*x.shape[:-1], y.shape[-1])


_q4_lib = None


def _q4_library() -> ctypes.CDLL:
    global _q4_lib
    if _q4_lib is None:
        lib = cuda_build.load("q4_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vispec_q4_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.vispec_q4_matmul.restype = i
        lib.vispec_q4_matmul_tile_n.argtypes = []
        lib.vispec_q4_matmul_tile_n.restype = i
        _q4_lib = lib
    return _q4_lib


def _q4_split(n_tiles: int, groups_per_half: int, sms: int):
    """K split of the kernel's grid: enough (column tile, group range)
    blocks for two per SM, each a whole number of quantization groups.
    Returns (splits, groups per split)."""
    want = min(groups_per_half, max(1, -(-2 * sms // n_tiles)))
    per = -(-groups_per_half // want)
    return -(-groups_per_half // per), per


def q4_matmul(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """bf16 ``x [M <= 64, K]`` times the int4 weight, float32 ``[M, N]``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``q4_matmul.launches``) or raises."""
    if x.device.type == "cpu":
        return qdot4_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    packed, s = w.packed, w.s
    for name, t in (("packed", packed), ("scales", s)):
        if t.device != x.device:
            raise ValueError(f"q4_matmul: {name} on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.uint8 or s.dtype != torch.float32:
        raise ValueError(f"q4_matmul: dtypes x {x.dtype}, packed {packed.dtype}, "
                         f"scales {s.dtype}; need bfloat16, uint8, float32")
    if x.dim() != 2 or packed.dim() != 2 or s.dim() != 2:
        raise ValueError("q4_matmul: x, packed and scales must be 2-D")
    m, k = x.shape
    kh, n = packed.shape
    g = s.shape[0]
    if k != 2 * kh or s.shape[1] != n or g % 2 or (2 * kh) % g:
        raise ValueError(f"q4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)} "
                         f"and scales {tuple(s.shape)} do not fit")
    group_size = (2 * kh) // g
    if not 1 <= m <= 64:
        raise ValueError(f"q4_matmul: M = {m} outside 1..64")
    if group_size % 8 or kh % group_size:
        raise ValueError(f"q4_matmul: group size {group_size} is not a multiple of 8 "
                         f"dividing K/2 = {kh}")
    if n % 16:
        raise ValueError(f"q4_matmul: N = {n} is not a multiple of 16")
    x, packed, s = x.contiguous(), packed.contiguous(), s.contiguous()
    if packed.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("q4_matmul: packed and scales must be 16-byte aligned")

    lib = _q4_library()
    n_tiles = -(-n // lib.vispec_q4_matmul_tile_n())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per = _q4_split(n_tiles, kh // group_size, sms)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    part = out if splits == 1 else torch.empty((splits, m, n), dtype=torch.float32,
                                               device=x.device)
    err = lib.vispec_q4_matmul(
        x.data_ptr(), packed.data_ptr(), s.data_ptr(), part.data_ptr(), out.data_ptr(),
        m, kh, n, group_size, splits, per,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q4_matmul: kernel launch failed (error {err})")
    q4_matmul.launches += 1
    return out


q4_matmul.launches = 0


# ---------------------------------------------------------------------------
# Representation choice and whole-model quantization
# ---------------------------------------------------------------------------

_LAYER_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# shape-keyed decisions of the last auto-quantization (observability/tests)
last_auto_choices: Dict[str, str] = {}
_AUTO_CACHE: dict = {}


def _heuristic_repr(k: int, n: int) -> str:
    """Static per-matrix representation choice, the JAX package's rule for
    the deterministic ``mixed`` mode and the CPU ``auto`` mode: int4 for deep
    matrices (K >= 2N), int8 for vocabulary-like ones (N >= 4K), bf16 for
    the wide MLP up-projection (N >= 2K), int8 otherwise."""
    if k >= 2 * n:
        return "int4"
    if n >= 4 * k:
        return "int8"
    if n >= 2 * k:
        return "bf16"
    return "int8"


def _measure_repr(w: torch.Tensor, m: int = 8, reps: int = 16, trials: int = 3) -> str:
    """Time bf16/int8/int4 products of this matrix on the card (CUDA events
    around ``reps`` back-to-back calls, candidates in interleaved trials,
    each scored by its fastest trial) and return the fastest mode."""
    k, _ = w.shape
    cands = {"bf16": w.to(torch.bfloat16), "int8": quantize_q8(w)}
    q4 = quantize_q4(w)
    if _q4_supports_kernel(m, q4):
        cands["int4"] = q4
    g = torch.Generator(device=w.device).manual_seed(0)
    x = torch.randn((m, k), generator=g, device=w.device, dtype=torch.bfloat16)
    for wr in cands.values():
        qdot(x, wr)  # warm-up: builds the kernel, cuBLAS handles
    best: Dict[str, float] = {}
    for _ in range(trials):
        for name, wr in cands.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                qdot(x, wr)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end)
            best[name] = min(best.get(name, t), t)
    return min(best, key=best.get)


def _auto_repr(w: torch.Tensor) -> str:
    """Per-matrix representation for mode="auto": measured on the card, the
    static heuristic on the CPU."""
    shape = tuple(w.shape)
    if shape not in _AUTO_CACHE:
        _AUTO_CACHE[shape] = (_measure_repr(w) if w.is_cuda
                              else _heuristic_repr(*shape))
    return _AUTO_CACHE[shape]


_QUANTIZERS = {
    "bf16": lambda w: w.to(torch.bfloat16),
    "int8": quantize_q8,
    "int4": quantize_q4,
}


def quantize_draft_params(dparams: dict, lm_head: MaybeQuant, mode: str = "int8") -> dict:
    """Quantized copies of the draft layer weights + a ranking copy of the
    target head (``rank_head``).  Returns a new dict.

    Modes: ``int8`` everywhere, ``int4`` everywhere, ``int4_head`` (int4
    ranking head, int8 layer), ``mixed`` (the static per-matrix
    ``_heuristic_repr``), ``auto`` (per-matrix fastest of bf16/int8/int4,
    timed on the card; the heuristic on the CPU).  A target head that is
    already quantized is used as the ranking head as it is."""
    if mode not in ("int8", "int4", "int4_head", "auto", "mixed"):
        raise ValueError(f"unknown quantize mode {mode!r}")
    last_auto_choices.clear()
    dparams = dict(dparams)
    layer = dict(dparams["layer"])
    for k in _LAYER_QUANT_KEYS:
        if k not in layer:
            continue
        if mode == "auto":
            choice = _auto_repr(layer[k])
        elif mode == "mixed":
            choice = _heuristic_repr(*layer[k].shape)
        else:
            choice = "int4" if mode == "int4" else "int8"
        last_auto_choices[k] = choice
        layer[k] = _QUANTIZERS[choice](layer[k])
    dparams["layer"] = layer
    if isinstance(lm_head, (QTensor, Q4Tensor)):
        # the target was quantized first: rank with its own quantized head
        last_auto_choices["rank_head"] = (
            "int8" if isinstance(lm_head, QTensor) else "int4")
        dparams["rank_head"] = lm_head
        return dparams
    if mode == "auto":
        head_choice = _auto_repr(lm_head)
    elif mode == "mixed":
        head_choice = _heuristic_repr(*lm_head.shape)
    else:
        head_choice = "int4" if mode in ("int4", "int4_head") else "int8"
    last_auto_choices["rank_head"] = head_choice
    if head_choice == "bf16":
        # no ranking copy: the loop ranks with the target's own head
        dparams.pop("rank_head", None)
    else:
        dparams["rank_head"] = _QUANTIZERS[head_choice](lm_head)
    return dparams


def quantize_target_params(tparams: dict, mode: str = "int8", inplace: bool = False,
                           chunk_cols: int = 1024) -> dict:
    """Weight-only int8 quantization of the target's seven layer-stacked
    matrices and ``lm_head`` (per (layer, output channel) scales); embed,
    norms and biases keep their dtypes.  Returns a new dict unless
    ``inplace``, which replaces the caller's entries so each bf16 source can
    be freed as its int8 copy lands.  Matrices already quantized are kept,
    so a second call is a no-op."""
    if mode != "int8":
        raise ValueError(f"target quantization supports mode='int8' only (got {mode!r})")
    if "router" in tparams.get("layers", {}):
        raise NotImplementedError(
            "int8 target quantization covers the llama-family backbone only")
    if not inplace:
        tparams = dict(tparams)
        tparams["layers"] = dict(tparams["layers"])
    layers = tparams["layers"]
    for k in _LAYER_QUANT_KEYS:
        if not isinstance(layers[k], QTensor):
            layers[k] = quantize_q8(layers[k], chunk_cols=chunk_cols)
    if not isinstance(tparams["lm_head"], QTensor):
        tparams["lm_head"] = quantize_q8(tparams["lm_head"], chunk_cols=chunk_cols)
    return tparams
