"""Length-aware tree-verify / decode attention: the CUDA kernel's wrapper and
its plain PyTorch version.

The kernel (``csrc/verify_attention.cu``) replaces the JAX package's Pallas
kernel ``ops/pallas_attention.py::_kernel``, over a bf16/f32 cache or an int8
cache with per-row float32 scales, for a single request
(``verify_attention``, table rows 1a and 1b) and for a batch of slots, each
with its own cache, region, tree_start and layer (``verify_attention_batched``,
row 1c: the batched grid of the JAX package's ``custom_vmap`` rule).  It is
compiled with ``nvcc`` for ``sm_90a`` at first use (``ops/cuda_build.py``)
and bound with ``ctypes``.  At head_dim 128 every call is one launch of
``partial_kernel_mma`` on tensor cores (bf16 q; float32 q in 3xTF32), over
q's own cache or an int8 cache: a thread-block cluster per (slot x kv head,
query tile) splits the live chunks over 8 virtual ranks and merges them in
rank order in its shared memory, so no partials reach device memory.  The
cluster has C = 8, 4, 2 or 1 blocks, each running 8 / C ranks, W at a time:
a block's W walkers (W = 2: two warps each, with tiles of their own; bf16
q over a bf16 cache with at most 32 query rows a kv head) each take every
W-th of its ranks.
The host picks (C, W) from the call's shapes and the clusters the card
holds at once (``pick_cluster``), and, for bf16 q over int8, the build
(``register_build_holds``): p * v_scale through shared-memory P tiles or
packed in registers inside P.V.  A batch's block columns serve its
slots longest first (the order computed on the device).  The output is the
same bits whatever the shape, the build and the order.  head_dim 16 runs
the CUDA-core ``partial_kernel`` into float32 scratch, then
``combine_kernel``.

Each wrapper launches the kernel for CUDA tensors and runs its plain version
(``verify_attention_ref``, ``verify_attention_batched_ref``) for CPU tensors;
there is no other switch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build
from .attention import attend, tree_verify_mask
from .kv_cache import dequantize_rows

HEAD_DIMS = (16, 128)  # the instantiations in the source
FOLDED_HEAD_DIM = 128  # one launch, no scratch; head_dim 16 runs partial + combine
CLUSTERS = (8, 4, 2, 1)  # the cluster sizes built at head_dim 128, largest first
# (cluster, walkers) shapes built with more than one walker: bf16 q over a
# bf16 cache only
WALKER_SHAPES = ((4, 2),)
VRANKS = 8  # virtual ranks a (slot x kv head, query tile) splits its chunks over
QTILE = 64  # query rows a block's warps hold; a walker holds QTILE / W of them

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
            i, i, i, i, i, i,  # nslots hkv gs s_len t_reg max_len
            ll, ll, ll, ll, ll,  # layer, scale-layer, slot, scale-slot, mask-slot strides
            i, i, i, i, i, i,  # head_dim is_bf16 cache_int8 cluster walkers p_tiles
            p]  # stream
        lib.vispec_verify_attention.restype = i
        lib.vispec_verify_attention_max_clusters.argtypes = [i, i, i, i, i, i]
        lib.vispec_verify_attention_max_clusters.restype = i
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


def _check_operands(name, q, k_cache, v_cache, tree_mask, k_scale, v_scale,
                    cache_dims):
    """Device, dtype, shape and alignment checks the kernel relies on; returns
    whether the cache is int8."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError(f"{name}: give both k_scale and v_scale, or neither")
    operands = [("k_cache", k_cache), ("v_cache", v_cache), ("tree_mask", tree_mask)]
    if quantized:
        operands += [("k_scale", k_scale), ("v_scale", v_scale)]
    for arg, t in operands:
        if t.device != q.device:
            raise ValueError(f"{name}: {arg} on {t.device}, q on {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    cache_dtype = torch.int8 if quantized else q.dtype
    if k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise ValueError(f"{name}: cache dtypes {k_cache.dtype} / "
                         f"{v_cache.dtype}, expected {cache_dtype}")
    if k_cache.shape != v_cache.shape or k_cache.dim() not in cache_dims:
        raise ValueError(f"{name}: bad cache shapes "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if quantized:
        for arg, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or t.shape != k_cache.shape[:-1]:
                raise ValueError(f"{name}: {arg} must be float32 "
                                 f"{tuple(k_cache.shape[:-1])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")
    h, s, d = q.shape[-3:]
    hkv, _, dk = k_cache.shape[-3:]
    if dk != d or h % hkv != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit "
                         f"cache {tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if (tree_mask.dtype != torch.bool or tree_mask.dim() != q.dim() - 1
            or tree_mask.shape[:-1] != q.shape[:-3] + (s,)):
        raise ValueError(f"{name}: mask must be bool [{'B, ' if q.dim() == 4 else ''}"
                         f"S={s}, T_reg], got {tree_mask.dtype} {tuple(tree_mask.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and tree_mask.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"{name}: q and the caches must be 16-byte aligned")
    return quantized


Shape = Tuple[int, int]  # (cluster size, walkers a block)


def pick_cluster(nslots: int, hkv: int, gs: int, resident: Dict[Shape, int]) -> Shape:
    """The (cluster size, walkers) of a head_dim-128 call, from its shapes
    alone (the host never reads tree_start).  ``resident`` maps each built
    shape to the clusters of it the card holds at once for this dtype pair
    and gs (0: its shared memory does not fit).  The grid has one cluster
    per (slot x kv head, 64 query rows); W > 1 walkers are taken only where
    one walker's QTILE / W rows hold all gs.  A block's chain is ceil(8 / C /
    W) virtual ranks.  Of the shapes that keep at least as many walkers
    resident as the cluster of 8 (a shape's extra tiles and slots of shared
    memory may cost blocks an SM), the one with the shortest chain, then
    the largest cluster, whose grid runs in at most two waves is taken,
    else the one with the fewest waves.  The output does not depend on the
    shape (chip_smoke.py --attention-sweep holds the rule: (8, 1) for one
    request, (4, 2) for the B = 4 rounds over a bf16 cache, (8, 1) for the
    B = 4 verify over int8 and in float32, (4, 1) for the B = 4 step over
    int8, (1, 1) for getkacc's 16 one-row slots)."""
    tiles = nslots * hkv * -(-gs // QTILE)
    if resident.get((VRANKS, 1), 0) <= 0:
        raise RuntimeError(f"verify_attention: no cluster of {VRANKS} fits (resident {resident})")
    full = resident[(VRANKS, 1)] * VRANKS
    shapes = [(c, w) for (c, w), n in resident.items()
              if n * c * w >= full and (w == 1 or gs <= QTILE // w)]
    waves = {x: -(-tiles // resident[x]) for x in shapes}
    order = sorted(shapes, key=lambda x: (-(-VRANKS // x[0] // x[1]), -x[0]))
    for x in order:
        if waves[x] <= 2:
            return x
    return min(order, key=lambda x: waves[x])


def register_build_holds(nslots: int, hkv: int, gs: int, register8: int) -> bool:
    """Whether bf16 q over int8 runs its register build: p * v_scale packed
    inside P.V, in two blocks an SM, where the P-tile build keeps three.  It
    is taken when one wave of its ``register8`` clusters of 8 holds the
    whole grid: then a block has its SM's tensor cores mostly to itself and
    the P tiles' pack would only lengthen each chunk (Qwen2.5-VL's and the
    GQA single requests, 8-16 clusters); a grid that needs more waves keeps
    the P tiles' third block an SM."""
    return nslots * hkv * -(-gs // QTILE) <= register8


_RESIDENT: Dict[tuple, Dict[Shape, int]] = {}
_PICKED: Dict[tuple, Tuple[int, int, bool]] = {}


def two_builds(q_dtype: torch.dtype, int8: bool) -> bool:
    """bf16 q over int8 has a P-tile build (every shape) and a register
    build (clusters of 8, one walker); the other pairs have one build."""
    return int8 and q_dtype == torch.bfloat16


def shapes_built(q_dtype: torch.dtype, int8: bool, p_tiles: bool) -> Tuple[Shape, ...]:
    """The (cluster, walkers) shapes the source builds for this dtype pair
    and build: every cluster size with one walker, also WALKER_SHAPES for
    bf16 q over a bf16 cache, (8, 1) alone for the register build."""
    if two_builds(q_dtype, int8) and not p_tiles:
        return ((VRANKS, 1),)
    one = tuple((c, 1) for c in CLUSTERS)
    return one + WALKER_SHAPES if q_dtype == torch.bfloat16 and not int8 else one


def resident_clusters(device: torch.device, q_dtype: torch.dtype, int8: bool, gs: int,
                      p_tiles: Optional[bool] = None) -> Dict[Shape, int]:
    """{(cluster size, walkers): clusters the card holds at once} of the
    head_dim-128 kernel for this dtype pair at ``gs`` query rows a kv head
    (an occupancy query per instantiation, kept); bf16 q over int8: of its
    P-tile build, or with ``p_tiles=False`` of its register build
    ({(8, 1): n})."""
    pt = two_builds(q_dtype, int8) if p_tiles is None else p_tiles
    key = (device.index, q_dtype, int8, min(gs, QTILE), pt)
    if key not in _RESIDENT:
        lib = _library()
        counts = {(c, w): lib.vispec_verify_attention_max_clusters(
            int(q_dtype == torch.bfloat16), int(int8), c, w, int(pt), gs)
            for c, w in shapes_built(q_dtype, int8, pt)}
        bad = {x: n for x, n in counts.items() if n < 0}
        if bad:
            raise RuntimeError(f"verify_attention: occupancy query failed {bad}")
        _RESIDENT[key] = counts
    return _RESIDENT[key]


def pick_shape(nslots: int, hkv: int, gs: int, resident: Dict[Shape, int],
               register8: Optional[int] = None) -> Tuple[int, int, bool]:
    """(cluster size, walkers, P tiles) of a head_dim-128 call from its
    shapes and the card's resident tables alone: bf16 q over int8
    (``register8``: the clusters of 8 of its register build the card holds)
    takes the register build at (8, 1) where ``register_build_holds``, else
    ``pick_cluster``'s shape of the P-tile build; the other pairs
    (``register8`` None) ``pick_cluster``'s shape of their one build."""
    if register8 is not None and register_build_holds(nslots, hkv, gs, register8):
        return VRANKS, 1, False
    c, w = pick_cluster(nslots, hkv, gs, resident)
    return c, w, register8 is not None


def cluster_for(device: torch.device, q_dtype: torch.dtype, int8: bool, nslots: int,
                hkv: int, gs: int) -> Tuple[int, int, bool]:
    """``pick_shape`` on this card's resident tables (occupancy queries),
    kept per shape."""
    key = (device.index, q_dtype, int8, nslots, hkv, gs)
    if key not in _PICKED:
        register8 = (resident_clusters(device, q_dtype, int8, gs, False)[(VRANKS, 1)]
                     if two_builds(q_dtype, int8) else None)
        _PICKED[key] = pick_shape(nslots, hkv, gs,
                                  resident_clusters(device, q_dtype, int8, gs), register8)
    return _PICKED[key]


def _launch(q, k_cache, v_cache, k_scale, v_scale, tree_mask, start, layer,
            nslots: int, has_layer: bool, *, _cluster: Optional[int] = None,
            _walkers: int = 1, _p_tiles: Optional[bool] = None) -> torch.Tensor:
    """One call over ``nslots`` slots (1 for a single request, whose slot
    strides are then 0): one launch at head_dim 128, a launch pair over
    float32 scratch at 16.  ``start`` and ``layer`` are int32 [nslots] on
    the device; the caches' leading dims are (slot,)? + (layer,)?.  The
    shape and build at head_dim 128 are ``cluster_for``'s, or forced by
    ``_cluster`` (a size in CLUSTERS) with ``_walkers`` (``shapes_built``)
    and ``_p_tiles`` (bf16 q over int8: False for the register build, (8, 1)
    only; default the P tiles).  The tests and chip_smoke.py's sweep force
    them, and the output is the same bits.  A batch's block columns serve
    its slots longest first whatever the shape."""
    quantized = k_scale is not None
    h, s, d = q.shape[-3:]
    hkv, max_len = k_cache.shape[-3:-1]
    batched = q.dim() == 4
    slot_stride = k_cache.stride(0) if batched else 0
    scale_slot_stride = k_scale.stride(0) if batched and quantized else 0
    mask_slot_stride = tree_mask.stride(0) if batched else 0
    layer_stride = k_cache.stride(-4) if has_layer else 0
    scale_stride = k_scale.stride(-3) if has_layer and quantized else 0

    lib = _library()
    gs = (h // hkv) * s
    cluster, walkers, p_tiles = 0, 1, False
    if d == FOLDED_HEAD_DIM:
        if _cluster is None:
            cluster, walkers, p_tiles = cluster_for(q.device, q.dtype, quantized, nslots, hkv,
                                                    gs)
        else:
            cluster, walkers = _cluster, _walkers
            p_tiles = two_builds(q.dtype, quantized) if _p_tiles is None else _p_tiles
        if (cluster, walkers) not in shapes_built(q.dtype, quantized, p_tiles):
            raise ValueError(f"verify_attention: shape {(cluster, walkers)} not in "
                             f"{shapes_built(q.dtype, quantized, p_tiles)}")
    scratch = [None, None, None]
    if d != FOLDED_HEAD_DIM:
        nc = -(-max_len // lib.vispec_verify_attention_tile())
        part_m = torch.empty((nslots * hkv, nc, gs), dtype=torch.float32, device=q.device)
        scratch = [part_m, torch.empty_like(part_m),
                   torch.empty((nslots * hkv, nc, gs, d), dtype=torch.float32,
                               device=q.device)]
    out = torch.empty_like(q)
    err = lib.vispec_verify_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tree_mask.data_ptr(), start.data_ptr(),
        layer.data_ptr() if has_layer else None,
        *(t.data_ptr() if t is not None else None for t in scratch),
        out.data_ptr(), nslots, hkv, gs, s, tree_mask.shape[-1], max_len,
        layer_stride, scale_stride, slot_stride, scale_slot_stride,
        mask_slot_stride, d, int(q.dtype == torch.bfloat16), int(quantized), cluster,
        walkers, int(p_tiles), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"verify_attention: kernel launch failed "
                           f"(CUDA error {err})")
    return out


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
    quantized = _check_operands("verify_attention", q, k_cache, v_cache, tree_mask,
                                k_scale, v_scale, (3, 4))
    if q.dim() != 3:
        raise ValueError(f"verify_attention: q must be [H, S, D], got {tuple(q.shape)}")
    start = _device_index(tree_start, q.device, "tree_start")
    has_layer = k_cache.dim() == 4
    layer = None
    if has_layer:
        if layer_idx is None:
            raise ValueError("verify_attention: layer_idx required for a 4-D cache")
        layer = _device_index(layer_idx, q.device, "layer_idx")
    out = _launch(q, k_cache, v_cache, k_scale, v_scale, tree_mask, start, layer, 1,
                  has_layer)
    if quantized:
        verify_attention.launches_int8 += 1
    else:
        verify_attention.launches += 1
    return out


verify_attention.launches = 0
verify_attention.launches_int8 = 0


def _slot_index(x, b: int, device, name: str) -> torch.Tensor:
    """An int32 [b] vector on ``device``, one entry per slot."""
    t = torch.as_tensor(x, device=device)
    if t.shape != (b,):
        raise ValueError(f"{name} must hold one entry per slot: shape ({b},), "
                         f"got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _check_slots(q, k_cache, layer_idx, k_scale):
    """The batched grid takes per-slot caches only: the JAX rule asserts that
    caches and scale tables arrive batched (``pallas_attention.py:270-273``),
    and broadcasting a multi-GB cache B times is never what a caller wants."""
    if q.dim() != 4:
        raise ValueError(f"verify_attention_batched: q must be [B, H, S, D], "
                         f"got {tuple(q.shape)}")
    b = q.shape[0]
    want = 5 if layer_idx is not None else 4
    if k_cache.dim() != want or k_cache.shape[0] != b:
        raise ValueError(
            f"verify_attention_batched: the cache must carry the slot dim "
            f"[B={b}, {'L, ' if layer_idx is not None else ''}Hkv, max_len, D], "
            f"got {tuple(k_cache.shape)}")
    if k_scale is not None and k_scale.shape[:1] != (b,):
        raise ValueError(f"verify_attention_batched: scales must carry the slot dim, "
                         f"got {tuple(k_scale.shape)}")


def verify_attention_batched_ref(
    q: torch.Tensor,  # [B, H, S, D]
    k_cache: torch.Tensor,  # [B, Hkv, max_len, D] or [B, L, Hkv, max_len, D]
    v_cache: torch.Tensor,
    tree_start,  # [B] int32
    tree_mask: torch.Tensor,  # [B, S, T_reg] bool
    layer_idx=None,  # [B] int32 when the cache has a layer dim
    k_scale: Optional[torch.Tensor] = None,  # [B, L?, Hkv, max_len] f32 iff int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the batched kernel: ``verify_attention_ref`` applied
    to each slot with that slot's cache, start, mask and layer."""
    _check_slots(q, k_cache, layer_idx, k_scale)
    b = q.shape[0]
    starts = _slot_index(tree_start, b, q.device, "tree_start")
    layers = None if layer_idx is None else _slot_index(layer_idx, b, q.device,
                                                        "layer_idx")
    return torch.stack([
        verify_attention_ref(
            q[i], k_cache[i], v_cache[i], starts[i], tree_mask[i],
            None if layers is None else layers[i],
            None if k_scale is None else k_scale[i],
            None if v_scale is None else v_scale[i])
        for i in range(b)])


def verify_attention_batched(
    q: torch.Tensor,  # [B, H, S, D]
    k_cache: torch.Tensor,  # [B, Hkv, max_len, D] or [B, L, Hkv, max_len, D]
    v_cache: torch.Tensor,
    tree_start,  # [B] int32 on q's device — per-slot committed prefix lengths
    tree_mask: torch.Tensor,  # [B, S, T_reg] bool — per-slot region visibility
    layer_idx=None,  # [B] int32 on q's device; required for a layer-stacked cache
    k_scale: Optional[torch.Tensor] = None,  # [B, L?, Hkv, max_len] f32 iff int8
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Length-aware attention for B slots at once (the batched grid, table
    row 1c); returns [B, H, S, D] in q's dtype.  Every slot has its own
    cache, mask, start and layer; a cache without the slot dim is refused.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once for the whole batch (head_dim 16: a kernel pair) or raises.  Launches count in
    ``verify_attention_batched.launches`` (bf16/f32 cache) and
    ``verify_attention_batched.launches_int8`` (int8 cache)."""
    if q.device.type == "cpu":
        return verify_attention_batched_ref(q, k_cache, v_cache, tree_start, tree_mask,
                                            layer_idx, k_scale, v_scale)
    _check_slots(q, k_cache, layer_idx, k_scale)
    quantized = _check_operands("verify_attention_batched", q, k_cache, v_cache,
                                tree_mask, k_scale, v_scale, (4, 5))
    b = q.shape[0]
    start = _slot_index(tree_start, b, q.device, "tree_start")
    has_layer = layer_idx is not None
    layer = _slot_index(layer_idx, b, q.device, "layer_idx") if has_layer else None
    out = _launch(q, k_cache, v_cache, k_scale, v_scale, tree_mask, start, layer, b,
                  has_layer)
    if quantized:
        verify_attention_batched.launches_int8 += 1
    else:
        verify_attention_batched.launches += 1
    return out


verify_attention_batched.launches = 0
verify_attention_batched.launches_int8 = 0
