"""Chip smoke test of the PyTorch + CUDA port (vispec_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py (--end-to-end | --engine-rounds | --attention-times
                           | --attention-sweep | --q4-times) [CHECKOUT ...]

Builds the port's CUDA kernels from the sources in this checkout (in
parallel), holds each against its plain PyTorch version at the main paths'
shapes (Vicuna-7B width; and at the parallel phases' shard shapes: 16
heads over 16 or 4 KV heads, a pp stage's cache, the tp 2 engine's batched
rounds, getkacc's rollout at tp 2), then drives greedy ViSpec decoding end
to end: the
trained toy checkpoint in tests/data/tau_fixture.npz, a 2-layer float32
Vicuna-7B-width model (speculative output must equal autoregressive), the
bfloat16 model at 8 of its 32 layers (``DEPTH_LAYERS``, the depth of
every full-width model below) with random weights from a seed, and the
quantized serving mode (int8 KV cache, int4 draft, int8 target) at 2 layers
in float32 (spec == AR) and at 8 layers in bfloat16 (the same model,
quantized in place).  The serving half runs too: batched decoding equal to
per-request decoding (2 layers, float32, bf16-free and quantized), the
trained toy checkpoint through the continuous-batching engine, and the
engine at 8 layers in bfloat16 and quantized, with the batched-grid
kernel's launches counted per round.  Then LLaVA image prompts: the CLIP
ViT-L tower on the card against the CPU, LLaVA-1.6 and 1.5 at 2 layers in
float32 (spec == AR, batch == per request, CLIP-L at all 24 layers), at 8
layers in bfloat16 with 576, 2,340 and 2,928 image tokens (vision-encode
and prefill ms, the kernel's launches per round as on the text path), and
the engine over image and text requests.  Then Qwen2.5-VL image and video
prompts: the windowed ViT on the card against the CPU, Qwen2.5-VL-7B widths
at 2 layers in float32 (spec == AR with one image, two images and a video;
batch and engine == per request; the quantized mode), at 8 of 28 layers in
bfloat16 with a 448x448, an 896x1120, two 448x448 images and an 8-frame
video (encode and prefill ms, the kernel's launches per round), and the
engine over image and text requests; the kernel rows include Qwen's GQA
geometry (groups of 7).  Then Mixtral-8x7B widths (8 experts, top-2, 32
heads over 8 KV heads) at 2 layers in float32 (spec == AR, batch and engine
== per request, int8 KV with an int4 draft), multi-turn conversation
snapshots at 2 layers in float32 (continuation == full prefill), HF
checkpoints written under build/ and loaded by ``from_pretrained`` onto the
card (bit-equal, load rate), the snapshot continuation and the tree-width
autotune on the 8-layer 7B, and Mixtral at 8 of its 32 layers in bfloat16
(tok/s, launches, idle share, the engine, the autotune); the kernel rows
include Mixtral's groups of 4.  Then the evaluation harness and draft
training: ``run_eval`` over vendored MT-bench questions at 2 layers in
float32 (spec == AR on every turn) and at 8 layers in bfloat16 with
``arrival_bench`` on the engine, training steps on the card against the
CPU at toy widths, a training sample generated by the 7B and ten
7B-width steps with the state round trip and ``getkacc``, and a LLaVA-1.5
image sample with a step through the image adaptor; a 1c kernel row at
``getkacc``'s shape.  Then multi-device inference (``parallel/``) in worlds
of rank processes of this script (``--parallel-rank``) that share the card
over gloo with CUDA tensors: tp 2, pp 2, pp 2 x sp 2, tp 2 with an int4
draft over int8 KV and Mixtral at ep 2, 2 layers in float32, token-equal
to one process; Vicuna-7B and Mixtral at 8 of 32 layers in
bfloat16 over tp / ep 2 (tok/s, launches and collectives per round, idle
share, peak memory per rank: on one card these measure the collectives'
cost, not a speed-up).  Then parallel draft training and the engine on a
sharded model: the toy float32 draft's steps at dp 2 x sp 2 (an image span
across the sp boundary) and dp 2 x tp 2 in a world of four ranks against
one process's, with an orbax (torch.distributed.checkpoint) save and
reload of the shards; the Vicuna-7B-width draft's bf16 steps at dp 2 and
tp 2 over two ranks (step ms, collectives, peak memory, getkacc at tp 2);
the engine at tp 2 against the unsharded engine, exactly at 2 layers in
float32 and at 8 layers in bfloat16 (ranks agree; launches a round), each
plain and quantized; the serving examples on the card.  Last, kernel 2's
rows at the (K, N / 2, M) the tp 2 draft sent it.  Prints one JSON line
per phase, a
``{"kernels": [...]}`` line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without that line; so does a machine without a
CUDA device.

The other forms compare checkouts within one call on one card (for
example: the parent unpacked under build/, this one, this one, the
parent; this one alone if none is given).  Each checkout runs in a process
of its own with its own chip_smoke and kernels, its lines tagged with it,
and neither of the last lines is printed.  ``--end-to-end``: the 32-layer
bfloat16 decode loop and engine, training at its width with ``getkacc``,
then the same model quantized, single request and through the engine
(``full_width_depth``, ``serving_full_depth``, ``train_full_width``,
``quant_full_depth``,
``serving_quant_full_depth`` and their profiles).  ``--engine-rounds``:
the B = 4 engine's rounds at all 32 layers under torch.profiler, bfloat16
then quantized, twice each (``engine_rounds``: the attention's device ms a
round).  ``--attention-times``:
every attention ``kernel_vs_plain`` line (rows 1a, 1b, 1c).
``--attention-sweep``: rows 1a, 1b and 1c at every (cluster size, walkers)
shape of the attention kernel, the kernel's time alone.
``--q4-times``: kernel 2 alone.  ``--parallel`` runs only the build and
the multi-device phases (on a machine with a card per rank their worlds
take NCCL, one card each).
"""

import contextlib
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
L2_BYTES = 50 * 2**20
SOURCES = ("verify_attention", "q4_matmul")
# kernel 2 against its plain version (bf16-rounded dequantized weights, so
# the gap grows with sqrt(K)): max abs error over the output's largest
# magnitude; against the same math in float32 (summation order only)
Q4_TOL, Q4_EXACT_TOL = 2e-2, 1e-5
# new tokens of each run under torch.profiler (16 until the training and
# eval phases needed the time, 8 until slice 14's)
PROFILE_TOKENS = 4
# rounds of the engine chunk under torch.profiler (8 until slice 14's phases)
PROFILE_CHUNK_ROUNDS = 4
# torch.profiler sessions tried before one that recorded nothing fails
PROFILE_ATTEMPTS = 3
# new tokens of each sampled / drafter run of sampling_full_depth and of
# each mixtral_full_depth run (128 until slice 12's phases, 64 until slice 14's)
DEPTH_TOKENS = 32
# requests of serving_full_depth also run one at a time for the serial rate
# (4 until slice 15's)
SERIAL_REQUESTS = 2
# MT-bench questions of eval_full_depth (2 before slice 13's phases) and
# new tokens a turn (128 before slice 14's, 64 before slice 15's)
EVAL_QUESTIONS = 1
EVAL_TOKENS = 32
# new tokens of each arrival_full_depth request (64 before slice 14's
# phases, 32 before slice 15's)
ARRIVAL_TOKENS = 16
# new tokens of each spec and AR run of the image prompts
# (llava_full_depth, qwen_full_depth; 128 before slice 15's) and the CUDA-
# event calls behind each of their encode and prefill medians (10 before)
IMAGE_DEPTH_TOKENS = 64
IMAGE_TIMED_CALLS = 5
# target layers of every full-width model the default run decodes with
# (Vicuna-7B, LLaVA, Qwen2.5-VL, Mixtral, the tp 2 worlds): 32, 32, 28 and
# 24 of their 32, 32, 28 and 32 until slice 16, when the whole run took
# 946 s on one host and over 1,200 s on another; --end-to-end keeps 32
DEPTH_LAYERS = 8
# the 1c kernel row at getkacc's shape: 16 slots' committed rows
KACC_STARTS = tuple(int(x) for x in np.random.default_rng(70).integers(256, 511, 16))


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase line carries the seconds since the script
    started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def timed_ms(fn, flush, n=30):
    """Mean device time of ``fn`` over ``n`` calls, each after an L2 flush
    (the main path finds the cache rows cold), from CUDA events around each
    call.  A sleep kernel first holds the device while the host queues all
    calls, so no interval contains the host's time to issue a call."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(100_000_000)  # ~55 ms at the H100's clocks
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / n


def _kernel_tag(key):
    """Which of the port's kernels a profiler key names, or None.  The
    tensor-core attention kernel over an int8 cache is told apart as
    ``partial_kernel_mma_int8`` (demangled ``partial_kernel_mma<float,
    signed char, 128>`` or ``<__nv_bfloat16, signed char, 128>``, mangled
    ``partial_kernel_mmaIfaLi128E`` or ``partial_kernel_mmaI13__nv_bfloat16a``);
    over a bf16 or float32 cache it is ``partial_kernel_mma``."""
    if re.search(r"partial_kernel_mma(<[^,<>]+, signed char|I(f|13__nv_bfloat16)a)", key):
        return "partial_kernel_mma_int8"
    for tag in ("q4_mma_kernel", "partial_kernel_mma", "partial_kernel", "combine_kernel"):
        if tag in key:
            return tag
    return None


def kernel_split_ms(fn, flush, n=10):
    """Device time of each kernel one attention call launches (at head dim
    128 one, ``partial_kernel_mma``; at 16 ``partial_kernel`` and
    ``combine_kernel``): the mean over ``n`` calls after an L2 flush each, by
    kernel name, from torch.profiler; and the port's kernel launches a call.
    A call always launches one, so a session that recorded none of the
    port's kernels saw nothing (torch.profiler's CUDA activity loses whole
    sessions on some hosts): it is run again, and after PROFILE_ATTEMPTS
    such sessions this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        out = {"kernel_launches_per_call": 0.0}
        for e in prof.key_averages():
            tag = _kernel_tag(e.key) if e.device_type == DeviceType.CUDA else None
            if tag:
                out[tag + "_ms"] = out.get(tag + "_ms", 0.0) + e.device_time_total / 1e3 / n
                out["kernel_launches_per_call"] += e.count / n
        if out["kernel_launches_per_call"] > 0:
            return out
    raise RuntimeError(f"torch.profiler recorded no kernel of the port in {PROFILE_ATTEMPTS} "
                       f"sessions of {n} calls that launch one each")


@contextlib.contextmanager
def forced_cluster(cluster, p_tiles=None, walkers=1):
    """Every head-dim-128 attention call inside runs at cluster size
    ``cluster`` with ``walkers`` walkers a block and, bf16 q over int8, in
    the build ``p_tiles`` names (None: the P tiles), through ``_launch``'s
    private keywords; cluster None: the shape and build the host picks."""
    from vispec_tpu_torch.ops import verify_attention as va

    if cluster is None:
        yield
        return
    launch = va._launch
    va._launch = functools.partial(launch, _cluster=cluster, _walkers=walkers,
                                   _p_tiles=p_tiles)
    try:
        yield
    finally:
        va._launch = launch


def _cluster_fields(dev, dtype, int8, nslots, h, hkv, s, cluster, p_tiles=None, walkers=1):
    """The cluster size and walkers a call runs at (forced, or the host's
    pick) and the clusters of that shape the card holds at once; bf16 q over
    int8 also its build (``p_tiles``: the P tiles, or p * v_scale packed in
    registers)."""
    from vispec_tpu_torch.ops import verify_attention as va

    gs = (h // hkv) * s
    if cluster is None:
        c, w, pt = va.cluster_for(dev, dtype, int8, nslots, hkv, gs)
    else:
        c, w = cluster, walkers
        pt = va.two_builds(dtype, int8) if p_tiles is None else p_tiles
    resident = va.resident_clusters(dev, dtype, int8, gs, pt)
    RESIDENT_SEEN[(str(dtype).replace("torch.", ""), int8, min(gs, va.QTILE), pt)] = resident
    out = {"cluster": c, "walkers": w, "resident_clusters": resident.get((c, w), 0)}
    if va.two_builds(dtype, int8):
        out["p_tiles"] = pt
    return out


# {(q dtype, int8 cache, query rows of a slot (at most 64), P tiles):
# {(cluster size, walkers): clusters the card holds}} of every attention row
# so far
RESIDENT_SEEN = {}


def phase_build():
    """Both sources at once, one nvcc each."""
    from vispec_tpu_torch.ops import cuda_build

    def build(name):
        t0 = time.perf_counter()
        so = cuda_build.build(name)
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, SOURCES))
    total = time.perf_counter() - t0
    for so, seconds in built:
        ptxas = _ptxas_by_kernel(so.with_suffix(".log").read_text())
        emit({"phase": "build", "ok": True, "seconds": seconds, "library": so.name,
              "ptxas": [f"{name}: {info}" for name, info in ptxas.items()]})
        # the tensor-core kernels: the attention's twenty-three instantiations
        # partial_kernel_mmaI<q><cache>Li128ELi<C>ELb<P tiles>ELi<W>ELb<order>E:
        # with the slot order, bf16 and float32 q, each over its own and an
        # int8 cache, at clusters of 8, 4, 2 and 1 with one walker, bf16 q
        # over a bf16 cache also at (4, 2), bf16 q over int8 in its register
        # build at (8, 1); the five (8, 1) ones again without it (single
        # requests); kernel 2's four; none may spill
        if "verify_attention" in so.name:
            tag = "partial_kernel_mma"
            shapes = ([(c, 1, pt) for c in (8, 4, 2, 1) for pt in (0, 0, 0, 1)] + [(8, 1, 0)]
                      + [(4, 2, 0)])
            want = ([f"Li128ELi{c}ELb{pt}ELi{w}ELb1E" for c, w, pt in shapes]
                    + [f"Li128ELi8ELb{pt}ELi1ELb0E" for pt in (0, 0, 0, 0, 1)])
        else:
            tag, want = "q4_mma_kernel", ["q4_mma_kernel"] * 4
        mma = {name: info for name, info in ptxas.items() if name.startswith(tag)}
        assert sorted(next(w for w in set(want) if w in name) for name in mma) == sorted(want) \
            and all("0 bytes spill stores, 0 bytes spill loads" in info
                    for info in mma.values()), f"{tag}: {mma}"
    emit({"phase": "build_all", "ok": True, "seconds": total})


def _ptxas_by_kernel(log):
    """``nvcc -Xptxas -v`` output as {kernel: "stack and spill bytes; registers"}.
    A kernel is named by its identifier and mangled template arguments
    (``partial_kernel_mmaILi128EE``)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            tail = re.search(r"_cu_[0-9a-f]{8}(\d+)", name)
            if tail:  # anonymous namespace: <len><identifier><template args>Ev<params>
                rest = name[tail.end():]
                name = rest[:int(tail.group(1))] + rest[int(tail.group(1)):].split("Ev")[0]
            out[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            info = ln.replace("ptxas info    :", "").strip()
            out[name] = f"{out[name]}; {info}" if out[name] else info
    return out


def _unfit(name, dev, dtype, int8, nslots, h, hkv, s, cluster, p_tiles=None, walkers=1):
    """A forced shape whose blocks' shared memory does not fit this call: a
    line saying so (True); a forced build or shape the dtype pair does not
    have, or two walkers whose rows do not hold the call's query rows a kv
    head: no line (True); else False.  One walker takes any query rows (a
    query tile a cluster along grid.z)."""
    from vispec_tpu_torch.ops import verify_attention as va

    if cluster is None:
        return False
    if p_tiles is not None and not va.two_builds(dtype, int8):
        return True
    pt = va.two_builds(dtype, int8) if p_tiles is None else p_tiles
    if ((cluster, walkers) not in va.shapes_built(dtype, int8, pt)
            or (walkers > 1 and (h // hkv) * s > va.QTILE // walkers)):
        return True
    fields = _cluster_fields(dev, dtype, int8, nslots, h, hkv, s, cluster, p_tiles, walkers)
    if fields["resident_clusters"] > 0:
        return False
    emit({"phase": "kernel_vs_plain", "case": name, **fields,
          "skipped": "the blocks' shared memory does not fit"})
    return True


def kernel_case(name, seed, dev, dtype, h, hkv, s, t_reg, start, layers, mask, flush,
                max_len=2048, d=128, cluster=None, light=False, walkers=1):
    """One main-path geometry: kernel vs plain version (max abs error), and
    the times of the kernel, the plain version and SDPA as a yardstick; the
    cluster size and walkers the call ran at and the clusters of that shape
    the card holds.  At ``cluster`` and ``walkers`` (cluster None: the
    picker's shape); ``light`` times the kernel alone."""
    if _unfit(name, dev, dtype, False, 1, h, hkv, s, cluster, walkers=walkers):
        return None
    import torch.nn.functional as F

    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.ops.attention import tree_verify_mask

    g = torch.Generator(device=dev).manual_seed(seed)
    cache_shape = (hkv, max_len, d) if layers is None else (layers, hkv, max_len, d)
    q = torch.randn((h, s, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn(cache_shape, generator=g, device=dev, dtype=dtype)
    v = torch.randn(cache_shape, generator=g, device=dev, dtype=dtype)
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    layer = None if layers is None else torch.tensor(layers - 1, dtype=torch.int32,
                                                     device=dev)
    args = (q, k, v, st, mask)
    with forced_cluster(cluster, walkers=walkers):
        out = va.verify_attention(*args, layer_idx=layer)
    ref = va.verify_attention_ref(*args, layer_idx=layer)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()

    total = start + t_reg
    k_l = k if layers is None else k[layers - 1]
    v_l = v if layers is None else v[layers - 1]
    k_live, v_live = k_l[:, :total], v_l[:, :total]
    sdpa_mask = tree_verify_mask(mask, st, max_len)[:, :total]

    def library():
        F.scaled_dot_product_attention(q[None], k_live[None], v_live[None],
                                       attn_mask=sdpa_mask[None, None],
                                       enable_gqa=h != hkv)

    with forced_cluster(cluster, walkers=walkers):
        ms = timed_ms(lambda: va.verify_attention(*args, layer_idx=layer), flush)
        plain_ms = None if light else timed_ms(
            lambda: va.verify_attention_ref(*args, layer_idx=layer), flush)
        library_ms = None if light else timed_ms(library, flush)
        split = {} if light else kernel_split_ms(
            lambda: va.verify_attention(*args, layer_idx=layer), flush)
    elem = q.element_size()
    moved = 2 * total * hkv * d * elem + 2 * q.numel() * elem + mask.numel()
    ops = 4 * h * s * total * d
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "H": h, "Hkv": hkv,
           "S": s, "T_reg": t_reg, "tree_start": start, "max_len": max_len, "D": d,
           "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **split}
    if d == 128:
        row.update(_cluster_fields(dev, dtype, False, 1, h, hkv, s, cluster, walkers=walkers))
    emit({"phase": "kernel_vs_plain", **row})
    assert err <= TOL[dtype], f"{name}: max abs err {err} > {TOL[dtype]}"
    return row


def phase_kernel(dev, cluster=None, light=False, walkers=1):
    """Table row 1a's four main-path geometries at 7B width (H = Hkv = 32,
    D = 128, max_len 2048), plus GQA, float32 and a ragged region end; then
    the LLaVA-1.6 prompts' geometry at max_len 4096 (64 chunks): the verify
    after the 2,956-row prompt of a 672x672 image, the draft expansion
    after the 2,368-row prompt of a 480x640 image, and a region that ends
    at max_len; and Qwen2.5-VL-7B's at max_len 4096 (groups of 7: the
    verify, the AR step; the draft's expansion at 28 heads).  Starts are
    not 64-row aligned and every region crosses a 64-row tile edge.  The
    bf16 cases run the tensor-core kernel in bf16, float32 in 3xTF32.  At
    ``cluster`` and ``walkers`` (cluster None: the picker's shape); ``light``
    times the kernel alone (the sweep)."""
    case = functools.partial(kernel_case, cluster=cluster, light=light, walkers=walkers)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(0)
    tree = torch.tril(torch.rand((30, 30), generator=g) < 0.3)
    tree.fill_diagonal_(True)
    tree[:, 0] = True
    expand = torch.zeros((8, 24), dtype=torch.bool)
    expand[:, :16] = torch.rand((8, 16), generator=g) < 0.3
    expand[torch.arange(8), 16 + torch.arange(8)] = True
    tree, expand = tree.to(dev), expand.to(dev)
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    tri = torch.tril(torch.ones((5, 5), dtype=torch.bool, device=dev))
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [
        case("target_verify", 0, dev, bf16, 32, 32, 30, 30, 301, 32, tree, flush),
        case("ar_step", 1, dev, bf16, 32, 32, 1, 1, 319, 32, ones, flush),
        case("draft_append", 2, dev, bf16, 32, 32, 5, 5, 317, None, tri, flush),
        case("draft_expand", 3, dev, bf16, 32, 32, 8, 24, 300, None, expand, flush),
        case("gqa_groups4", 4, dev, bf16, 32, 8, 30, 30, 301, 32, tree, flush),
        case("target_verify_f32", 5, dev, f32, 32, 32, 30, 30, 301, 32, tree, flush),
        # ragged: the region ends one column into a 64-row chunk (total 321)
        case("region_one_column_into_a_chunk", 6, dev, bf16, 32, 32, 30, 30,
                    5 * 64 + 1 - 30, 32, tree, flush),
        case("llava_target_verify_4096", 7, dev, bf16, 32, 32, 30, 30, 2956, 32, tree,
                    flush, max_len=4096),
        case("llava_draft_expand_4096", 8, dev, bf16, 32, 32, 8, 24, 2368, None,
                    expand, flush, max_len=4096),
        case("region_ends_at_max_len_4096", 9, dev, bf16, 32, 32, 30, 30, 4096 - 30,
                    32, tree, flush, max_len=4096),
        # Qwen2.5-VL-7B at max_len 4096 after the 1,344-row prompt of an
        # 896x1120 image: 28 heads over 4 KV heads (groups of 7: 210 query
        # rows a KV head at the verify, 7 at the AR step) over the 28-layer
        # cache, and the draft's 28 heads over 28 KV heads
        case("qwen_target_verify", 40, dev, bf16, 28, 4, 30, 30, 1381, 28, tree,
                    flush, max_len=4096),
        case("qwen_ar_step", 41, dev, bf16, 28, 4, 1, 1, 1400, 28, ones, flush,
                    max_len=4096),
        case("qwen_draft_expand", 42, dev, bf16, 28, 28, 8, 24, 1380, None, expand,
                    flush, max_len=4096),
        # the float32 Qwen model of qwen_exact: the 3xTF32 kernel at groups of 7
        case("qwen_target_verify_f32", 44, dev, f32, 28, 4, 30, 30, 1381, 28, tree,
                    flush, max_len=4096),
        # Mixtral-8x7B (32 heads over 8 KV heads; gqa_groups4 holds its
        # verify): the AR step over the 24-layer cache, the draft's append
        # and expansion at 32 over 8, and mixtral_exact's float32 verify over
        # its 2-layer cache (the 3xTF32 kernel at groups of 4)
        case("mixtral_ar_step", 60, dev, bf16, 32, 8, 1, 1, 319, 24, ones, flush),
        case("mixtral_draft_append", 61, dev, bf16, 32, 8, 5, 5, 317, None, tri,
                    flush),
        case("mixtral_draft_expand", 62, dev, bf16, 32, 8, 8, 24, 300, None, expand,
                    flush),
        case("mixtral_target_verify_f32", 63, dev, f32, 32, 8, 30, 30, 301, 2, tree,
                    flush),
        # the floor under every launch: one live chunk of one row (tree_start
        # 0, T_reg 1), the kernel's time alone
        case("launch_floor_one_chunk", 80, dev, bf16, 32, 32, 1, 1, 0, 32, ones, flush,
             light=True),
    ]
    return rows


def kernel_case_int8(name, seed, dev, h, hkv, s, t_reg, start, layers, mask, flush,
                     max_len=2048, d=128, dtype=torch.bfloat16, cluster=None, light=False,
                     p_tiles=None, walkers=1):
    """Kernel 1b at one main-path geometry: bf16 (or float32) q over a
    stacked int8 cache with per-row scales, read at layer ``layers - 1``.  No single PyTorch
    call attends over int8 rows with per-row scales, so ``library_ms`` is
    null; dequantize + SDPA over the live rows is printed as an extra.  At
    ``cluster``, ``walkers`` and build ``p_tiles`` (cluster None: the host's
    pick); ``light`` times the kernel alone."""
    if _unfit(name, dev, dtype, True, 1, h, hkv, s, cluster, p_tiles, walkers):
        return None
    import torch.nn.functional as F

    from vispec_tpu_torch.ops import kv_cache as kvc
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.ops.attention import tree_verify_mask

    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (layers, hkv, max_len, d)
    q = torch.randn((h, s, d), generator=g, device=dev, dtype=dtype)
    k, ks = kvc.quantize_rows(torch.randn(shape, generator=g, device=dev, dtype=dtype))
    v, vs = kvc.quantize_rows(torch.randn(shape, generator=g, device=dev, dtype=dtype))
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    layer = torch.tensor(layers - 1, dtype=torch.int32, device=dev)
    args = (q, k, v, st, mask, layer, ks, vs)
    with forced_cluster(cluster, p_tiles, walkers):
        out = va.verify_attention(*args)
    ref = va.verify_attention_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()

    total = start + t_reg
    k_l, v_l = k[layers - 1, :, :total], v[layers - 1, :, :total]
    ks_l, vs_l = ks[layers - 1, :, :total], vs[layers - 1, :, :total]
    sdpa_mask = tree_verify_mask(mask, st, max_len)[:, :total]

    def dequant_sdpa():
        kd = kvc.dequantize_rows(k_l, ks_l, dtype)
        vd = kvc.dequantize_rows(v_l, vs_l, dtype)
        F.scaled_dot_product_attention(q[None], kd[None], vd[None],
                                       attn_mask=sdpa_mask[None, None],
                                       enable_gqa=h != hkv)

    with forced_cluster(cluster, p_tiles, walkers):
        ms = timed_ms(lambda: va.verify_attention(*args), flush)
        plain_ms = None if light else timed_ms(lambda: va.verify_attention_ref(*args), flush)
        extra_ms = None if light else timed_ms(dequant_sdpa, flush)
        split = {} if light else kernel_split_ms(lambda: va.verify_attention(*args), flush)
    moved = (2 * total * hkv * d + 2 * total * hkv * 4 + 2 * q.numel() * q.element_size()
             + mask.numel())
    ops = 4 * h * s * total * d
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    row = {"case": name, "kernel": "1b", "dtype": str(dtype).replace("torch.", ""),
           "cache": "int8", "H": h,
           "Hkv": hkv, "S": s, "T_reg": t_reg, "tree_start": start, "max_len": max_len,
           "D": d, "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": None,
           "library_note": "no single PyTorch call attends over int8 rows with "
                           "per-row scales",
           "dequant_sdpa_ms": extra_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **split,
           **_cluster_fields(dev, dtype, True, 1, h, hkv, s, cluster, p_tiles, walkers)}
    emit({"phase": "kernel_vs_plain", **row})
    assert err <= TOL[dtype], f"{name} int8: max abs err {err} > {TOL[dtype]}"
    return row


def phase_kernel_int8(dev, cluster=None, light=False, p_tiles=None, walkers=1):
    """Table row 1b's main-path geometries at 7B width: the target verify and
    the AR step over the 32-layer int8 cache, GQA with 4 groups, a region
    that ends one column into a 64-row chunk, and the verify after a
    2,956-row LLaVA-1.6 prompt at max_len 4096; then Qwen2.5-VL-7B's over
    its 28-layer int8 cache at max_len 4096 (groups of 7): the verify and
    the AR step with bf16 q, and the verify with float32 q (qwen_exact's
    quantized model).  At ``cluster``, ``walkers`` and build ``p_tiles``
    (cluster None: the host's pick); ``light`` times the kernel alone (the
    sweep)."""
    case = functools.partial(kernel_case_int8, cluster=cluster, light=light, p_tiles=p_tiles,
                             walkers=walkers)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(1)
    tree = torch.tril(torch.rand((30, 30), generator=g) < 0.3)
    tree.fill_diagonal_(True)
    tree[:, 0] = True
    tree = tree.to(dev)
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    return [
        case("target_verify_int8", 10, dev, 32, 32, 30, 30, 301, 32, tree, flush),
        case("ar_step_int8", 11, dev, 32, 32, 1, 1, 319, 32, ones, flush),
        case("gqa_groups4_int8", 12, dev, 32, 8, 30, 30, 301, 32, tree, flush),
        case("region_one_column_into_a_chunk_int8", 13, dev, 32, 32, 30, 30,
                         5 * 64 + 1 - 30, 32, tree, flush),
        case("llava_target_verify_int8_4096", 14, dev, 32, 32, 30, 30, 2956, 32,
                         tree, flush, max_len=4096),
        case("qwen_target_verify_int8", 45, dev, 28, 4, 30, 30, 1381, 28, tree,
                         flush, max_len=4096),
        case("qwen_ar_step_int8", 46, dev, 28, 4, 1, 1, 1400, 28, ones, flush,
                         max_len=4096),
        case("qwen_target_verify_int8_f32", 47, dev, 28, 4, 30, 30, 1381, 28,
                         tree, flush, max_len=4096, dtype=torch.float32),
        # Mixtral-8x7B over int8 caches (gqa_groups4_int8 holds the verify):
        # the AR step over 24 layers, mixtral_exact's float32-q verify
        case("mixtral_ar_step_int8", 64, dev, 32, 8, 1, 1, 319, 24, ones, flush),
        case("mixtral_target_verify_int8_f32", 65, dev, 32, 8, 30, 30, 301, 2,
                         tree, flush, dtype=torch.float32),
    ]


def kernel_case_batched(name, seed, dev, dtype, h, hkv, s, t_reg, starts, layers, masks,
                        flush, int8=False, n_layers=32, max_len=2048, d=128, cluster=None,
                        light=False, p_tiles=None, walkers=1):
    """Kernel 1c (the batched grid) at one main-path geometry: B slots, each
    with its own cache, start, layer and region mask.  Against its plain
    version; times of the kernel, the plain version, the library yardstick
    (one SDPA call over [B, H, S, Lmax], Lmax = max start + T_reg, with a
    dense bool mask over each slot's live rows of its layer, selected before
    timing; int8: dequantize + SDPA, printed beside a null library_ms as for
    row 1b) and B launches of the single-request kernel on the same data.
    At ``cluster``, ``walkers`` and build ``p_tiles`` (cluster None: the
    host's pick); ``light`` times the kernel alone."""
    import torch.nn.functional as F

    from vispec_tpu_torch.ops import kv_cache as kvc
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.ops.attention import tree_verify_mask

    if _unfit(name, dev, dtype, int8, len(starts), h, hkv, s, cluster, p_tiles, walkers):
        return None
    b = len(starts)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, hkv, max_len, d) if layers is None else (b, n_layers, hkv, max_len, d)
    q = torch.randn((b, h, s, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    v = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    ks = vs = None
    if int8:
        k, ks = kvc.quantize_rows(k)
        v, vs = kvc.quantize_rows(v)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    layer = None if layers is None else torch.tensor(layers, dtype=torch.int32, device=dev)
    args = (q, k, v, st, masks, layer, ks, vs)
    force = functools.partial(forced_cluster, cluster, p_tiles, walkers)
    with force():
        out = va.verify_attention_batched(*args)
    ref = va.verify_attention_batched_ref(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()

    def one_a_per_slot():
        for i in range(b):
            va.verify_attention(q[i], k[i], v[i], st[i], masks[i],
                                None if layer is None else layer[i],
                                None if ks is None else ks[i], None if vs is None else vs[i])

    lmax = max(starts) + t_reg
    slots = torch.arange(b, device=dev)

    def live(x):  # each slot's layer, live rows only
        x = x if layer is None else x[slots, layer.long()]
        return x[..., :lmax, :] if x.dim() == 4 else x[..., :lmax]

    k_l, v_l = live(k), live(v)
    ks_l, vs_l = (live(ks), live(vs)) if int8 else (None, None)
    dense = torch.stack([tree_verify_mask(masks[i], st[i], max_len)[:, :lmax]
                         for i in range(b)])[:, None]

    def library():
        kk = kvc.dequantize_rows(k_l, ks_l, dtype) if int8 else k_l
        vv = kvc.dequantize_rows(v_l, vs_l, dtype) if int8 else v_l
        F.scaled_dot_product_attention(q, kk, vv, attn_mask=dense, enable_gqa=h != hkv)

    with force():
        ms = timed_ms(lambda: va.verify_attention_batched(*args), flush)
        plain_ms = None if light else timed_ms(
            lambda: va.verify_attention_batched_ref(*args), flush)
        yard_ms = None if light else timed_ms(library, flush)
        one_a_ms = None if light else timed_ms(one_a_per_slot, flush)
        split = {} if light else kernel_split_ms(
            lambda: va.verify_attention_batched(*args), flush)
    rows = sum(starts) + b * t_reg
    elem = 1 if int8 else q.element_size()
    moved = (2 * rows * hkv * d * elem + (2 * rows * hkv * 4 if int8 else 0)
             + 2 * q.numel() * q.element_size() + masks.numel())
    ops = 4 * h * s * rows * d
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    row = {"case": name, "kernel": "1c", "dtype": str(dtype).replace("torch.", ""),
           "cache": "int8" if int8 else str(dtype).replace("torch.", ""), "B": b, "H": h,
           "Hkv": hkv, "S": s, "T_reg": t_reg, "tree_starts": list(starts),
           "layers": layers, "max_len": max_len, "D": d, "live_rows": rows,
           "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": None if int8 else yard_ms, "one_a_x_b_ms": one_a_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **split}
    if d == 128:
        row.update(_cluster_fields(dev, dtype, int8, b, h, hkv, s, cluster, p_tiles, walkers))
    if int8:
        row.update(library_note="no single PyTorch call attends over int8 rows with "
                                "per-row scales", dequant_sdpa_ms=yard_ms)
    emit({"phase": "kernel_vs_plain", **row})
    assert err <= TOL[dtype], f"{name}: max abs err {err} > {TOL[dtype]}"
    del q, k, v, ks, vs, k_l, v_l, ks_l, vs_l
    torch.cuda.empty_cache()
    return row


def phase_kernel_batched(dev, cluster=None, light=False, p_tiles=None, walkers=1):
    """Table row 1c at the batched round's geometries, B = 4 at 7B width:
    the target verify over the 32-layer cache (slots at starts 301, 129,
    777, 1500 and layers 0, 5, 17, 31), the draft append and expansion over
    the layerless draft cache, GQA with 4 groups, float32, ragged starts
    (0, max_len - T_reg), and the int8 KV cache at the verify, at S = 1 and
    at the ragged starts.  Then the LLaVA engine's geometry at max_len 4096
    (64 chunks): starts 604 / 391 / 604 / 66 (two 604-row LLaVA-1.5 image
    prompts, two text prompts) at the verify, the draft expansion and the
    int8 verify; the Qwen2.5-VL-7B engine's verify (groups of 7) over
    bf16 and int8 caches; Mixtral's draft shapes; and ``trainer.getkacc``'s
    rollout at 7B widths: B = 16, S = 1 over a 519-row float32 draft
    cache.  At ``cluster``, ``walkers`` and build ``p_tiles`` (cluster
    None: the host's pick); ``light`` times the kernel alone (the sweep)."""
    case = functools.partial(kernel_case_batched, cluster=cluster, light=light,
                             p_tiles=p_tiles, walkers=walkers)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(2)
    b, starts, layers = 4, (301, 129, 777, 1500), (0, 5, 17, 31)
    llava_starts = (604, 391, 604, 66)
    tree = torch.tril(torch.rand((b, 30, 30), generator=g) < 0.3)
    tree |= torch.eye(30, dtype=torch.bool)
    tree[:, :, 0] = True
    expand = torch.zeros((b, 8, 24), dtype=torch.bool)
    expand[:, :, :16] = torch.rand((b, 8, 16), generator=g) < 0.3
    expand[:, torch.arange(8), 16 + torch.arange(8)] = True
    tri = torch.tril(torch.ones((b, 5, 5), dtype=torch.bool))
    ones = torch.ones((b, 1, 1), dtype=torch.bool)
    ones16 = torch.ones((len(KACC_STARTS), 1, 1), dtype=torch.bool)
    tree, expand, tri, ones = (t.to(dev).contiguous() for t in (tree, expand, tri, ones))
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [
        case("batched_target_verify", 20, dev, bf16, 32, 32, 30, 30, starts,
                            layers, tree, flush),
        case("batched_draft_append", 21, dev, bf16, 32, 32, 5, 5, starts,
                            None, tri, flush),
        case("batched_draft_expand", 22, dev, bf16, 32, 32, 8, 24, starts,
                            None, expand, flush),
        case("batched_gqa_groups4", 23, dev, bf16, 32, 8, 30, 30, starts,
                            layers, tree, flush),
        case("batched_target_verify_f32", 24, dev, f32, 32, 32, 30, 30,
                            starts, layers, tree, flush),
        # ragged: a region that ends at max_len, a slot with no committed
        # prefix, a region ending one column into a chunk, a short slot
        case("batched_ragged_starts", 27, dev, bf16, 32, 32, 30, 30,
                            (2048 - 30, 0, 5 * 64 + 1 - 30, 77), layers, tree, flush),
        case("batched_llava_verify_4096", 29, dev, bf16, 32, 32, 30, 30,
                            llava_starts, layers, tree, flush, max_len=4096),
        case("batched_llava_draft_expand_4096", 30, dev, bf16, 32, 32, 8, 24,
                            llava_starts, None, expand, flush, max_len=4096),
        # the Qwen2.5-VL-7B engine: groups of 7 over the 28-layer cache, two
        # image slots (1,381 and 339 rows), a long and a short text slot
        case("qwen_batched_verify", 43, dev, bf16, 28, 4, 30, 30,
                            (1381, 339, 1100, 104), (0, 9, 17, 27), tree, flush,
                            n_layers=28, max_len=4096),
        # the Mixtral-8x7B engine (batched_gqa_groups4 holds its verify): the
        # draft's append and expansion at 32 over 8; mixtral_exact's float32
        # B = 2 engine over its 2-layer cache
        case("mixtral_batched_draft_append", 66, dev, bf16, 32, 8, 5, 5,
                            starts, None, tri, flush),
        case("mixtral_batched_draft_expand", 67, dev, bf16, 32, 8, 8, 24,
                            starts, None, expand, flush),
        case("mixtral_batched_verify_f32", 68, dev, f32, 32, 8, 30, 30,
                            starts, (0, 1, 1, 0), tree, flush, n_layers=2),
        # getkacc's batched rollout at 7B widths (train_full_width): 16
        # prefixes, one query row each, over the float32 draft cache of
        # 512 + 5 + 2 rows (starts in the sample's generated half)
        case("batched_getkacc_f32_b16", 70, dev, f32, 32, 32, 1, 1,
                            KACC_STARTS, None, ones16.to(dev), flush, max_len=519),
        # the floor under every launch at B = 4: one live chunk of one row a
        # slot, the kernel's time alone
        case("batched_launch_floor_one_chunk", 81, dev, bf16, 32, 32, 1, 1, (0, 0, 0, 0),
             layers, ones, flush, light=True),
    ]
    rows_int8 = [
        case("batched_target_verify_int8", 25, dev, bf16, 32, 32, 30, 30,
                            starts, layers, tree, flush, int8=True),
        case("batched_step_int8", 26, dev, bf16, 32, 32, 1, 1, starts,
                            layers, ones, flush, int8=True),
        case("batched_ragged_starts_int8", 28, dev, bf16, 32, 32, 30, 30,
                            (2048 - 30, 0, 5 * 64 + 1 - 30, 77), layers, tree, flush,
                            int8=True),
        case("batched_llava_verify_int8_4096", 31, dev, bf16, 32, 32, 30, 30,
                            llava_starts, layers, tree, flush, int8=True, max_len=4096),
        case("qwen_batched_verify_int8", 48, dev, bf16, 28, 4, 30, 30,
                            (1381, 339, 1100, 104), (0, 9, 17, 27), tree, flush, int8=True,
                            n_layers=28, max_len=4096),
        case("mixtral_batched_verify_int8", 69, dev, bf16, 32, 8, 30, 30,
                            starts, (0, 5, 17, 23), tree, flush, int8=True, n_layers=24),
    ]
    return rows, rows_int8


def q4_case(dev, k, n, m, flush, prefix="q4"):
    """Kernel 2 at one draft shape: against its plain version (dequantize to
    bf16, then an f32-output GEMM) and against the same quantized math in
    float32; times of the kernel, the plain version and the bf16 library
    matmul over the pre-dequantized weight."""
    from vispec_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(7 * k + n + m)
    w4 = quant.quantize_q4(
        torch.randn((k, n), generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02))
    x = torch.randn((m, k), generator=g, device=dev, dtype=torch.bfloat16)
    out = quant.q4_matmul(x, w4)
    ref = quant.qdot4_ref(x, w4)
    exact = x.float() @ quant.dequantize(w4, torch.float32)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    exact_rel = ((out - exact).abs().max() / exact.abs().max()).item()

    wd = quant.dequantize(w4)  # bf16, dequantized once
    ms = timed_ms(lambda: quant.q4_matmul(x, w4), flush)
    plain_ms = timed_ms(lambda: quant.qdot4_ref(x, w4), flush)
    library_ms = timed_ms(lambda: torch.matmul(x, wd), flush)
    moved = w4.packed.numel() + 4 * w4.s.numel() + 2 * x.numel() + 4 * m * n
    ops = 2 * m * k * n
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[torch.bfloat16] * 1e3
    bf16_bound_ms = (2 * k * n + 2 * x.numel() + 2 * m * n) / HBM_BYTES_PER_S * 1e3
    row = {"case": f"{prefix}_{k}x{n}_m{m}", "kernel": "2", "K": k, "N": n, "M": m,
           "group_size": k // w4.s.shape[0], "max_abs_err": err, "max_rel_err": rel,
           "tol": Q4_TOL, "exact_rel_err": exact_rel, "exact_tol": Q4_EXACT_TOL,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_bound_ms": bf16_bound_ms}
    emit({"phase": "kernel_vs_plain", **row})
    assert rel <= Q4_TOL and exact_rel <= Q4_EXACT_TOL, row
    return row


def phase_kernel_q4(dev):
    """Table row 2 at the int4 draft's matrices (7B): M = 1 (root ranking),
    8 (beam expansion) and 64 (the largest M the dispatch rule sends to the
    kernel); and the B = 4 engine's stacked rows: M = 4 (root ranking), 20
    (append) and 32 (expansion)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    rows = [q4_case(dev, k, n, m, flush)
            for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
            for m in (1, 4, 8, 20, 32, 64)]
    torch.cuda.empty_cache()
    return rows


# One checkout's phases, run in a process of its own by ``checkout_runs``:
# that checkout's own chip_smoke, package and kernels
CHECKOUT_RUN = """
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke
dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.phase_build()
"""
CHECKOUT_PHASES = {
    # kernel 2 at M = 1, 4, 8, 20, 32 and 64 over the four 7B draft matrices
    "--q4-times": """
flush = torch.empty(2 * chip_smoke.L2_BYTES, dtype=torch.uint8, device=dev)
for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
    for m in (1, 4, 8, 20, 32, 64):
        chip_smoke.q4_case(dev, k, n, m, flush)
""",
    # every attention kernel_vs_plain line: rows 1a, 1b and 1c
    "--attention-times": """
chip_smoke.phase_kernel(dev)
chip_smoke.phase_kernel_int8(dev)
chip_smoke.phase_kernel_batched(dev)
""",
    # rows 1a, 1b and 1c at every (cluster size, walkers) shape, the
    # kernel's time alone (the picker's rule comes from this sweep)
    "--attention-sweep": """
chip_smoke.phase_attention_sweep(dev)
""",
    # the B = 4 engine over Vicuna-7B at all 32 layers, bfloat16 then
    # quantized (int8 KV, int4 draft, int8 target), each chunk of 8 rounds
    # under torch.profiler twice: device ms a round, the attention's apart
    "--engine-rounds": """
from vispec_tpu_torch.spec.spec_model import SpecModel
chip_smoke.PROFILE_CHUNK_ROUNDS = 8

def engine_rounds(tag, m):
    chip_smoke._warm_engine(m, dev)
    for _ in range(2):
        chunk = chip_smoke._profile_engine_chunk(m, 4)
        n = chunk["rounds"]
        chip_smoke.emit({
            "phase": "engine_rounds", "model": tag, "layers": m.tcfg.num_hidden_layers,
            "batch_size": 4, "rounds": n, "attention_launches": chunk["attention_launches"],
            "attention_ms_per_round": chunk["attention_ms"] / n,
            "device_busy_ms_per_round": chunk["device_busy_ms"] / n,
            "device_idle_share": chunk["device_idle_share"],
            "port_kernels_per_round": {k: [c / n, ms / n]
                                       for k, (c, ms) in chunk["port_kernels"].items()}})

model = chip_smoke._full_width_model(dev, 32, torch.bfloat16, seed=0)
engine_rounds("bfloat16", model)
draft = {k: v for k, v in model.dparams.items() if k not in ("fuse_we", "fuse_wh")}
model.target_cache = model.draft_cache = None
qmodel = SpecModel(model.tcfg, model.dcfg, model.spec, model.tparams, draft,
                   max_len=model.max_len, dtype=torch.bfloat16, device=dev,
                   quantize_kv=True, quantize_draft="int4")
qmodel.quantize_target_inplace()
del model
torch.cuda.empty_cache()
engine_rounds("int8_kv_int4_draft_int8_target", qmodel)
""",
    # the 7B decode loop and the engine at all 32 layers, training with
    # getkacc, then the quantized decode loop and engine
    "--end-to-end": """
chip_smoke.DEPTH_LAYERS = 32
model, prompt, row = chip_smoke.phase_full_width_depth(dev)
chip_smoke.phase_serving_full_depth(dev, model)
chip_smoke.phase_train_full_width(dev, model)
_, qmodel = chip_smoke.phase_quant_full_depth(dev, model, prompt, row)
chip_smoke.phase_serving_quant_full_depth(dev, qmodel)
""",
}


def phase_attention_sweep(dev):
    """Rows 1a, 1b and 1c at each (cluster size, walkers) shape the kernel
    is built for, one ``kernel_vs_plain`` line per row and shape (a shape
    whose shared memory does not fit a call says so; two walkers whose rows
    do not hold a call's query rows a kv head are left out), then the
    bf16-q-over-int8 rows in the register build (8, 1), the kernel's time
    alone; then the resident clusters of every build and row count."""
    from vispec_tpu_torch.ops import verify_attention as va

    for cluster, walkers in [(c, 1) for c in va.CLUSTERS] + list(va.WALKER_SHAPES):
        phase_kernel(dev, cluster=cluster, light=True, walkers=walkers)
        phase_kernel_int8(dev, cluster=cluster, light=True, walkers=walkers)
        phase_kernel_batched(dev, cluster=cluster, light=True, walkers=walkers)
    phase_kernel_int8(dev, cluster=va.VRANKS, light=True, p_tiles=False)
    phase_kernel_batched(dev, cluster=va.VRANKS, light=True, p_tiles=False)
    emit({"phase": "resident_clusters", "card": torch.cuda.get_device_name(0),
          "table": [{"dtype": d, "int8": q8, "rows": rows, "p_tiles": pt,
                     "resident": [{"cluster": c, "walkers": w, "clusters": n}
                                  for (c, w), n in res.items()]}
                    for (d, q8, rows, pt), res in sorted(RESIDENT_SEEN.items())]})


def checkout_runs(mode, roots):
    """The phases of ``mode`` in each checkout of ``roots`` (this one if none
    is given), in the order given, each in a process of its own that builds
    and imports that checkout.  Every line is printed tagged with its
    checkout."""
    for root in roots or [ROOT]:
        proc = subprocess.run([sys.executable, "-c", CHECKOUT_RUN + CHECKOUT_PHASES[mode], root],
                              capture_output=True, text=True, timeout=1200)
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                emit({"checkout": root, **json.loads(ln)})
        if proc.returncode != 0:
            sys.exit(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")


def phase_int8_qdot_cost(dev):
    """The plain-torch int8 ``qdot`` (the target's int8 weights: convert to
    bf16, GEMM, scale) at [4096, 11008] against the bf16 product, at the AR
    step's M = 1 and the verify's M = 30, and the convert alone."""
    from vispec_tpu_torch.ops import quant

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((4096, 11008), generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
    w8 = quant.quantize_q8(w)
    convert_ms = timed_ms(lambda: w8.q.to(torch.bfloat16), flush)
    for m in (1, 30):
        x = torch.randn((m, 4096), generator=g, device=dev, dtype=torch.bfloat16)
        emit({"phase": "int8_qdot_cost", "K": 4096, "N": 11008, "M": m,
              "int8_qdot_ms": timed_ms(lambda: quant.qdot(x, w8), flush),
              "bf16_qdot_ms": timed_ms(lambda: quant.qdot(x, w), flush),
              "convert_ms": convert_ms,
              "int8_bound_ms": (4096 * 11008 + 4 * 11008) / HBM_BYTES_PER_S * 1e3,
              "bf16_bound_ms": 2 * 4096 * 11008 / HBM_BYTES_PER_S * 1e3})


def _tau_model(dev):
    """The trained toy checkpoint in tests/data/tau_fixture.npz, float32."""
    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.convert.params import from_numpy, npz_side
    from vispec_tpu_torch.spec.spec_model import SpecModel

    z = np.load(os.path.join(ROOT, "tests", "data", "tau_fixture.npz"))
    tcfg = LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=512)
    dcfg = DraftConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=512)
    return SpecModel(tcfg, dcfg, SpecConfig(total_tokens=16, depth=3, top_k=4),
                     from_numpy(npz_side(z, "t"), dev), from_numpy(npz_side(z, "d"), dev),
                     max_len=512, dtype=torch.float32, eos_token_id=999, device=dev)


def phase_tau_fixture(dev):
    """The trained toy checkpoint (head_dim 16, GQA 2) in float32: spec equals
    AR on tests/test_e2e_tau.py's six prompts, tau >= recorded - 0.15."""
    z = np.load(os.path.join(ROOT, "tests", "data", "tau_fixture.npz"))
    model = _tau_model(dev)
    taus = []
    for s in range(6):
        prompt = np.random.default_rng(100 + s).integers(1, 90, 16).tolist()
        r = model.specgenerate(prompt, max_new_tokens=40)
        taus.extend(a + 1 for a in r.acceptance_lengths)
        ar = model.ar_generate(prompt, max_new_tokens=40)
        n = min(r.new_tokens, ar.new_tokens, 40)
        assert r.sequences[: 16 + n].tolist() == ar.sequences[: 16 + n].tolist(), \
            f"tau fixture prompt {s}: spec != AR"
    tau, recorded = float(np.mean(taus)), float(z["__tau__"])
    emit({"phase": "tau_fixture", "ok": tau >= recorded - 0.15, "tau": tau,
          "recorded_tau": recorded, "floor": recorded - 0.15})
    assert tau >= recorded - 0.15, (tau, recorded)


def _full_width_model(dev, layers, dtype, seed, **quant):
    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.models import draft, llama
    from vispec_tpu_torch.spec.spec_model import SpecModel

    tcfg, dcfg = LlamaConfig(num_hidden_layers=layers), DraftConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    tparams = llama.init_params(tcfg, g, dev, dtype)
    dparams = draft.init_params(dcfg, g, dev, dtype)
    dparams["embed"] = tparams["embed"]  # the draft's frozen copy of the target's
    return SpecModel(tcfg, dcfg, SpecConfig(), tparams, dparams, max_len=2048,
                     dtype=dtype, device=dev, **quant)


def phase_full_width_exact(dev):
    """Vicuna-7B widths, 2 target layers, float32 with TF32 off: greedy spec
    output equals AR for 64 new tokens."""
    model = _full_width_model(dev, 2, torch.float32, seed=1)
    prompt = np.random.default_rng(1).integers(3, 32000, 100).tolist()
    spec = model.specgenerate(prompt, max_new_tokens=64)
    ar = model.ar_generate(prompt, max_new_tokens=64)
    same = spec.sequences[:164].tolist() == ar.sequences[:164].tolist()
    emit({"phase": "full_width_exact", "ok": same, "layers": 2, "dtype": "float32",
          "new_tokens": [spec.new_tokens, ar.new_tokens], "rounds": spec.rounds})
    assert same and spec.new_tokens >= 64, "full width f32: spec != AR"
    del model
    torch.cuda.empty_cache()


def phase_quant_exact(dev):
    """The quantized serving mode at Vicuna-7B widths, 2 target layers,
    float32 with TF32 off: int8 KV cache, int4 draft (its kernel runs on
    bf16 activations, as in JAX) and int8 target.  Greedy spec output equals
    AR for 64 new tokens."""
    model = _full_width_model(dev, 2, torch.float32, seed=1, quantize_kv=True,
                              quantize_draft="int4")
    model.quantize_target_inplace()
    prompt = np.random.default_rng(1).integers(3, 32000, 100).tolist()
    spec = model.specgenerate(prompt, max_new_tokens=64)
    ar = model.ar_generate(prompt, max_new_tokens=64)
    same = spec.sequences[:164].tolist() == ar.sequences[:164].tolist()
    emit({"phase": "quant_exact", "ok": same, "layers": 2, "dtype": "float32",
          "kv": "int8", "draft": "int4", "target": "int8",
          "new_tokens": [spec.new_tokens, ar.new_tokens], "rounds": spec.rounds})
    assert same and spec.new_tokens >= 64, "quantized 2-layer f32: spec != AR"
    del model
    torch.cuda.empty_cache()


def phase_batch_exact(dev):
    """Batched decoding equals per-request decoding token for token: Vicuna-7B
    widths, 2 target layers, float32 with TF32 off, four prompts of 40, 90,
    130 and 200 tokens through ``generate_batch`` at B = 4 against
    ``specgenerate`` one at a time; then the same in the quantized
    composition (int8 KV cache, int4 draft, int8 target)."""
    from vispec_tpu_torch.spec import batch

    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 32000, n).tolist() for n in (40, 90, 130, 200)]
    for label, quant in (("float32", {}),
                         ("int8 KV + int4 draft + int8 target",
                          {"quantize_kv": True, "quantize_draft": "int4"})):
        model = _full_width_model(dev, 2, torch.float32, seed=2, **quant)
        if quant:
            model.quantize_target_inplace()
        outs = batch.generate_batch(
            model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, prompts,
            max_new_tokens=48, max_len=model.max_len, eos_id=model.eos_token_id,
            dtype=torch.float32, quantize_kv=bool(quant), device=dev)
        same, first_diff = [], []
        for p, o in zip(prompts, outs):
            ref = model.specgenerate(p, max_new_tokens=48).sequences[len(p):]
            n = min(len(o), len(ref), 48)
            same.append(n == 48 and o[:48].tolist() == ref[:48].tolist())
            first_diff.append(int(np.argmin(np.append(o[:n] == ref[:n], False))))
        emit({"phase": "batch_exact", "ok": all(same), "mode": label, "layers": 2,
              "B": 4, "prompts": [len(p) for p in prompts], "new_tokens": 48,
              "per_request_equal": same, "agreeing_prefix": first_diff})
        assert all(same), f"batch_exact ({label}): batched != per-request"
        del model
        torch.cuda.empty_cache()


GRAPH_TOKENS = 24  # new tokens a request in round_graph_exact


def _graph_or_eager(graph: bool):
    """Rounds replay where the runner engages (``graph``) or all run eager."""
    from unittest import mock

    from vispec_tpu_torch.spec import round_graph

    if graph:
        return contextlib.nullcontext()
    return mock.patch.object(round_graph.RoundGraph, "engages", lambda *a: False)


def _engine_run(model, reqs, graph: bool, batch_size=4, **kw):
    """Serve ``reqs`` ((request, cap) pairs, more than the slots: admissions
    land in the graph's buffers between chunks) through a fresh engine,
    replaying the captured round or (``graph`` False) eager; returns
    (outputs, engine)."""
    kw.setdefault("pad_bucket", (128, 256, 512))
    eng = model.serving_engine(batch_size=batch_size, chunk_rounds=4, **kw)
    with _graph_or_eager(graph):
        eng.start_session()
        rids = [eng.submit(r, max_new_tokens=c) for r, c in reqs]
        while eng.pending():
            eng.step()
    return [eng.results[r].tolist() for r in rids], eng


def phase_round_graph_exact(dev):
    """The decode round replayed as a CUDA graph (``spec/round_graph.py``)
    against the eager round, one B = 4 engine each over the same six
    requests: the same tokens in float32 with TF32 off (Vicuna-7B widths at
    2 layers: ViSpec, Medusa, int8 KV + int4 draft + int8 target, and
    per-request sampling at T = 1 from the slots' keys), on the trained toy
    checkpoint (B = 3, tau as recorded), and in bf16 at ``DEPTH_LAYERS``.
    On the bf16 engine: replays under CUDA's sync debug mode "error", and
    torch.profiler's attention launches over a replayed chunk equal the
    wrappers' counts; host ms a round, eager against replayed."""
    from vispec_tpu_torch.spec import batch, round_graph

    reqs = [(p, GRAPH_TOKENS) for p, _ in _serving_requests(6, seed=11)]

    def compare(label, model, reqs, batch_size=4, **kw):
        eager, _ = _engine_run(model, reqs, False, batch_size, **kw)
        graphed, eng = _engine_run(model, reqs, True, batch_size, **kw)
        g = eng._graph
        row = {"phase": "round_graph_exact", "case": label, "B": batch_size,
               "requests": len(reqs), "per_request_equal": [a == b for a, b in
                                                            zip(graphed, eager)],
               "rounds": eng.stats["rounds"], "graph_rounds": eng.stats["graph_rounds"],
               "captures": g.captures,
               "captured_launches": {f"{f.__name__}.{a}": n for (f, a), n in
                                     g.launches.items()}}
        row["ok"] = (all(row["per_request_equal"]) and g.captures == 1
                     and 0 < row["graph_rounds"] < row["rounds"])
        emit(row)
        assert row["ok"], f"round_graph_exact ({label}): graph != eager"
        return eng, row

    model = _full_width_model(dev, 2, torch.float32, seed=1)
    compare("vispec_f32", model, reqs)
    sampled = [({"input_ids": p, "temperature": 1.0, "top_k": 0}, c) for p, c in reqs]
    compare("sampled_t1_f32", model, sampled, per_request_sampling=True, top_k=8)
    med = _medusa_model(model, _medusa_params(model))
    compare("medusa_f32", med, reqs)
    del model, med
    torch.cuda.empty_cache()
    qmodel = _full_width_model(dev, 2, torch.float32, seed=2, quantize_kv=True,
                               quantize_draft="int4")
    qmodel.quantize_target_inplace()
    _, qrow = compare("int8kv_int4draft_int8target_f32", qmodel, reqs)
    assert qrow["captured_launches"].get("verify_attention_batched.launches_int8", 0) > 0
    assert qrow["captured_launches"].get("q4_matmul.launches", 0) > 0
    del qmodel
    torch.cuda.empty_cache()
    tau = _tau_model(dev)
    prompts = [(np.random.default_rng(100 + s).integers(1, 90, 16).tolist(), 40)
               for s in range(6)]
    eng, _ = compare("tau_fixture", tau, prompts, batch_size=3, pad_bucket=128)
    z = np.load(os.path.join(ROOT, "tests", "data", "tau_fixture.npz"))
    taus = [a + 1 for r in eng.acceptance.values() for a in r]
    emit({"phase": "round_graph_exact", "case": "tau_fixture_tau",
          "tau": float(np.mean(taus)), "recorded_tau": float(z["__tau__"])})
    del tau, eng
    model = _full_width_model(dev, DEPTH_LAYERS, torch.bfloat16, seed=0)
    eng, _ = compare(f"vispec_bf16_{DEPTH_LAYERS}_layers", model, reqs)
    # replays without a host sync: the engine's buffers, already captured
    eng.start_session()
    for p, c in reqs[:4]:
        eng.submit(p, max_new_tokens=c)
    eng.step()
    g, captures, replayed = eng._graph, eng._graph.captures, eng._graph.replayed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad(), round_graph.replaying(g):
            batch.batched_decode_rounds_chunk(
                model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec,
                eng.sampling, eng._states, model.eos_token_id, eng._caps, n_rounds=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert g.captures == captures and g.replayed == replayed + 2, "replays recaptured"
    steps = []

    def step():
        before = eng.stats["graph_rounds"]
        eng.step()
        steps.append(eng.stats["graph_rounds"] - before)

    prof = _profile(step)  # asserts the traced attention launches == the counters
    assert steps[-1] > 0, "the profiled step replayed no round"

    def host_ms_a_round(graph):
        """[host ms a round, ms a round to the device's end], medians of
        three chunks of 4 rounds (the eager rounds' new state is dropped:
        the graph's buffers stay as captured)."""
        with _graph_or_eager(graph):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad(), round_graph.replaying(g):
                    batch.batched_decode_rounds_chunk(
                        model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec,
                        eng.sampling, eng._states, model.eos_token_id, eng._caps,
                        n_rounds=4)
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                times.append([1e3 * host / 4, 1e3 * (time.perf_counter() - t0) / 4])
        return np.median(np.asarray(times), axis=0).tolist()

    turns = [host_ms_a_round(True), host_ms_a_round(False), host_ms_a_round(True)]
    emit({"phase": "round_graph_exact", "case": "bf16_replays", "sync_debug_error": "passed",
          "profiled_step_rounds": steps[-1], "attention_launches": prof["attention_launches"],
          "kernel_launches_per_round": prof["kernel_launches"] / steps[-1],
          "device_idle_share": prof["device_idle_share"],
          "ms_a_round_replayed_eager_replayed": turns, "captures": g.captures,
          "ok": g.captures == captures})
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_tau_fixture_batch(dev):
    """The trained toy checkpoint through ``ServingEngine(batch_size=3)``:
    the six tau prompts equal ``specgenerate`` per prompt, and in at least
    one round two slots accepted different lengths (per-slot offsets
    diverge through real acceptance)."""
    model = _tau_model(dev)
    prompts = [np.random.default_rng(100 + s).integers(1, 90, 16).tolist()
               for s in range(6)]
    refs = [model.specgenerate(p, max_new_tokens=40).sequences[16:56].tolist()
            for p in prompts]
    eng = model.serving_engine(batch_size=3, max_new_tokens=40, chunk_rounds=4)
    outs = eng.run_all(prompts)
    same = [o.tolist() == r for o, r in zip(outs, refs)]
    first = [eng.acceptance[r] for r in range(3)]  # admitted together: rounds align
    n = min(len(a) for a in first)
    diverged = sum(len({a[i] for a in first}) > 1 for i in range(n))
    emit({"phase": "tau_fixture_batch", "ok": all(same) and diverged > 0, "B": 3,
          "per_request_equal": same, "rounds_with_divergent_accepts": diverged,
          "rounds": eng.stats["rounds"],
          "tau": float(np.mean([a + 1 for r in eng.acceptance.values() for a in r]))})
    assert all(same), "tau fixture batched: engine != specgenerate"
    assert diverged > 0, "tau fixture batched: no round with divergent per-slot accepts"


def _decode_round_without_host_sync(model, prompt, sampling=None):
    """One decode round with CUDA's sync debug mode set to error: the round
    must not wait on the device (no .item(), no blocking copy).  Greedy by
    default; ``sampling`` makes it a sampled round (drawing from a key), and
    a model with Medusa heads runs a Medusa round."""
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.ops import rng
    from vispec_tpu_torch.spec import loop
    from vispec_tpu_torch.spec.spec_model import padded_text_embeds

    dev = model.device
    pad = 128
    sampling = sampling or loop.SamplingParams()
    key = None if sampling.greedy else rng.key(0, dev)
    embeds = padded_text_embeds(model.tparams, prompt, pad, dev)
    with torch.no_grad():
        if model.mparams is not None:
            state = loop.medusa_prefill(model.tparams, model.mparams, model.tcfg,
                                        model.spec, sampling, embeds, len(prompt),
                                        kv.reset(model.target_cache), 64, key=key)
        else:
            plan, span = draft_mod.make_prefill_plan(None, len(prompt), model.dcfg.num_q,
                                                     pad, max_span=64, device=dev)
            state = loop.spec_prefill(
                model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, plan,
                sampling, embeds, kv.reset(model.target_cache), kv.reset(model.draft_cache),
                64, span, key=key)
        eos = torch.tensor(2, dtype=torch.int32, device=dev)
        cap = torch.tensor(32, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model._round(sampling, state, eos, cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def _profile(fn):
    """Wall time of ``fn`` under torch.profiler, the device time of the
    kernels it ran, the idle share, and the top kernels and host ops.  The
    profiler's attention launches must equal the wrappers' counts: a
    session in which they differ (torch.profiler's CUDA activity loses
    whole sessions on some hosts) runs ``fn`` again, so ``fn`` must be
    repeatable, and after PROFILE_ATTEMPTS such sessions this fails.  In a
    rank of a world the ranks decide together, since one rank running ``fn``
    alone would wait on the others' collectives."""
    import torch.distributed as dist

    for _ in range(PROFILE_ATTEMPTS):
        row = _profile_once(fn)
        failed = [row is None]
        if dist.is_available() and dist.is_initialized():
            failed = [None] * dist.get_world_size()
            dist.all_gather_object(failed, row is None)
        if not any(failed):
            return row
    raise AssertionError(f"torch.profiler's attention launches differed from the wrappers' "
                         f"counts in {PROFILE_ATTEMPTS} sessions")


def _profile_once(fn):
    """One session of ``_profile``, or None where the profiler's attention
    launches differ from the wrappers' counts or it recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = _attention_launch_count()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = _attention_launch_count() - before
    stats = prof.key_averages()
    kernels = sorted((e for e in stats if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    # NCCL's kernels wait on the peer inside the kernel: their time is the
    # collectives', reported apart and not counted as busy
    comm = [e for e in kernels if "nccl" in e.key.lower()]
    kernels = [e for e in kernels if e not in comm]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    port = {}  # the port's own kernels: [launches, device ms]
    for e in kernels:
        tag = _kernel_tag(e.key)
        if tag:
            c, ms = port.get(tag, (0, 0.0))
            port[tag] = (c + e.count, ms + e.device_time_total / 1e3)
    host = sorted((e for e in stats if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    # every profiled model has head dim 128: each attention call is one
    # launch of partial_kernel_mma, and combine_kernel never runs.  The
    # launches seen must be those counted, so a profiler that recorded
    # nothing cannot pass for 0 combine launches.
    attention = [port.get(t, (0, 0.0)) for t in ("partial_kernel_mma",
                                                 "partial_kernel_mma_int8")]
    launched = sum(c for c, _ in attention)
    if launched != counted or not kernels:
        return None
    combine = port.get("combine_kernel", (0, 0.0))[0]
    assert combine == 0, f"combine_kernel launched {combine} times on a head dim 128 path"
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "attention_launches": launched,
            "attention_ms": sum(ms for _, ms in attention), "combine_launches": combine,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "nccl_kernel_ms": sum(e.device_time_total for e in comm) / 1e3,
            "kernel_launches": sum(e.count for e in kernels),
            "port_kernels": {k: list(v) for k, v in port.items()},
            "top_kernels_ms": [[e.key[:60], e.count, e.device_time_total / 1e3]
                               for e in kernels[:6]],
            "top_host_self_ms": [[e.key[:40], e.count, e.self_cpu_time_total / 1e3]
                                 for e in host[:6]]}


def phase_full_width_depth(dev):
    """Vicuna-7B at DEPTH_LAYERS of its 32 layers in bfloat16, max_len 2048, SpecConfig()
    (30 tokens, depth 3, top-k 8): a 128-token prompt, 128 new tokens by spec
    and by AR.  Counts the kernel's launches on the main path against the
    expected count; spec/AR agreement is reported, not required (bf16 argmax
    near-ties differ between the batch-30 verify and the batch-1 AR step)."""
    from vispec_tpu_torch.ops import verify_attention as va

    model = _full_width_model(dev, DEPTH_LAYERS, torch.bfloat16, seed=0)
    prompt = np.random.default_rng(0).integers(3, 32000, 128).tolist()
    model.specgenerate(prompt, max_new_tokens=8)  # warm-up: cuBLAS handles, caches
    model.ar_generate(prompt, max_new_tokens=8)
    _decode_round_without_host_sync(model, prompt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    va.verify_attention.launches = 0
    spec = model.specgenerate(prompt, max_new_tokens=128)
    spec_launches = va.verify_attention.launches
    va.verify_attention.launches = 0
    ar = model.ar_generate(prompt, max_new_tokens=128)
    ar_launches = va.verify_attention.launches

    layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
    want_spec = depth + spec.dispatched * (layers + 1 + depth)
    want_ar = ar.dispatched * layers
    a, b = spec.sequences[128:], ar.sequences[128:]
    n = min(len(a), len(b))
    agree = int(np.argmin(np.append(a[:n] == b[:n], False)))
    taus = [x + 1 for x in spec.acceptance_lengths]
    row = {"phase": "full_width_depth", "layers": layers, "dtype": "bfloat16",
           "max_len": model.max_len, "prompt": 128,
           "spec_tokens": spec.new_tokens, "spec_s": spec.decode_time,
           "spec_tok_per_s": spec.new_tokens / spec.decode_time,
           "rounds": spec.rounds, "dispatched_rounds": spec.dispatched,
           "tau": float(np.mean(taus)),
           "ar_tokens": ar.new_tokens, "ar_s": ar.decode_time,
           "ar_tok_per_s": ar.new_tokens / ar.decode_time,
           "agreeing_prefix": agree,
           "launches_spec": spec_launches, "expected_spec": want_spec,
           "launches_ar": ar_launches, "expected_ar": want_ar,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    row["ok"] = (spec_launches == want_spec and ar_launches == want_ar
                 and spec.new_tokens >= 128 and ar.new_tokens >= 128)
    emit(row)
    assert row["ok"], row
    emit({"phase": f"profile_spec_{PROFILE_TOKENS}_tokens",
          **_profile(lambda: model.specgenerate(prompt, max_new_tokens=PROFILE_TOKENS))})
    emit({"phase": f"profile_ar_{PROFILE_TOKENS}_tokens",
          **_profile(lambda: model.ar_generate(prompt, max_new_tokens=PROFILE_TOKENS))})
    return model, prompt, row


def _launch_counts():
    from vispec_tpu_torch.ops import quant
    from vispec_tpu_torch.ops import verify_attention as va

    return {"1a": va.verify_attention.launches, "1b": va.verify_attention.launches_int8,
            "1c": va.verify_attention_batched.launches,
            "1c_int8": va.verify_attention_batched.launches_int8,
            "2": quant.q4_matmul.launches}


def _attention_launch_count():
    """Launches of the attention kernel counted by its wrappers so far."""
    return sum(v for k, v in _launch_counts().items() if k != "2")


def _zero_launch_counts():
    from vispec_tpu_torch.ops import quant
    from vispec_tpu_torch.ops import verify_attention as va

    va.verify_attention.launches = va.verify_attention.launches_int8 = 0
    va.verify_attention_batched.launches = va.verify_attention_batched.launches_int8 = 0
    quant.q4_matmul.launches = 0


def _complete(out, cap, model):
    """A finished request ran to its cap or stopped at EOS."""
    return len(out) == cap or (0 < len(out) < cap and out[-1] == model.eos_token_id)


def _serving_requests(n, seed=0):
    """``n`` requests from ``seed``: prompt lengths in 64-448, caps in 64-128."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(3, 32000, int(rng.integers(64, 449))).tolist(),
             int(rng.integers(64, 129))) for _ in range(n)]


def _warm_engine(model, dev):
    """Warm-up: one admission wave and a chunk at B = 4 (cuBLAS handles for
    the batched shapes), then one batched round with CUDA's sync debug mode
    set to error: the round must not wait on the device."""
    from vispec_tpu_torch.spec import batch

    eng = model.serving_engine(batch_size=4, pad_bucket=(128, 256, 512), chunk_rounds=2)
    eng.start_session()
    for p, _ in _serving_requests(4, seed=1):
        eng.submit(p, max_new_tokens=16)
    eng.step()
    eos = torch.tensor(model.eos_token_id, dtype=torch.int32, device=dev)
    caps = torch.as_tensor(eng._caps, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            batch.batched_decode_rounds_chunk(
                model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec,
                eng.sampling, eng._states, eos, caps, n_rounds=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del eng
    torch.cuda.empty_cache()


def _serve(model, reqs, pad_bucket=(128, 256, 512), **kw):
    """Serve ``reqs`` (prompt or request dict, cap) through a fresh engine
    at B = 4; returns the engine, its outputs in order, each request's
    latency from submission (all submitted at once) and the wall time."""
    eng = model.serving_engine(batch_size=4, pad_bucket=pad_bucket, **kw)
    eng.start_session()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=c) for p, c in reqs]
    latency = {}
    while eng.pending():
        for rid in eng.step():
            latency[rid] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    return eng, [eng.results[r] for r in rids], [latency[r] for r in rids], wall


def _profile_engine_chunk(model, batch_size):
    """torch.profiler over one engine step (a full chunk of
    PROFILE_CHUNK_ROUNDS rounds and its readback) after the admission step;
    launches per round."""
    eng = model.serving_engine(batch_size=batch_size, pad_bucket=(128, 256, 512),
                               chunk_rounds=PROFILE_CHUNK_ROUNDS)
    eng.start_session()
    for p, _ in _serving_requests(batch_size, seed=2):
        eng.submit(p, max_new_tokens=64)
    eng.step()
    steps = []  # rounds of each profiled step (a session may be run again)

    def step():
        before = eng.stats["rounds"]
        eng.step()
        steps.append(eng.stats["rounds"] - before)

    row = _profile(step)
    rounds = steps[-1]
    del eng
    torch.cuda.empty_cache()
    return {"batch_size": batch_size, "rounds": rounds,
            "launches_per_round": row["kernel_launches"] / rounds, **row}


def phase_serving_full_depth(dev, model):
    """The continuous-batching engine at Vicuna-7B, DEPTH_LAYERS layers, bfloat16,
    max_len 2048: ``ServingEngine(batch_size=4, pad_bucket=(128, 256, 512),
    chunk_rounds=8)`` serves 8 requests from seed 0 (prompts of 64-448
    tokens, caps of 64-128), so slots free and refill mid-flight.  The first
    ``SERIAL_REQUESTS`` of them through ``specgenerate`` one at a time give
    the serial rate and the agreeing prefix per request (reported: bf16
    argmax near-ties may differ between batch shapes).  Requires the batched-grid kernel (1c)
    launched layers + 4 times per dispatched round (the target verifies, 1
    draft append, 3 expansion levels) and the single-request kernel (1a) 3 times
    per prefill (its first tree's expansion)."""
    _warm_engine(model, dev)
    reqs = _serving_requests(8)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    eng, outs, latency, wall = _serve(model, reqs, chunk_rounds=8)
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rounds, prefills, stats = eng.stats["rounds"], eng._n_prefills, dict(eng.stats)
    tokens = sum(len(o) for o in outs)
    del eng
    torch.cuda.empty_cache()

    # the serial rate from the first SERIAL_REQUESTS requests (all 8 until
    # the training and eval phases needed the time)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [model.specgenerate(p, max_new_tokens=c).sequences[len(p):]
              for p, c in reqs[:SERIAL_REQUESTS]]
    serial_s = time.perf_counter() - t0
    serial_tokens = sum(len(o) for o in serial)
    agree = []
    for o, r in zip(outs, serial):
        n = min(len(o), len(r))
        agree.append(int(np.argmin(np.append(o[:n] == r[:n], False))))
    layers = model.tcfg.num_hidden_layers
    want = {"1a": 3 * prefills, "1b": 0, "1c": (layers + 4) * rounds, "1c_int8": 0, "2": 0}
    row = {"phase": "serving_full_depth", "layers": layers, "dtype": "bfloat16",
           "max_len": model.max_len, "batch_size": 4, "requests": len(reqs),
           "prompt_lens": [len(p) for p, _ in reqs], "caps": [c for _, c in reqs],
           "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "latency_p50_s": float(np.median(latency)), "latency_max_s": max(latency),
           "rounds_dispatched": rounds, "prefills": prefills,
           "admissions": stats["admissions"], "admit_dispatch_s": stats["admit_dispatch_s"],
           "peak_mem_gb": peak, "serial_tokens": serial_tokens, "serial_s": serial_s,
           "serial_tok_per_s": serial_tokens / serial_s,
           "ratio_vs_serial": (tokens / wall) / (serial_tokens / serial_s),
           "agreeing_prefix": agree, "launches": counts, "expected": want}
    row["ok"] = counts == want and all(_complete(o, c, model) for o, (_, c) in zip(outs, reqs))
    emit(row)
    assert row["ok"], row
    single = _profile_engine_chunk(model, 1)
    batched = _profile_engine_chunk(model, 4)
    emit({"phase": "profile_serving_chunk", "b4": batched, "b1": single,
          "launches_per_round_ratio": batched["launches_per_round"]
          / single["launches_per_round"]})
    return row


def phase_serving_quant_full_depth(dev, qmodel):
    """The engine over the quantized 7B model (int8 KV cache, int4 draft,
    int8 target): 4 requests of 64 tokens at B = 4.  Requires, per
    dispatched round, 32 launches of 1c over the int8 target cache, 4 over
    the bf16 draft cache and 40 int4 products (kernel 2: the draft's
    products take the B * K rows of all slots at once); per prefill, 3 of
    1a and 31 of kernel 2, as in the single-request mode.  Then
    torch.profiler over one chunk of PROFILE_CHUNK_ROUNDS rounds at B = 4
    (``profile_serving_quant_chunk``), per round: kernel 2's launches and
    device ms, those of the int8-cache attention, of every attention call
    (one launch of ``partial_kernel_mma`` each, over the int8 target cache
    and the bf16 draft cache), and of ``combine_kernel`` (0 at head dim
    128)."""
    from vispec_tpu_torch.ops import quant

    _warm_engine(qmodel, dev)
    reqs = [(p, 64) for p, _ in _serving_requests(4, seed=3)]
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    eng, outs, latency, wall = _serve(qmodel, reqs, chunk_rounds=8)
    counts = _launch_counts()
    rounds, prefills = eng.stats["rounds"], eng._n_prefills
    depth = qmodel.spec.depth
    per_level = 2 + len(quant._LAYER_QUANT_KEYS) + 1
    per_round = 2 + len(quant._LAYER_QUANT_KEYS) + 1 + depth * per_level
    want = {"1a": 3 * prefills, "1b": 0, "1c": (1 + depth) * rounds,
            "1c_int8": qmodel.tcfg.num_hidden_layers * rounds,
            "2": per_round * rounds + (1 + depth * per_level) * prefills}
    tokens = sum(len(o) for o in outs)
    row = {"phase": "serving_quant_full_depth", "layers": qmodel.tcfg.num_hidden_layers,
           "dtype": "bfloat16",
           "kv": "int8", "draft": "int4", "target": "int8", "batch_size": 4,
           "requests": len(reqs), "prompt_lens": [len(p) for p, _ in reqs],
           "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
           "latency_p50_s": float(np.median(latency)), "latency_max_s": max(latency),
           "rounds_dispatched": rounds, "prefills": prefills,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
           "launches": counts, "expected": want}
    row["ok"] = counts == want and all(_complete(o, 64, qmodel) for o in outs)
    emit(row)
    assert row["ok"], row
    del eng
    torch.cuda.empty_cache()
    chunk = _profile_engine_chunk(qmodel, 4)
    rounds = chunk["rounds"]

    def per_round(tag):
        calls, ms = chunk["port_kernels"].get(tag, (0, 0.0))
        return calls / rounds, ms / rounds

    q4_calls, q4_ms = per_round("q4_mma_kernel")
    int8_calls, int8_ms = per_round("partial_kernel_mma_int8")
    bf16_calls, bf16_ms = per_round("partial_kernel_mma")
    combine_calls, combine_ms = per_round("combine_kernel")
    emit({"phase": "profile_serving_quant_chunk", **chunk,
          "q4_launches_per_round": q4_calls, "q4_ms_per_round": q4_ms,
          "int8_attention_launches_per_round": int8_calls,
          "int8_attention_ms_per_round": int8_ms,
          "attention_launches_per_round": int8_calls + bf16_calls,
          "attention_ms_per_round": int8_ms + bf16_ms,
          "attention_combine_launches_per_round": combine_calls,
          "attention_combine_ms_per_round": combine_ms,
          "device_busy_ms_per_round": chunk["device_busy_ms"] / rounds})
    return counts


def phase_quant_full_depth(dev, model, prompt, bf16_row):
    """The quantized serving mode at DEPTH_LAYERS layers in bfloat16: the previous
    phase's model, its draft quantized to int4 (with an int4 ranking head)
    and then its target to int8 in place, over an int8 KV cache.  Same
    prompt and budgets.  Counts each kernel's launches on this path against
    the count the code gives: per spec round, an int8-KV verify a layer, 4 draft
    attentions over the bf16 draft cache (1 append + 3 expansion levels)
    and 40 int4 products (append: 2 fuse + 7 layer; expansion: 1 root
    ranking + 3 x (2 fuse + 7 layer + 1 ranking)); at prefill, 3 draft
    attentions and 31 int4 products (the prefill's 128-row draft layer
    takes the dequantize path); per AR step, 32 int8-KV verifies."""
    from vispec_tpu_torch.ops import quant
    from vispec_tpu_torch.spec.spec_model import SpecModel

    draft = {k: v for k, v in model.dparams.items() if k not in ("fuse_we", "fuse_wh")}
    model.target_cache = None  # the bf16 caches are freed
    model.draft_cache = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = SpecModel(model.tcfg, model.dcfg, model.spec, model.tparams, draft,
                       max_len=model.max_len, dtype=torch.bfloat16, device=dev,
                       quantize_kv=True, quantize_draft="int4")
    qmodel.quantize_target_inplace()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    qmodel.specgenerate(prompt, max_new_tokens=8)  # warm-up
    qmodel.ar_generate(prompt, max_new_tokens=8)
    _decode_round_without_host_sync(qmodel, prompt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def counts():
        return {k: v for k, v in _launch_counts().items() if k in ("1a", "1b", "2")}

    _zero_launch_counts()
    spec = qmodel.specgenerate(prompt, max_new_tokens=128)
    spec_counts = counts()
    _zero_launch_counts()
    ar = qmodel.ar_generate(prompt, max_new_tokens=128)
    ar_counts = counts()

    layers, depth, n = qmodel.tcfg.num_hidden_layers, qmodel.spec.depth, spec.dispatched
    per_level = 2 + len(quant._LAYER_QUANT_KEYS) + 1
    want_spec = {"1a": depth + n * (1 + depth), "1b": n * layers,
                 "2": (1 + depth * per_level) + n * (2 + len(quant._LAYER_QUANT_KEYS)
                                                     + 1 + depth * per_level)}
    want_ar = {"1a": 0, "1b": ar.dispatched * layers, "2": 0}
    a, b = spec.sequences[128:], ar.sequences[128:]
    m = min(len(a), len(b))
    agree = int(np.argmin(np.append(a[:m] == b[:m], False)))
    taus = [x + 1 for x in spec.acceptance_lengths]
    row = {"phase": "quant_full_depth", "layers": layers, "dtype": "bfloat16",
           "kv": "int8", "draft": "int4", "target": "int8", "max_len": qmodel.max_len,
           "prompt": 128, "quantize_s": quantize_s,
           "spec_tokens": spec.new_tokens, "spec_s": spec.decode_time,
           "spec_tok_per_s": spec.new_tokens / spec.decode_time,
           "rounds": spec.rounds, "dispatched_rounds": n, "tau": float(np.mean(taus)),
           "ar_tokens": ar.new_tokens, "ar_s": ar.decode_time,
           "ar_tok_per_s": ar.new_tokens / ar.decode_time,
           "bf16_spec_tok_per_s": bf16_row["spec_tok_per_s"],
           "bf16_ar_tok_per_s": bf16_row["ar_tok_per_s"],
           "agreeing_prefix": agree,
           "launches_spec": spec_counts, "expected_spec": want_spec,
           "launches_ar": ar_counts, "expected_ar": want_ar,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
           "bf16_peak_mem_gb": bf16_row["peak_mem_gb"]}
    row["ok"] = (spec_counts == want_spec and ar_counts == want_ar
                 and spec.new_tokens >= 128 and ar.new_tokens >= 128)
    emit(row)
    assert row["ok"], row
    emit({"phase": f"profile_quant_spec_{PROFILE_TOKENS}_tokens",
          **_profile(lambda: qmodel.specgenerate(prompt, max_new_tokens=PROFILE_TOKENS))})
    return spec_counts, qmodel


# ---------------------------------------------------------------------------
# LLaVA-1.5 / 1.6 image prompts
# ---------------------------------------------------------------------------

LLAVA_VOCAB = 32064  # llava-hf/llava-1.5-7b-hf, llava-v1.6-vicuna-7b-hf text vocab


def _llava_models(dev, layers, dtype, seed, max_len=4096):
    """LLaVA-1.6 (anyres) and LLaVA-1.5 SpecModels on one set of random
    weights from ``seed``: openai/clip-vit-large-patch14-336 (24 layers,
    feature layer -2), the projector 1024 -> 4096 -> 4096, Vicuna-7B widths
    at ``layers`` layers with the LLaVA text vocab 32064 (image token 32000)
    and 8192 positions (the JAX package's LLaVA setting), the ViSpec draft at
    ``DraftConfig()`` widths over the same vocab, ``SpecConfig()``."""
    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.models import clip_vit, draft, llama, llava
    from vispec_tpu_torch.spec.spec_model import SpecModel

    tcfg = LlamaConfig(vocab_size=LLAVA_VOCAB, max_position_embeddings=8192,
                       num_hidden_layers=layers)
    dcfg = DraftConfig(vocab_size=LLAVA_VOCAB)
    vcfg = clip_vit.ClipVisionConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    tparams = llama.init_params(tcfg, g, dev, dtype)
    dparams = draft.init_params(dcfg, g, dev, dtype)
    dparams["embed"] = tparams["embed"]
    vparams = {"vision": clip_vit.init_params(vcfg, g, dev, dtype),
               **llava.init_projector_params(g, vcfg.hidden_size, tcfg.hidden_size, dev,
                                             dtype)}
    out = {}
    for name, anyres in (("llava-1.6", True), ("llava-1.5", False)):
        cfg = llava.LlavaConfig(text=tcfg, vision=vcfg, anyres=anyres)
        out[name] = SpecModel(tcfg, dcfg, SpecConfig(), tparams, dparams, max_len=max_len,
                              dtype=dtype, device=dev, llava_cfg=cfg, vparams=vparams,
                              image_token_index=cfg.image_token_index)
    return out


def _image_request(model, size, seed):
    """16 text ids, the image's placeholders, 12 text ids; the image's
    pixels in [0, 1] from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = (rng.integers(3, 32000, 16).tolist()
           + [model.image_token_index] * model.count_image_tokens(size)
           + rng.integers(3, 32000, 12).tolist())
    return {"input_ids": ids, "image_size": size,
            "pixel_values": rng.uniform(0, 1, (*size, 3)).astype(np.float32)}


def _median_cuda_ms(fn, n=10):
    """(fn's last result, the median and the range of ``n`` times of one
    call in ms, each from CUDA events around a call issued on an idle
    device, so the host's issue is inside it), after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, float(np.median(times)), [min(times), max(times)]


def phase_vision_tower_device(dev):
    """``encode_image`` on the card against the same function on the CPU:
    CLIP-L widths (1024, 16 heads, 336 px) at 2 tower layers, the projector
    to 4096, one 480x640 image through the anyres path (resize, pad, five
    tiles in one tower call, packing), float32 with TF32 off.  Limit 1e-4
    of the output's largest magnitude."""
    from vispec_tpu_torch.configs import LlamaConfig
    from vispec_tpu_torch.models import clip_vit, llava

    vcfg = clip_vit.ClipVisionConfig(num_hidden_layers=2)
    cfg = llava.LlavaConfig(text=LlamaConfig(vocab_size=LLAVA_VOCAB), vision=vcfg)
    g = torch.Generator().manual_seed(11)
    cpu_params = {"vision": clip_vit.init_params(vcfg, g, "cpu", torch.float32),
                  **llava.init_projector_params(g, vcfg.hidden_size, cfg.text.hidden_size,
                                                "cpu", torch.float32)}

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    gpu_params = to_dev(cpu_params)
    img = np.random.default_rng(11).uniform(0, 1, (480, 640, 3)).astype(np.float32)
    plan = llava.plan_anyres(480, 640, cfg)

    def encode(params, device):
        pixels = torch.as_tensor(img, device=device)
        return llava.encode_image(params, cfg, llava.preprocess_anyres(pixels, plan, cfg),
                                  plan)

    t0 = time.perf_counter()
    want = encode(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0
    got, ms, ms_range = _median_cuda_ms(lambda: encode(gpu_params, dev))
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    row = {"phase": "vision_tower_device", "tower_layers": 2, "dtype": "float32",
           "image": [480, 640], "tiles": 1 + plan.grid_h * plan.grid_w,
           "image_tokens": plan.n_tokens, "shape": list(got.shape),
           "rel_max_abs_err": err, "limit": 1e-4, "device_ms": ms,
           "device_ms_range": ms_range, "cpu_s": cpu_s,
           "ok": err <= 1e-4 and tuple(got.shape) == (plan.n_tokens, cfg.text.hidden_size)}
    emit(row)
    assert row["ok"], row


def phase_llava_exact(dev):
    """LLaVA at full widths in float32 with TF32 off: CLIP-L with all 24
    layers, the projector, Vicuna-7B widths at 2 target layers, vocab
    32064, max_len 4096.  Greedy spec == AR for 64 new tokens with one
    480x640 image (LLaVA-1.6 anyres, 2,340 image tokens) and with one
    336x336 image (LLaVA-1.5, 576); then ``specgenerate_batch`` over [the
    480x640 request, a text request, a 336x336 image request] on the 1.6
    model equals ``specgenerate`` per request."""
    models = _llava_models(dev, 2, torch.float32, seed=5)
    for name, size in (("llava-1.6", (480, 640)), ("llava-1.5", (336, 336))):
        model = models[name]
        req = _image_request(model, size, seed=5)
        ids, n = req["input_ids"], len(req["input_ids"])
        spec = model.specgenerate(ids, max_new_tokens=64, pixel_values=req["pixel_values"],
                                  image_size=size)
        ar = model.ar_generate(ids, max_new_tokens=64, pixel_values=req["pixel_values"],
                               image_size=size)
        same = spec.sequences[:n + 64].tolist() == ar.sequences[:n + 64].tolist()
        row = {"phase": "llava_exact", "model": name, "layers": 2, "tower_layers": 24,
               "dtype": "float32", "max_len": model.max_len, "image": list(size),
               "image_tokens": model.count_image_tokens(size), "prompt": n,
               "new_tokens": [spec.new_tokens, ar.new_tokens], "rounds": spec.rounds,
               "ok": same and spec.new_tokens >= 64}
        emit(row)
        assert row["ok"], f"llava_exact ({name}): spec != AR"
        model.target_cache = model.draft_cache = None
    model = models["llava-1.6"]
    reqs = [_image_request(model, (480, 640), seed=5),
            {"input_ids": np.random.default_rng(6).integers(3, 32000, 90).tolist()},
            _image_request(model, (336, 336), seed=7)]
    outs = model.specgenerate_batch(reqs, max_new_tokens=48)
    same = []
    for r, o in zip(reqs, outs):
        ref = model.specgenerate(r["input_ids"], max_new_tokens=48,
                                 pixel_values=r.get("pixel_values"),
                                 image_size=r.get("image_size"))
        n = len(r["input_ids"])
        same.append(o.new_tokens == 48
                    and o.sequences.tolist() == ref.sequences[:n + 48].tolist())
    row = {"phase": "llava_exact", "model": "llava-1.6", "batch": len(reqs),
           "prompts": [len(r["input_ids"]) for r in reqs], "new_tokens": 48,
           "per_request_equal": same, "ok": all(same)}
    emit(row)
    assert row["ok"], "llava_exact: specgenerate_batch != per-request"
    del models, model
    torch.cuda.empty_cache()


def phase_llava_full_depth(dev, models):
    """LLaVA-1.5 (one 336x336 image, 576 image tokens) and LLaVA-1.6 (one
    480x640 image, 2,340 tokens; one 672x672 image, 2,928) at DEPTH_LAYERS layers
    in bfloat16, max_len 4096, IMAGE_DEPTH_TOKENS new tokens by spec and by
    AR.  Per image: the vision encode and the prefill (merge, plan, target
    and draft prefill, first tree), each the median (and range) of
    IMAGE_TIMED_CALLS calls timed by
    CUDA events after a warm-up, decode tok/s, kernel 1a's launches against
    the text path's count (layers + 4 per dispatched round, 3 at prefill; layers per AR
    step) and peak memory; then the encode and the prefill under
    torch.profiler (``profile_llava_encode``, ``profile_llava_prefill``:
    device-busy ms and the idle share of one call).
    spec/AR agreement is reported, not required (bf16)."""
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.spec import loop
    from vispec_tpu_torch.spec.spec_model import output_rows, plan_prompt, _bucket

    rows = []
    for seed, (name, size) in enumerate((("llava-1.5", (336, 336)), ("llava-1.6", (480, 640)),
                                         ("llava-1.6", (672, 672)))):
        model = models[name]
        req = _image_request(model, size, seed=20 + seed)
        ids, n = req["input_ids"], len(req["input_ids"])
        pixels = torch.as_tensor(req["pixel_values"], device=dev)
        pad = _bucket(n)

        def prefill():
            prompt = model._padded_prompt(ids, pad, pixels, size)
            plan, span = plan_prompt(model.dcfg, prompt.shifted, prompt.n_spans, n, pad, dev)
            return loop.spec_prefill(
                model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, plan,
                loop.SamplingParams(), prompt.embeds, kv.reset(model.target_cache),
                kv.reset(model.draft_cache), output_rows(model.spec, 128), span)

        def encode():
            return model._encode_image(pixels, size)

        with torch.no_grad():
            _, encode_ms, encode_range = _median_cuda_ms(encode, IMAGE_TIMED_CALLS)
            _, prefill_ms, prefill_range = _median_cuda_ms(prefill, IMAGE_TIMED_CALLS)
        model.specgenerate(ids, max_new_tokens=8, pixel_values=pixels, image_size=size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launch_counts()
        spec = model.specgenerate(ids, max_new_tokens=IMAGE_DEPTH_TOKENS, pixel_values=pixels,
                                  image_size=size)
        spec_launches = va.verify_attention.launches
        _zero_launch_counts()
        ar = model.ar_generate(ids, max_new_tokens=IMAGE_DEPTH_TOKENS, pixel_values=pixels,
                               image_size=size)
        ar_launches = va.verify_attention.launches
        layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
        want_spec = depth + spec.dispatched * (layers + 1 + depth)
        want_ar = ar.dispatched * layers
        a, b = spec.sequences[n:], ar.sequences[n:]
        m = min(len(a), len(b))
        row = {"phase": "llava_full_depth", "model": name,
               "layers": layers, "tower_layers": 24, "dtype": "bfloat16",
               "max_len": model.max_len, "image": list(size),
               "image_tokens": model.count_image_tokens(size), "prompt": n,
               "pad_len": pad, "vision_encode_ms": encode_ms,
               "vision_encode_ms_range": encode_range, "prefill_ms": prefill_ms,
               "prefill_ms_range": prefill_range,
               "spec_tokens": spec.new_tokens, "spec_s": spec.decode_time,
               "spec_tok_per_s": spec.new_tokens / spec.decode_time,
               "rounds": spec.rounds, "dispatched_rounds": spec.dispatched,
               "ar_tokens": ar.new_tokens, "ar_s": ar.decode_time,
               "ar_tok_per_s": ar.new_tokens / ar.decode_time,
               "agreeing_prefix": int(np.argmin(np.append(a[:m] == b[:m], False))),
               "launches_1a_spec": spec_launches, "expected_spec": want_spec,
               "launches_1a_per_round": (spec_launches - depth) / spec.dispatched,
               "launches_ar": ar_launches, "expected_ar": want_ar,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
        row["ok"] = (spec_launches == want_spec and ar_launches == want_ar
                     and spec.new_tokens >= IMAGE_DEPTH_TOKENS
                     and ar.new_tokens >= IMAGE_DEPTH_TOKENS)
        emit(row)
        assert row["ok"], row
        rows.append(row)
        with torch.no_grad():
            emit({"phase": "profile_llava_encode", "image": list(size),
                  "image_tokens": row["image_tokens"], **_profile(encode)})
            emit({"phase": "profile_llava_prefill", "image_tokens": row["image_tokens"],
                  "pad_len": pad, **_profile(prefill)})
        model.target_cache = model.draft_cache = None
        torch.cuda.empty_cache()
    return rows


def phase_serving_vision_full_depth(dev, model):
    """The engine over the DEPTH_LAYERS-layer bfloat16 LLaVA-1.5 model: B = 4,
    ``max_span=576`` (one 336x336 image's span), pad buckets (128, 256, 512,
    768), 8 requests of which 4 carry a 336x336 image (cap 64) and 4 are
    text (seed 0: prompts of 64-448, caps of 64-128).  All complete;
    requires 36 launches of 1c per dispatched round and 3 of 1a per
    prefill, as on the text path."""
    reqs = []
    for i, (p, c) in enumerate(_serving_requests(4)):
        reqs.append((_image_request(model, (336, 336), seed=40 + i), 64))
        reqs.append((p, c))
    kw = dict(pad_bucket=(128, 256, 512, 768), chunk_rounds=8, max_span=576)
    warm = model.serving_engine(batch_size=4, **kw)
    warm.run_all([{**reqs[0][0], "max_new_tokens": 4}])  # warm-up: an image admission
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    eng, outs, latency, wall = _serve(model, reqs, **kw)
    counts = _launch_counts()
    rounds, prefills = eng.stats["rounds"], eng._n_prefills
    depth = model.spec.depth
    want = {"1a": depth * prefills, "1b": 0,
            "1c": (model.tcfg.num_hidden_layers + 1 + depth) * rounds, "1c_int8": 0, "2": 0}
    tokens = sum(len(o) for o in outs)
    row = {"phase": "serving_vision_full_depth", "model": "llava-1.5",
           "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16", "max_len": model.max_len, "batch_size": 4,
           "max_span": 576, "requests": len(reqs),
           "image_requests": sum(isinstance(r, dict) for r, _ in reqs),
           "prompt_lens": [len(r["input_ids"] if isinstance(r, dict) else r)
                           for r, _ in reqs],
           "caps": [c for _, c in reqs], "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall, "latency_p50_s": float(np.median(latency)),
           "latency_max_s": max(latency), "rounds_dispatched": rounds,
           "prefills": prefills, "admissions": eng.stats["admissions"],
           "admit_dispatch_s": eng.stats["admit_dispatch_s"],
           "launches": counts, "expected": want,
           "launches_1c_per_round": counts["1c"] / rounds, "errors": dict(eng.errors),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    row["ok"] = (counts == want and not eng.errors
                 and all(_complete(o, c, model) for o, (_, c) in zip(outs, reqs)))
    emit(row)
    assert row["ok"], row
    del eng
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Qwen2.5-VL image and video prompts
# ---------------------------------------------------------------------------

# Qwen/Qwen2.5-VL-7B-Instruct's config.json: text vocab, token ids
QWEN_VOCAB = 152064
QWEN_IMAGE, QWEN_VIDEO, QWEN_VSTART, QWEN_EOS = 151655, 151656, 151652, 151645


def _qwen_model(dev, layers, dtype, seed, **quant):
    """A Qwen2.5-VL-7B-Instruct SpecModel at ``layers`` target layers with
    random weights from ``seed``: the published text widths (hidden 3,584,
    intermediate 18,944, 28 heads over 4 KV heads, head_dim 128, vocab
    152,064, untied lm_head, rope_theta 1e6, RMS eps 1e-6, qkv bias,
    ``mrope_section`` (16, 24, 24)), 4,096 positions as the JAX package
    forces for Qwen (max_len 4096); the published vision tower
    (``QwenVisionConfig()``: 32 blocks, hidden 1,280, 16 heads, window 112,
    full attention at 7, 15, 23, 31, merger to 3,584); the ViSpec draft of
    vispec_tpu/train/configs/qwen2.5_vl_7B_config.json (28 heads over 28 KV
    heads, qkv and fc bias, 8,192 positions); ``SpecConfig()``."""
    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.models import draft, llama
    from vispec_tpu_torch.models import qwen2_5_vl as qwen_vl
    from vispec_tpu_torch.spec.spec_model import SpecModel

    tcfg = LlamaConfig(vocab_size=QWEN_VOCAB, hidden_size=3584, intermediate_size=18944,
                       num_hidden_layers=layers, num_attention_heads=28,
                       num_key_value_heads=4, max_position_embeddings=4096,
                       rms_norm_eps=1e-6, rope_theta=1e6, qkv_bias=True,
                       mrope_section=(16, 24, 24))
    dcfg = DraftConfig(vocab_size=QWEN_VOCAB, hidden_size=3584, intermediate_size=18944,
                       num_attention_heads=28, num_key_value_heads=28,
                       max_position_embeddings=8192, rope_theta=1e6, qkv_bias=True,
                       fc_bias=True)
    vcfg = qwen_vl.QwenVisionConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    tparams = llama.init_params(tcfg, g, dev, dtype)
    dparams = draft.init_params(dcfg, g, dev, dtype)
    dparams["embed"] = tparams["embed"]
    vparams = qwen_vl.init_params(g, vcfg, dev, dtype)
    return SpecModel(tcfg, dcfg, SpecConfig(), tparams, dparams, max_len=4096, dtype=dtype,
                     device=dev, eos_token_id=QWEN_EOS, qwen_cfg=vcfg, vparams=vparams,
                     image_token_index=QWEN_IMAGE, video_token_index=QWEN_VIDEO,
                     vision_start_token_id=QWEN_VSTART, **quant)


def _qwen_request(model, seed, images=(), video=None):
    """32 text ids, each image (a (height, width)) or the video (frames,
    height, width) as <vision_start> and its placeholders with 8 text ids
    between two images, then 31 text ids; pixels in [0, 1] from ``seed``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 150000, 32).tolist()
    req = {}
    if video is not None:
        t, h, w = video
        ids += [QWEN_VSTART] + [QWEN_VIDEO] * model.count_video_tokens(t, (h, w))
        req["pixel_values_videos"] = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    for i, size in enumerate(images):
        if i:
            ids += rng.integers(3, 150000, 8).tolist()
        ids += [QWEN_VSTART] + [QWEN_IMAGE] * model.count_image_tokens(size)
    if images:
        pixels = [rng.uniform(0, 1, (*s, 3)).astype(np.float32) for s in images]
        req.update(pixel_values=pixels if len(images) > 1 else pixels[0],
                   image_size=list(images) if len(images) > 1 else images[0])
    return {"input_ids": ids + rng.integers(3, 150000, 31).tolist(), **req}


def _vision_kw(req):
    return {k: v for k, v in req.items() if k != "input_ids"}


def phase_qwen_vision_tower_device(dev):
    """The Qwen2.5-VL tower on the card against the CPU: the published
    widths (1,280, 16 heads, window 112, merger to 3,584) at 2 blocks, the
    first windowed and the second full (``fullatt_block_indexes=(1,)``); a
    500x420 image resized to 504x420 (bicubic), patchified (36 x 30 patches,
    ragged 4x4-unit windows), planned and encoded, float32 with TF32 off.
    Limit 1e-4 of the output's largest magnitude."""
    from vispec_tpu_torch.models import llava
    from vispec_tpu_torch.models import qwen2_5_vl as qwen_vl

    vcfg = qwen_vl.QwenVisionConfig(depth=2, fullatt_block_indexes=(1,))
    cpu_params = qwen_vl.init_params(torch.Generator().manual_seed(12), vcfg, "cpu",
                                     torch.float32)

    def to_dev(tree):
        return {k: to_dev(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    gpu_params = to_dev(cpu_params)
    img = np.random.default_rng(12).uniform(0, 1, (500, 420, 3)).astype(np.float32)
    rh, rw = qwen_vl.smart_resize(500, 420, min_pixels=256 * 28 * 28,
                                  max_pixels=1280 * 28 * 28)
    grid = [(1, rh // vcfg.patch_size, rw // vcfg.patch_size)]
    n = grid[0][1] * grid[0][2]
    pad = -(-n // 64) * 64
    plan = qwen_vl.plan_vision(grid, vcfg, pad)

    def encode(params, device):
        pixels = llava.resize_image(torch.as_tensor(img, device=device), rh, rw)
        patches = qwen_vl.patchify_image(pixels, vcfg)
        patches = torch.cat([patches, patches.new_zeros((pad - n, patches.shape[1]))])
        return qwen_vl.forward(params, vcfg, patches, plan)[:plan.n_merged]

    t0 = time.perf_counter()
    want = encode(cpu_params, "cpu")
    cpu_s = time.perf_counter() - t0
    got, ms, ms_range = _median_cuda_ms(lambda: encode(gpu_params, dev))
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    row = {"phase": "qwen_vision_tower_device", "tower_blocks": 2, "full_attention": [1],
           "dtype": "float32", "image": [500, 420], "resized": [rh, rw], "patches": n,
           "windows": int(plan.win_seg.max()) + 1, "merged_tokens": plan.n_merged,
           "shape": list(got.shape), "rel_max_abs_err": err, "limit": 1e-4,
           "device_ms": ms, "device_ms_range": ms_range, "cpu_s": cpu_s,
           "ok": err <= 1e-4 and tuple(got.shape) == (plan.n_merged, vcfg.out_hidden_size)}
    emit(row)
    assert row["ok"], row


def _recording_q4_dispatch():
    """Record the (K, N, M) of every product that the int4 dispatch rule
    sends to kernel 2, without touching the wrapper or its count.  Returns
    (the set, a function that restores the rule)."""
    from vispec_tpu_torch.ops import quant

    rule, shapes = quant._q4_supports_kernel, set()

    def recording(m, w):
        takes = rule(m, w)
        if takes:
            shapes.add((2 * w.packed.shape[0], w.packed.shape[1], int(m)))
        return takes

    quant._q4_supports_kernel = recording
    return shapes, lambda: setattr(quant, "_q4_supports_kernel", rule)


def phase_qwen_exact(dev):
    """Qwen2.5-VL-7B widths in float32 with TF32 off, 2 target layers, the
    full 32-block tower, max_len 4096.  Greedy spec == AR for 64 new tokens
    with one 448x448 image (256 image tokens), two images (448x448 and
    364x532, resized to 392x560: 256 + 280) and an 8-frame 336x448 video
    at 0.5 s per frame pair (4 x 192 = 768 video tokens, M-RoPE time step
    1); then
    ``specgenerate_batch`` over [the one-image request, a text request, the
    video request] == per request, the engine (B = 2) over [two image and
    two text requests] == per request; last the quantized mode (int8 KV,
    int4 draft, int8 target: 1b, and kernel 2 at K = 3,584) spec == AR with
    the one image, and kernel 2 held against its plain version at every
    (K, N, M) that run gave it (returned as rows)."""
    model = _qwen_model(dev, 2, torch.float32, seed=6)
    cases = {"one_image": _qwen_request(model, 60, images=[(448, 448)]),
             "two_images": _qwen_request(model, 61, images=[(448, 448), (364, 532)]),
             "video": {**_qwen_request(model, 62, video=(8, 336, 448)),
                       "second_per_grid_ts": 0.5}}
    for name, req in cases.items():
        ids, n = req["input_ids"], len(req["input_ids"])
        spec = model.specgenerate(ids, max_new_tokens=64, **_vision_kw(req))
        ar = model.ar_generate(ids, max_new_tokens=64, **_vision_kw(req))
        same = spec.sequences[:n + 64].tolist() == ar.sequences[:n + 64].tolist()
        row = {"phase": "qwen_exact", "case": name, "layers": 2,
               "tower_blocks": model.qwen_cfg.depth,
               "dtype": "float32", "max_len": model.max_len, "prompt": n,
               "vision_tokens": sum(t in (QWEN_IMAGE, QWEN_VIDEO) for t in ids),
               "rope_delta": model._padded_prompt(ids, 128 * -(-n // 128),
                                                  **_vision_kw(req)).rope.delta,
               "new_tokens": [spec.new_tokens, ar.new_tokens], "rounds": spec.rounds,
               "ok": same and spec.new_tokens >= 64}
        emit(row)
        assert row["ok"], f"qwen_exact ({name}): spec != AR"
    text = {"input_ids": np.random.default_rng(63).integers(3, 150000, 90).tolist()}
    for label, reqs in (("specgenerate_batch", [cases["one_image"], text, cases["video"]]),
                        ("engine_b2", [cases["one_image"], text, cases["two_images"],
                                       {"input_ids": text["input_ids"][:50]}])):
        refs = [model.specgenerate(r["input_ids"], max_new_tokens=48, **_vision_kw(r))
                .sequences[len(r["input_ids"]):len(r["input_ids"]) + 48].tolist()
                for r in reqs]
        if label == "specgenerate_batch":
            got = model.specgenerate_batch(reqs, max_new_tokens=48)
            outs = [o.sequences[len(r["input_ids"]):].tolist() for r, o in zip(reqs, got)]
            errors = {}
        else:
            eng = model.serving_engine(batch_size=2, max_new_tokens=48, chunk_rounds=4,
                                       pad_bucket=(128, 640), max_span=640)
            outs = [o.tolist() for o in eng.run_all(reqs)]
            errors = dict(eng.errors)
            del eng
        same = [o == r and len(o) == 48 for o, r in zip(outs, refs)]
        row = {"phase": "qwen_exact", "case": label, "layers": 2,
               "prompts": [len(r["input_ids"]) for r in reqs], "new_tokens": 48,
               "per_request_equal": same, "errors": errors, "ok": all(same) and not errors}
        emit(row)
        assert row["ok"], f"qwen_exact: {label} != per-request"
    model.target_cache = model.draft_cache = None
    model._batch_pool.clear()
    torch.cuda.empty_cache()
    qmodel = _qwen_model(dev, 2, torch.float32, seed=6, quantize_kv=True,
                         quantize_draft="int4")
    qmodel.quantize_target_inplace()
    req = cases["one_image"]
    ids, n = req["input_ids"], len(req["input_ids"])
    q4_shapes, undo = _recording_q4_dispatch()
    _zero_launch_counts()
    try:
        spec = qmodel.specgenerate(ids, max_new_tokens=64, **_vision_kw(req))
        ar = qmodel.ar_generate(ids, max_new_tokens=64, **_vision_kw(req))
    finally:
        undo()
    counts = _launch_counts()
    same = spec.sequences[:n + 64].tolist() == ar.sequences[:n + 64].tolist()
    row = {"phase": "qwen_exact", "case": "quantized_one_image", "layers": 2,
           "kv": "int8", "draft": "int4", "target": "int8", "prompt": n,
           "new_tokens": [spec.new_tokens, ar.new_tokens], "launches": counts,
           "q4_shapes_kmn": sorted(q4_shapes),
           "ok": same and spec.new_tokens >= 64 and counts["1b"] > 0 and counts["2"] > 0}
    emit(row)
    assert row["ok"], "qwen_exact: quantized spec != AR"
    del model, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    # spec == AR cannot see a wrong draft product (verification is lossless):
    # hold kernel 2 against its plain version at every (K, N, M) it just ran
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    rows = [q4_case(dev, k, n_, m, flush, prefix="qwen_q4") for k, n_, m in sorted(q4_shapes)]
    torch.cuda.empty_cache()
    return rows


QWEN_PROMPTS = (("448x448", dict(images=[(448, 448)])),
                ("896x1120", dict(images=[(896, 1120)])),
                ("two_448x448", dict(images=[(448, 448), (448, 448)])),
                ("video_8x448x448", dict(video=(8, 448, 448))))


def phase_qwen_full_depth(dev, model):
    """Qwen2.5-VL-7B at DEPTH_LAYERS of its 28 target layers and the 32-block tower in
    bfloat16, max_len 4096, IMAGE_DEPTH_TOKENS new tokens by spec and by AR after each of
    four prompts (~63 text tokens each): a 448x448 image (256 image
    tokens, 1,024 patches in 16 windows), an 896x1120 image (1,280 tokens,
    the pixel budget's ceiling), two 448x448 images, an 8-frame 448x448
    video (4 temporal groups, 1,024 tokens).  Per prompt: the vision encode
    and the prefill (encode, merge, M-RoPE ids, plan, target and draft
    prefill, first tree), each the median (and range) of IMAGE_TIMED_CALLS
    calls timed by CUDA events after a warm-up; decode tok/s; kernel 1a's launches (3 +
    layers + 4 per dispatched spec round: the target verifies, the draft append, 3
    expansion levels; layers per AR step); peak memory; then the encode and
    the prefill under torch.profiler.  spec/AR agreement is reported, not
    required (bf16)."""
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.spec import loop
    from vispec_tpu_torch.spec.spec_model import _as_image_list, _bucket, output_rows, \
        plan_prompt

    rows = []
    for seed, (name, shape) in enumerate(QWEN_PROMPTS):
        req = _qwen_request(model, 70 + seed, **shape)
        ids, n = req["input_ids"], len(req["input_ids"])
        vis = _vision_kw(req)
        for key in ("pixel_values", "pixel_values_videos"):  # on the card already
            if key in vis:
                pv = vis[key]
                vis[key] = ([torch.as_tensor(x, device=dev) for x in pv]
                            if isinstance(pv, list) else torch.as_tensor(pv, device=dev))
        pad = _bucket(n)
        images, sizes = _as_image_list(vis.get("pixel_values"), vis.get("image_size"))

        def prefill():
            prompt = model._padded_prompt(ids, pad, **vis)
            plan, span = plan_prompt(model.dcfg, prompt.shifted, prompt.n_spans, n, pad, dev)
            return loop.spec_prefill(
                model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, plan,
                loop.SamplingParams(), prompt.embeds, kv.reset(model.target_cache),
                kv.reset(model.draft_cache), output_rows(model.spec, 128), span,
                rope=prompt.rope)

        def encode():
            return model._qwen_vision(images, sizes, vis.get("pixel_values_videos"), 1.0)[0]

        with torch.no_grad():
            feats, encode_ms, encode_range = _median_cuda_ms(encode, IMAGE_TIMED_CALLS)
            state, prefill_ms, prefill_range = _median_cuda_ms(prefill, IMAGE_TIMED_CALLS)
        rope_delta = int(state.rope_delta)
        del state
        model.specgenerate(ids, max_new_tokens=8, **vis)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launch_counts()
        spec = model.specgenerate(ids, max_new_tokens=IMAGE_DEPTH_TOKENS, **vis)
        spec_launches = va.verify_attention.launches
        _zero_launch_counts()
        ar = model.ar_generate(ids, max_new_tokens=IMAGE_DEPTH_TOKENS, **vis)
        ar_launches = va.verify_attention.launches
        layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
        want_spec = depth + spec.dispatched * (layers + 1 + depth)
        want_ar = ar.dispatched * layers
        a, b = spec.sequences[n:], ar.sequences[n:]
        m = min(len(a), len(b))
        row = {"phase": "qwen_full_depth", "prompt_kind": name, "layers": layers,
               "tower_blocks": model.qwen_cfg.depth, "dtype": "bfloat16",
               "max_len": model.max_len,
               "vision_tokens": int(feats.shape[0]), "prompt": n, "pad_len": pad,
               "rope_delta": rope_delta,
               "vision_encode_ms": encode_ms, "vision_encode_ms_range": encode_range,
               "prefill_ms": prefill_ms, "prefill_ms_range": prefill_range,
               "spec_tokens": spec.new_tokens, "spec_s": spec.decode_time,
               "spec_tok_per_s": spec.new_tokens / spec.decode_time,
               "rounds": spec.rounds, "dispatched_rounds": spec.dispatched,
               "ar_tokens": ar.new_tokens, "ar_s": ar.decode_time,
               "ar_tok_per_s": ar.new_tokens / ar.decode_time,
               "agreeing_prefix": int(np.argmin(np.append(a[:m] == b[:m], False))),
               "launches_1a_spec": spec_launches, "expected_spec": want_spec,
               "launches_1a_per_round": (spec_launches - depth) / spec.dispatched,
               "launches_ar": ar_launches, "expected_ar": want_ar,
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
        row["ok"] = (spec_launches == want_spec and ar_launches == want_ar
                     and spec.new_tokens >= IMAGE_DEPTH_TOKENS
                     and ar.new_tokens >= IMAGE_DEPTH_TOKENS)
        emit(row)
        assert row["ok"], row
        rows.append(row)
        with torch.no_grad():
            emit({"phase": "profile_qwen_encode", "prompt_kind": name,
                  "vision_tokens": row["vision_tokens"], **_profile(encode)})
            pre = _profile(prefill)
            emit({"phase": "profile_qwen_prefill", "prompt_kind": name, "pad_len": pad,
                  **pre})
        if not seed:  # the first prompt's decode: launches a round past the prefill's
            for label, gen in (("spec", model.specgenerate), ("ar", model.ar_generate)):
                res = []
                prof = _profile(lambda: res.append(gen(ids, max_new_tokens=PROFILE_TOKENS,
                                                       **vis)))
                n_rounds = res[-1].dispatched
                emit({"phase": f"profile_qwen_{label}_{PROFILE_TOKENS}_tokens",
                      "prompt_kind": name,
                      "dispatched": n_rounds, "decode_launches_per_round":
                      (prof["kernel_launches"] - pre["kernel_launches"]) / n_rounds,
                      **prof})
        model.target_cache = model.draft_cache = None
        torch.cuda.empty_cache()
    return rows


def phase_serving_qwen_full_depth(dev, model):
    """The engine over the 28-layer bfloat16 Qwen2.5-VL model: B = 4,
    ``max_span=256`` (one 448x448 image's span), pad buckets (128, 256, 512),
    8 requests of which 4 carry a 448x448 image (cap 64) and 4 are text
    (seed 0: prompts of 64-448, caps of 64-128).  All complete with no
    failed request; requires 32 launches of 1c per dispatched round (28
    target verifies, the draft append, 3 expansion levels) and 3 of 1a per
    prefill."""
    reqs = []
    for i, (p, c) in enumerate(_serving_requests(4)):
        reqs.append((_qwen_request(model, 80 + i, images=[(448, 448)]), 64))
        reqs.append((p, c))
    kw = dict(pad_bucket=(128, 256, 512), chunk_rounds=8, max_span=256)
    warm = model.serving_engine(batch_size=4, **kw)
    warm.run_all([{**reqs[0][0], "max_new_tokens": 4}])  # warm-up: an image admission
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    eng, outs, latency, wall = _serve(model, reqs, **kw)
    counts = _launch_counts()
    rounds, prefills = eng.stats["rounds"], eng._n_prefills
    depth = model.spec.depth
    want = {"1a": depth * prefills, "1b": 0,
            "1c": (model.tcfg.num_hidden_layers + 1 + depth) * rounds, "1c_int8": 0, "2": 0}
    tokens = sum(len(o) for o in outs)
    row = {"phase": "serving_qwen_full_depth", "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16", "max_len": model.max_len, "batch_size": 4, "max_span": 256,
           "requests": len(reqs),
           "image_requests": sum(isinstance(r, dict) for r, _ in reqs),
           "prompt_lens": [len(r["input_ids"] if isinstance(r, dict) else r)
                           for r, _ in reqs],
           "caps": [c for _, c in reqs], "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall, "latency_p50_s": float(np.median(latency)),
           "latency_max_s": max(latency), "rounds_dispatched": rounds,
           "prefills": prefills, "admissions": eng.stats["admissions"],
           "admit_dispatch_s": eng.stats["admit_dispatch_s"],
           "launches": counts, "expected": want,
           "launches_1c_per_round": counts["1c"] / rounds, "errors": dict(eng.errors),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    row["ok"] = (counts == want and not eng.errors
                 and all(_complete(o, c, model) for o, (_, c) in zip(outs, reqs)))
    emit(row)
    assert row["ok"], row
    del eng
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Sampling (T > 0) and the EAGLE-2 and Medusa drafters
# ---------------------------------------------------------------------------

WALK_TOKENS, WALK_PARENT = [5, 7, 9, 1, 2, 9], [0, 0, 0, 1, 1, 2]


def _walk_tree(tokens, parent, n, dev):
    """A hand-built tree (tests/test_tree.py's) stacked over ``n`` slots."""
    from vispec_tpu_torch.ops.tree import Tree

    t = len(tokens)
    mask = np.eye(t, dtype=bool)
    for i in range(1, t):
        mask[i] |= mask[parent[i]]
    fields = (np.asarray(tokens, np.int32), np.asarray(parent, np.int32), mask,
              (mask.sum(1) - 1).astype(np.int32))
    return Tree(*(torch.as_tensor(f, device=dev).expand(n, *f.shape) for f in fields))


def _np_sequential_accept(p, rs, max_depth=3):
    """The sequential reject-and-renormalise walk in numpy over the walk
    tree: at the accepted node, its children in node order; accept child x
    with probability p(x), else zero x's mass and renormalise.  Returns the
    best node."""
    depth = np.eye(6, dtype=bool)
    for i in range(1, 6):
        depth[i] |= depth[WALK_PARENT[i]]
    depth = depth.sum(1) - 1
    cur = 0
    for d in range(max_depth):
        gtp = p[cur].astype(np.float64) / p[cur].sum()
        accepted = None
        for c in (i for i in range(1, 6) if WALK_PARENT[i] == cur and depth[i] == d + 1):
            x = WALK_TOKENS[c]
            if rs.uniform() <= gtp[x]:
                accepted = c
                break
            gtp[x] = 0.0
            gtp = gtp / gtp.sum() if gtp.sum() > 0 else gtp
        if accepted is None:
            return cur
        cur = accepted
    return cur


def phase_sampling_device(dev):
    """The sampling ops on the card against the CPU and against their
    distributions: the key stream's splits and uniforms bit for bit;
    ``process_logits`` (T 0.7, top-p 0.9) and ``sample_probs_dyn`` (three
    slots: greedy; T 1, top-p 0.9, penalty 1.3, k 20; T 0.7, top-p 0.95,
    k 50 of a 50 bucket) on tie-free float32 logits [30, 32000] within 1e-6
    with identical keep sets; the tree walk's best node over 20,000 slots
    within 4 sigma + 0.01 of the numpy sequential walk; the depth-1 outcome
    (accepted child or residual draw) within 0.02 of p over 20,000 slots."""
    from vispec_tpu_torch.ops import rng, sampling, tree

    kc, kd = rng.keys(range(64), "cpu"), rng.keys(range(64), dev)
    splits_equal = torch.equal(torch.stack(rng.split(kd, 3)).cpu(),
                               torch.stack(rng.split(kc, 3)))
    uniforms_equal = torch.equal(rng.uniform(kd, (4, 30)).cpu(), rng.uniform(kc, (4, 30)))
    gumbel_err = float((rng.gumbel(kd, (32000,)).cpu() - rng.gumbel(kc, (32000,))).abs().max())

    g = torch.Generator().manual_seed(0)
    perm = torch.stack([torch.randperm(32000, generator=g) for _ in range(30)])
    logits = perm.float() * (8.0 / 32000) - 4.0  # distinct values in every row
    want = sampling.process_logits(logits, 0.7, 0.9, 0)
    got = sampling.process_logits(logits.to(dev), 0.7, 0.9, 0).cpu()
    warp_keep = torch.equal(got > -1e8, want > -1e8)
    keep = want > -1e8
    warp_err = float((got[keep] - want[keep]).abs().max())
    knobs = [torch.tensor(v) for v in ([0.0, 1.0, 0.7], [0.0, 0.9, 0.95], [1.0, 1.3, 1.0],
                                       [0.0, 20.0, 50.0])]
    seen = torch.zeros((3, 32001), dtype=torch.bool)
    seen[:, torch.randperm(32000, generator=g)[:500]] = True
    lg = logits.reshape(3, 10, 32000)
    want = sampling.sample_probs_dyn(lg, *knobs[:3], seen, 50, top_k_dyn=knobs[3])
    got = sampling.sample_probs_dyn(lg.to(dev), *(k.to(dev) for k in knobs[:3]),
                                    seen.to(dev), 50, top_k_dyn=knobs[3].to(dev)).cpu()
    probs_keep = torch.equal(got > 0, want > 0)
    probs_err = float((got - want).abs().max())

    trials = 20000
    p = np.random.default_rng(3).uniform(0.05, 1.0, (6, 12))
    p[:, 9] *= 4
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    keys = rng.keys(range(trials), dev)
    best, _, _ = tree.sampling_accept(
        _walk_tree(WALK_TOKENS, WALK_PARENT, trials, dev),
        torch.as_tensor(p, device=dev).expand(trials, 6, 12), rng.uniform(keys, (3, 6)), 3)
    ours = np.bincount(best.cpu().numpy(), minlength=6) / trials
    rs = np.random.default_rng(7)
    ref = np.bincount([_np_sequential_accept(p, rs) for _ in range(trials)],
                      minlength=6) / trials
    walk_dev = np.abs(ours - ref)
    walk_ok = bool(np.all(walk_dev < 4 * np.sqrt(np.maximum(ref * (1 - ref) / trials, 1e-9))
                          + 0.01))
    p1 = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    k_acc, k_bonus = rng.split(rng.keys(range(trials, 2 * trials), dev), 2)
    best, acc, resid = tree.sampling_accept(
        _walk_tree([9, 0, 1], [0, 0, 0], trials, dev),
        torch.as_tensor(np.tile(p1, (3, 1)), device=dev).expand(trials, 3, 4),
        rng.uniform(k_acc, (1, 3)), 1)
    bonus = sampling.sample_categorical(k_bonus, resid)
    toks = torch.where(acc > 0, torch.tensor([9, 0, 1], device=dev)[best.long()], bonus)
    freq = np.bincount(toks.cpu().numpy(), minlength=4)[:4] / trials
    outcome_err = float(np.abs(freq - p1).max())
    row = {"phase": "sampling_device", "splits_equal": splits_equal,
           "uniforms_equal": uniforms_equal, "gumbel_max_abs_err": gumbel_err,
           "process_logits_max_abs_err": warp_err, "process_logits_keep_equal": warp_keep,
           "sample_probs_dyn_max_abs_err": probs_err, "sample_probs_dyn_keep_equal": probs_keep,
           "limit": 1e-6, "walk_trials": trials, "walk_best_freq": ours.tolist(),
           "walk_reference_freq": ref.tolist(), "walk_ok": walk_ok,
           "outcome_freq": freq.tolist(), "outcome_max_abs_err": outcome_err,
           "outcome_limit": 0.02}
    row["ok"] = (splits_equal and uniforms_equal and warp_keep and probs_keep
                 and warp_err <= 1e-6 and probs_err <= 1e-6 and walk_ok
                 and outcome_err <= 0.02)
    emit(row)
    assert row["ok"], row


def _medusa_params(model, seed=7):
    """Medusa heads for ``model``'s target: the zero initializer plus
    N(0, 0.02) noise from ``seed`` (random, not the identity)."""
    from vispec_tpu_torch.models import medusa

    dev, dtype = model.device, model.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: v + torch.randn(v.shape, generator=g, device=dev, dtype=dtype) * 0.02
            for k, v in medusa.init_params(model.tcfg.hidden_size, dev, dtype).items()}


def _medusa_model(model, mparams, **kw):
    """A Medusa SpecModel over ``model``'s target (a layerless stub draft)."""
    from vispec_tpu_torch.spec.spec_model import (SpecModel, _stub_draft_config,
                                                  _stub_draft_params)

    return SpecModel(model.tcfg, _stub_draft_config(model.tcfg), model.spec, model.tparams,
                     _stub_draft_params(model.tparams, model.dtype), max_len=model.max_len,
                     dtype=model.dtype, device=model.device, mparams=mparams, **kw)


def _eagle_model(model, seed, **kw):
    """An EAGLE-2 SpecModel over ``model``'s target: its draft's config with
    ``vision=False`` (no adaptor, no img_fc), random from ``seed``, sharing
    the target's embedding."""
    import dataclasses

    from vispec_tpu_torch.models import draft
    from vispec_tpu_torch.spec.spec_model import SpecModel

    dcfg = dataclasses.replace(model.dcfg, vision=False)
    g = torch.Generator(device=model.device).manual_seed(seed)
    dparams = draft.init_params(dcfg, g, model.device, model.dtype)
    dparams["embed"] = model.tparams["embed"]
    return SpecModel(model.tcfg, dcfg, model.spec, model.tparams, dparams,
                     max_len=model.max_len, dtype=model.dtype, device=model.device, **kw)


SAMPLING_MIX = [{}, {"temperature": 1.0}, {"temperature": 1.0, "repetition_penalty": 1.3},
                {"temperature": 0.7, "top_p": 0.9}]


def phase_sampling_exact(dev):
    """Vicuna-7B widths, 2 target layers, float32 with TF32 off; every check
    token for token.  T 0.7 with top_k 1: spec == AR == greedy (64 tokens).
    T 1: ``specgenerate_batch`` (prompts of 40 / 90 / 130 / 200) == per
    request with seeds seed + i.  The per-request engine (B = 4, engine
    top_k 1) over a greedy / T 1 / penalty 1.3 / top-p 0.9 mix == single
    runs with each request's knobs.  Medusa spec == AR, over an int8 KV
    cache too, and Medusa's batch and engine == single runs.  EAGLE-2 spec
    == AR, bf16-free and with an int8 and an int4 draft.  The quantized mode
    (int8 KV, int4 draft, int8 target) at T 0.7 with top_k 1: spec == AR ==
    its greedy.  Kernels 1a, 1b and 2 must each have run on these paths
    (launch counts per run in the line)."""
    model = _full_width_model(dev, 2, torch.float32, seed=1)
    prompt = np.random.default_rng(1).integers(3, 32000, 100).tolist()
    n = len(prompt)
    greedy = model.specgenerate(prompt, max_new_tokens=64).sequences[:n + 64].tolist()
    ar = model.ar_generate(prompt, max_new_tokens=64).sequences.tolist()
    checks = {
        "spec_greedy_eq_ar": greedy == ar,
        "spec_t07_topk1_eq_greedy": model.specgenerate(
            prompt, max_new_tokens=64, temperature=0.7, top_k=1,
            seed=3).sequences[:n + 64].tolist() == greedy,
        "ar_t07_topk1_eq_greedy": model.ar_generate(
            prompt, max_new_tokens=64, temperature=0.7, top_k=1, seed=3).sequences.tolist()
        == greedy}
    rng_ = np.random.default_rng(3)
    prompts = [rng_.integers(3, 32000, k).tolist() for k in (40, 90, 130, 200)]
    batch = model.specgenerate_batch([{"input_ids": p} for p in prompts], temperature=1.0,
                                     max_new_tokens=32, seed=10)
    checks["batch_t1_eq_per_request"] = [r.sequences.tolist() for r in batch] == [
        model.specgenerate(p, temperature=1.0, max_new_tokens=32,
                           seed=10 + i).sequences[:len(p) + 32].tolist()
        for i, p in enumerate(prompts)]
    eng = model.serving_engine(batch_size=4, max_new_tokens=32, top_k=1, chunk_rounds=4,
                               pad_bucket=(128, 256), per_request_sampling=True)
    outs = eng.run_all([dict(input_ids=p, **c) for p, c in zip(prompts, SAMPLING_MIX)])
    checks["per_request_engine_eq_single"] = [o.tolist() for o in outs] == [
        model.specgenerate(p, max_new_tokens=32, top_k=1, **c).sequences[
            len(p):len(p) + 32].tolist() for p, c in zip(prompts, SAMPLING_MIX)]

    launches = {}

    def counted(label, fn):
        _zero_launch_counts()
        out = fn()
        launches[label] = {k: v for k, v in _launch_counts().items() if v}
        return out

    mparams = _medusa_params(model)
    med = _medusa_model(model, mparams)
    mres = counted("medusa", lambda: med.specgenerate(prompt, max_new_tokens=64))
    checks["medusa_spec_eq_ar"] = mres.sequences[:n + 64].tolist() == ar
    medq = _medusa_model(model, mparams, quantize_kv=True)
    checks["medusa_int8_kv_spec_eq_ar"] = (
        counted("medusa_int8_kv", lambda: medq.specgenerate(prompt, max_new_tokens=64))
        .sequences[:n + 64].tolist()
        == medq.ar_generate(prompt, max_new_tokens=64).sequences.tolist())
    del medq
    singles = [med.specgenerate(p, max_new_tokens=32).sequences[len(p):len(p) + 32].tolist()
               for p in prompts[:3]]
    checks["medusa_batch_eq_single"] = [
        r.sequences[len(p):].tolist() for p, r in zip(
            prompts, med.specgenerate_batch([{"input_ids": p} for p in prompts[:3]],
                                            max_new_tokens=32))] == singles
    meng = med.serving_engine(batch_size=2, max_new_tokens=32, chunk_rounds=4,
                              pad_bucket=(128, 256))
    checks["medusa_engine_eq_single"] = [o.tolist() for o in meng.run_all(prompts[:3])] \
        == singles
    del med, meng
    for label, quant in (("eagle", {}), ("eagle_int8_draft", {"quantize_draft": "int8"}),
                         ("eagle_int4_draft", {"quantize_draft": "int4"})):
        eagle = _eagle_model(model, seed=4, **quant)
        checks[label + "_spec_eq_ar"] = counted(label, lambda: eagle.specgenerate(
            prompt, max_new_tokens=64)).sequences[:n + 64].tolist() == ar
        del eagle
    del model
    torch.cuda.empty_cache()
    # a sampled round of the quantized mode: int8 KV (1b), int4 draft (2)
    qmodel = _full_width_model(dev, 2, torch.float32, seed=1, quantize_kv=True,
                               quantize_draft="int4")
    qmodel.quantize_target_inplace()
    qgreedy = qmodel.specgenerate(prompt, max_new_tokens=64).sequences[:n + 64].tolist()
    checks["quant_t07_topk1_eq_greedy"] = counted(
        "quant_sampled", lambda: qmodel.specgenerate(
            prompt, max_new_tokens=64, temperature=0.7, top_k=1, seed=3)).sequences[
        :n + 64].tolist() == qgreedy
    checks["quant_ar_t07_topk1_eq_greedy"] = qmodel.ar_generate(
        prompt, max_new_tokens=64, temperature=0.7, top_k=1, seed=3).sequences.tolist() \
        == qgreedy
    # each kernel of these paths ran: 1a (Medusa, EAGLE-2), 1b (int8 KV), 2 (int4)
    ran = (launches["medusa"].get("1a") and launches["medusa_int8_kv"].get("1b")
           and launches["eagle"].get("1a") and launches["eagle_int4_draft"].get("2")
           and launches["quant_sampled"].get("1b") and launches["quant_sampled"].get("2"))
    row = {"phase": "sampling_exact", "layers": 2, "dtype": "float32", "new_tokens": 64,
           "medusa_accept_lengths": mres.acceptance_lengths[:16], **checks,
           "launches": launches, "ok": all(checks.values()) and bool(ran)}
    emit(row)
    assert row["ok"], row
    del qmodel
    torch.cuda.empty_cache()


def phase_tau_fixture_sampling(dev):
    """The trained toy checkpoint at T > 0: T 1 with top_k 1 equals greedy
    on the six tau prompts; with the lm_head sharpened x8
    (tests/test_e2e_tau.py), mean tau over the six prompts at T 0.5 exceeds
    tau at T 1, which is at least 1.0."""
    model = _tau_model(dev)
    prompts = [np.random.default_rng(100 + s).integers(1, 90, 16).tolist() for s in range(6)]
    same = [model.specgenerate(p, max_new_tokens=40, temperature=1.0, top_k=1,
                               seed=s).sequences[:56].tolist()
            == model.specgenerate(p, max_new_tokens=40).sequences[:56].tolist()
            for s, p in enumerate(prompts)]
    model.tparams = dict(model.tparams, lm_head=model.tparams["lm_head"] * 8.0)

    def tau(temperature):
        taus = []
        for s, p in enumerate(prompts):
            r = model.specgenerate(p, max_new_tokens=40, temperature=temperature, seed=s)
            taus.extend(a + 1 for a in r.acceptance_lengths)
        return float(np.mean(taus))

    t05, t1 = tau(0.5), tau(1.0)
    row = {"phase": "tau_fixture_sampling", "topk1_eq_greedy": same, "tau_t05": t05,
           "tau_t1": t1, "ok": all(same) and t05 > t1 >= 1.0}
    emit(row)
    assert row["ok"], row


def _accept_step_ms(dev, sampling_params, b=None):
    """Median (and range) of 10 CUDA-event timings of one round's acceptance
    at the verify's shape, [30, 32000] logits (``[B, 30, 32000]`` for ``b``
    slots): greedy (argmax, walk, bonus) or sampled (warps, softmax,
    uniforms, walk, Gumbel bonus)."""
    from vispec_tpu_torch.ops import rng, sampling, tree
    from vispec_tpu_torch.spec import loop

    lead = () if b is None else (b,)
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn((*lead, 30, 32000), generator=g, device=dev) * 3
    parent = torch.as_tensor([0] + [i // 2 for i in range(1, 30)], device=dev)
    mask = torch.eye(30, dtype=torch.bool, device=dev)
    for i in range(1, 30):
        mask[i] |= mask[parent[i]]
    t = tree.Tree(torch.randint(0, 32000, (*lead, 30), generator=g, device=dev,
                                dtype=torch.int32), parent.to(torch.int32).expand(*lead, 30),
                  mask.expand(*lead, 30, 30), (mask.sum(1) - 1).to(torch.int32).expand(*lead, 30))
    key = rng.keys(range(b), dev) if b else rng.key(0, dev)
    samp = torch.tensor([1.0, 0.9, 1.3, 20.0], device=dev).expand(*lead, 4)
    seen = torch.zeros((*lead, 32001), dtype=torch.bool, device=dev)

    def step():
        if sampling_params.greedy:
            am = torch.argmax(logits, -1).to(torch.int32)
            best, _ = tree.greedy_accept(t, am)
            return best
        _, k_acc, k_bonus = rng.split(key, 3)
        probs = loop._probs(logits, sampling_params, samp, seen)
        _, _, resid = tree.sampling_accept(t, probs, rng.uniform(k_acc, (5, 30)), 5)
        return sampling.sample_categorical(k_bonus, resid)

    _, ms, ms_range = _median_cuda_ms(step)
    return ms, ms_range


def phase_sampling_full_depth(dev, model, prompt):
    """Vicuna-7B at DEPTH_LAYERS layers in bfloat16 (the ``full_width_depth`` model),
    ``DEPTH_TOKENS`` new tokens after its 128-token prompt, three runs each (median and
    range of tok/s): ViSpec spec at T 1 / top-p 0.9 and AR at T 1 (seeds
    0-2); Medusa spec (random heads from a seed) and EAGLE-2 spec (a random
    ``vision=False`` draft) at T 0.  Gates: kernel 1a launched layers + 4
    times a sampled ViSpec round + 3 at prefill, layers a Medusa round (none
    at prefill), layers + 4 an EAGLE-2 round + 3, layers a sampled AR step; a sampled round
    and a Medusa round make no host read.  Reports the acceptance step's
    device-and-issue ms greedy against sampled (single request and B = 4),
    one profiled ``PROFILE_TOKENS``-token sampled run (launches a round, 1a apart; idle
    share) and peak memory."""
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.spec import loop

    layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
    med = _medusa_model(model, _medusa_params(model))
    eagle = _eagle_model(model, seed=4)
    sampled = loop.SamplingParams(1.0, 0.9)
    _decode_round_without_host_sync(model, prompt, sampled)
    _decode_round_without_host_sync(med, prompt)
    runs = {
        "spec_t1_topp09": lambda s: model.specgenerate(prompt, max_new_tokens=DEPTH_TOKENS,
                                                       temperature=1.0, top_p=0.9, seed=s),
        "ar_t1": lambda s: model.ar_generate(prompt, max_new_tokens=DEPTH_TOKENS, temperature=1.0,
                                             seed=s),
        "medusa_t0": lambda s: med.specgenerate(prompt, max_new_tokens=DEPTH_TOKENS),
        "eagle_t0": lambda s: eagle.specgenerate(prompt, max_new_tokens=DEPTH_TOKENS),
    }
    # warm-up: the sampling ops' and the drafters' first launches
    model.specgenerate(prompt, max_new_tokens=8, temperature=1.0, top_p=0.9, seed=9)
    model.ar_generate(prompt, max_new_tokens=8, temperature=1.0, seed=9)
    med.specgenerate(prompt, max_new_tokens=8)
    eagle.specgenerate(prompt, max_new_tokens=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    row = {"phase": "sampling_full_depth", "layers": layers, "dtype": "bfloat16",
           "max_len": model.max_len, "prompt": len(prompt), "new_tokens": DEPTH_TOKENS}
    ok = True
    for name, fn in runs.items():
        rates, launches, taus = [], [], []
        for s in range(3):
            _zero_launch_counts()
            r = fn(s)
            got = va.verify_attention.launches
            if name in ("ar_t1", "medusa_t0"):
                want = r.dispatched * layers
            else:
                want = depth + r.dispatched * (layers + 1 + depth)
            ok &= got == want and r.new_tokens >= DEPTH_TOKENS
            rates.append(r.new_tokens / r.decode_time)
            launches.append([got, want, r.dispatched])
            if r.acceptance_lengths:
                taus.append(float(np.mean([a + 1 for a in r.acceptance_lengths])))
        row[name] = {"tok_per_s_median": float(np.median(rates)),
                     "tok_per_s_range": [min(rates), max(rates)], "tok_per_s": rates,
                     "launches_1a_expected_dispatched": launches, "tau": taus}
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    for label, params, b in (("greedy", loop.SamplingParams(), None),
                             ("sampled", sampled, None),
                             ("greedy_b4", loop.SamplingParams(), 4),
                             ("per_request_b4",
                              loop.SamplingParams(0.0, 0.0, 50, per_request=True), 4)):
        ms, ms_range = _accept_step_ms(dev, params, b)
        row[f"accept_step_ms_{label}"] = ms
        row[f"accept_step_ms_{label}_range"] = ms_range
    row["ok"] = ok
    emit(row)
    assert row["ok"], row
    res = []
    prof = _profile(lambda: res.append(model.specgenerate(
        prompt, max_new_tokens=PROFILE_TOKENS, temperature=1.0, top_p=0.9, seed=5)))
    n = res[-1].dispatched
    attn = prof["attention_launches"]
    emit({"phase": f"profile_sampled_spec_{PROFILE_TOKENS}_tokens", "dispatched_rounds": n,
          "launches_1a": attn,  # a single request's attention calls are all 1a
          "launches_per_round": prof["kernel_launches"] / n,
          "attention_launches_per_round": attn / n,
          "other_launches_per_round": (prof["kernel_launches"] - attn) / n, **prof})
    del eagle
    torch.cuda.empty_cache()
    return med


def phase_serving_sampling_full_depth(dev, model, med):
    """The engine at Vicuna-7B, DEPTH_LAYERS layers, bfloat16: ``ServingEngine(
    batch_size=4, per_request_sampling=True, top_k=50)`` over the 8
    ``serving_full_depth`` requests, their knobs cycling through greedy /
    T 1 / T 1 with penalty 1.3 / T 0.7 with top-p 0.9 / T 1 with top_k 20;
    then the Medusa engine (greedy) over the same 8.  Gates: kernel 1c layers
    + 4 launches a round (Medusa layers), 1a 3 a prefill (Medusa none), no failed
    request, every request complete."""
    knobs = SAMPLING_MIX + [{"temperature": 1.0, "top_k": 20}]
    base = _serving_requests(8)
    reqs = [({"input_ids": p, **knobs[i % len(knobs)]}, c) for i, (p, c) in enumerate(base)]
    layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
    rows = []
    for label, m, kw, per_round, per_prefill in (
            ("per_request_sampling", model,
             dict(per_request_sampling=True, top_k=50, chunk_rounds=8),
             layers + 1 + depth, depth),
            ("medusa_greedy", med, dict(chunk_rounds=8), layers, 0)):
        requests = reqs if label == "per_request_sampling" else base
        warm = m.serving_engine(batch_size=4, pad_bucket=(128, 256, 512), **kw)
        warm.run_all([dict(r, max_new_tokens=4) if isinstance(r, dict) else
                      {"input_ids": r, "max_new_tokens": 4} for r, _ in requests[:4]])
        del warm
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launch_counts()
        eng, outs, latency, wall = _serve(m, requests, **kw)
        counts = _launch_counts()
        rounds, prefills = eng.stats["rounds"], eng._n_prefills
        want = {"1a": per_prefill * prefills, "1b": 0, "1c": per_round * rounds,
                "1c_int8": 0, "2": 0}
        tokens = sum(len(o) for o in outs)
        row = {"phase": "serving_sampling_full_depth", "mode": label, "layers": layers,
               "dtype": "bfloat16", "batch_size": 4, "requests": len(requests),
               "knobs": [{k: v for k, v in r.items() if k != "input_ids"}
                         if isinstance(r, dict) else {} for r, _ in requests],
               "tokens": tokens, "wall_s": wall, "tok_per_s": tokens / wall,
               "latency_p50_s": float(np.median(latency)), "latency_max_s": max(latency),
               "rounds_dispatched": rounds, "prefills": prefills,
               "launches": counts, "expected": want, "errors": dict(eng.errors),
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
        row["ok"] = (counts == want and not eng.errors
                     and all(_complete(o, c, m) for o, (_, c) in zip(outs, requests)))
        emit(row)
        assert row["ok"], row
        rows.append(row)
        del eng
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Mixtral-8x7B targets, HF checkpoints and conversation snapshots
# ---------------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's config.json (32 layers: each phase sets its
# depth); the draft at the same widths (32 heads over 8 KV heads, MLP 14,336)
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_attention_heads=32, num_key_value_heads=8,
               max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
               num_local_experts=8, num_experts_per_tok=2)
MIXTRAL_DRAFT = {k: MIXTRAL[k] for k in ("vocab_size", "hidden_size", "intermediate_size",
                                         "num_attention_heads", "num_key_value_heads",
                                         "max_position_embeddings", "rms_norm_eps",
                                         "rope_theta")}
# at most 24 of 32 layers in bfloat16 (~70 GB of weights) fit one 80 GB
# card beside the caches and the draft
MIXTRAL_LAYERS = DEPTH_LAYERS
# lmsys/vicuna-7b-v1.5's config.json at 2 layers (from_pretrained_device)
VICUNA_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
             "num_hidden_layers": 2, "num_attention_heads": 32, "num_key_value_heads": 32,
             "max_position_embeddings": 4096, "rms_norm_eps": 1e-5, "eos_token_id": 2}


def _mixtral_model(dev, layers, dtype, seed, **quant):
    from vispec_tpu_torch.configs import DraftConfig, SpecConfig
    from vispec_tpu_torch.models import draft, mixtral
    from vispec_tpu_torch.spec.spec_model import SpecModel

    tcfg = mixtral.MixtralConfig(num_hidden_layers=layers, **MIXTRAL)
    dcfg = DraftConfig(**MIXTRAL_DRAFT)
    g = torch.Generator(device=dev).manual_seed(seed)
    tparams = mixtral.init_params(tcfg, g, dev, dtype)
    dparams = draft.init_params(dcfg, g, dev, dtype)
    dparams["embed"] = tparams["embed"]
    return SpecModel(tcfg, dcfg, SpecConfig(), tparams, dparams, max_len=2048, dtype=dtype,
                     device=dev, **quant)


def phase_mixtral_exact(dev):
    """Mixtral-8x7B widths (8 experts, top-2, 32 heads over 8 KV heads, the
    draft's MLP 14,336 wide) at 2 target layers in float32 with TF32 off:
    greedy spec == AR for 64 new tokens; ``specgenerate_batch`` over three
    prompts and the engine (B = 2) over four == per request; the int8 KV
    cache with an int4 draft, spec == AR, with kernels 1b and 2 launched.
    Then kernel 2 against its plain version at every (K, N, M) that run gave
    it (returned as rows)."""
    model = _mixtral_model(dev, 2, torch.float32, seed=9)
    rng = np.random.default_rng(9)
    prompt = rng.integers(3, 32000, 100).tolist()
    spec = model.specgenerate(prompt, max_new_tokens=64)
    ar = model.ar_generate(prompt, max_new_tokens=64)
    same = spec.sequences[:164].tolist() == ar.sequences[:164].tolist()
    row = {"phase": "mixtral_exact", "case": "spec_vs_ar", "layers": 2, "dtype": "float32",
           "experts": model.tcfg.num_local_experts, "new_tokens": [spec.new_tokens,
                                                                   ar.new_tokens],
           "rounds": spec.rounds, "ok": same and spec.new_tokens >= 64}
    emit(row)
    assert row["ok"], "mixtral_exact: spec != AR"
    prompts = [rng.integers(3, 32000, n).tolist() for n in (40, 90, 130, 60)]
    refs = [model.specgenerate(p, max_new_tokens=48).sequences[len(p):len(p) + 48].tolist()
            for p in prompts]
    got = model.specgenerate_batch([{"input_ids": p} for p in prompts[:3]],
                                   max_new_tokens=48)
    outs = {"specgenerate_batch": [o.sequences[len(p):].tolist()
                                   for p, o in zip(prompts, got)],
            "engine_b2": [o.tolist() for o in model.serving_engine(
                batch_size=2, max_new_tokens=48, chunk_rounds=4,
                pad_bucket=(128, 256)).run_all(prompts)]}
    for label, out in outs.items():
        same = [o == r and len(o) == 48 for o, r in zip(out, refs)]
        row = {"phase": "mixtral_exact", "case": label, "layers": 2,
               "prompts": [len(p) for p in prompts[:len(out)]],
               "per_request_equal": same, "ok": all(same)}
        emit(row)
        assert row["ok"], f"mixtral_exact: {label} != per request"
    model.target_cache = model.draft_cache = None
    model._batch_pool.clear()
    torch.cuda.empty_cache()

    from vispec_tpu_torch.spec.spec_model import SpecModel

    qmodel = SpecModel(model.tcfg, model.dcfg, model.spec, model.tparams, model.dparams,
                       max_len=2048, dtype=torch.float32, quantize_draft="int4",
                       quantize_kv=True, device=dev)
    q4_shapes, undo = _recording_q4_dispatch()
    _zero_launch_counts()
    try:
        spec = qmodel.specgenerate(prompt, max_new_tokens=64)
        ar = qmodel.ar_generate(prompt, max_new_tokens=64)
    finally:
        undo()
    counts = _launch_counts()
    same = spec.sequences[:164].tolist() == ar.sequences[:164].tolist()
    row = {"phase": "mixtral_exact", "case": "int8_kv_int4_draft", "layers": 2,
           "kv": "int8", "draft": "int4", "new_tokens": [spec.new_tokens, ar.new_tokens],
           "spec_equals_ar": same, "launches": counts, "q4_shapes_kmn": sorted(q4_shapes),
           "ok": same and spec.new_tokens >= 64 and counts["1b"] > 0 and counts["2"] > 0}
    emit(row)
    assert row["ok"], "mixtral_exact: quantized spec != AR"
    del model, qmodel
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    rows = [q4_case(dev, k, n, m, flush, prefix="mixtral_q4") for k, n, m in sorted(q4_shapes)]
    torch.cuda.empty_cache()
    return rows


class _CountContinuations:
    """Counts ``SpecModel``'s continuation prefills
    (``loop.spec_prefill_continue``) while in use."""

    def __enter__(self):
        from vispec_tpu_torch.spec import spec_model

        self.loop, self.calls = spec_model.spec_loop, 0
        self.real = self.loop.spec_prefill_continue

        def counted(*args, **kw):
            self.calls += 1
            return self.real(*args, **kw)

        self.loop.spec_prefill_continue = counted
        return self

    def __exit__(self, *exc):
        self.loop.spec_prefill_continue = self.real


def phase_snapshot_exact(dev):
    """Multi-turn snapshots at Vicuna-7B widths, 2 target layers, float32
    with TF32 off, over a float32 and an int8 target cache: a 100-token
    turn and 48 new tokens kept (``keep_hiddens``), then a second turn of 40
    tokens continued from its snapshot and a third of 30 from the second's,
    each equal to a full prefill of the whole conversation; then a 1,680-token
    suffix whose bucket overflows max_len takes the full prefill (no
    continuation), with the same tokens."""
    for quantized in (False, True):
        model = _full_width_model(dev, 2, torch.float32, seed=1, quantize_kv=quantized)
        rng = np.random.default_rng(12)
        r = model.specgenerate(rng.integers(3, 32000, 100).tolist(), max_new_tokens=48,
                               keep_hiddens=True)
        turns = []
        for new in (40, 30, 1680):
            ids = r.sequences.tolist() + rng.integers(3, 32000, new).tolist()
            snap = model.last_snapshot
            full = model.specgenerate(ids, max_new_tokens=48)
            with _CountContinuations() as c:
                r = model.specgenerate(ids, max_new_tokens=48, continue_from=snap,
                                       keep_hiddens=True)
            budget = min(48, model.max_len - len(ids) - model._cache_slack())
            turns.append({"prompt": len(ids), "cut": snap.cut_for(ids),
                          "continued": c.calls == 1, "equal": r.sequences.tolist()
                          == full.sequences.tolist(), "new_tokens": r.new_tokens,
                          "budget": budget})
        row = {"phase": "snapshot_exact", "layers": 2, "dtype": "float32",
               "cache": "int8" if quantized else "float32", "turns": turns,
               "ok": (all(t["equal"] and t["new_tokens"] >= t["budget"] for t in turns)
                      and [t["continued"] for t in turns] == [True, True, False])}
        emit(row)
        assert row["ok"], row
        del model
        torch.cuda.empty_cache()


def _hf_text_state_dict(g, cfg, experts: int, dev):
    """An HF-layout Llama (or, with ``experts``, Mixtral) state dict of
    random bf16 tensors on the card (norms ones)."""
    bf16 = torch.bfloat16
    d, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hkv = d // cfg["num_attention_heads"] * cfg["num_key_value_heads"]

    def w(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=bf16).mul_(0.02)

    sd = {"model.embed_tokens.weight": w(v, d), "lm_head.weight": w(v, d),
          "model.norm.weight": torch.ones(d, dtype=bf16, device=dev)}
    for li in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{li}."
        sd.update({p + "input_layernorm.weight": torch.ones(d, dtype=bf16, device=dev),
                   p + "post_attention_layernorm.weight": torch.ones(d, dtype=bf16,
                                                                     device=dev),
                   p + "self_attn.q_proj.weight": w(d, d), p + "self_attn.k_proj.weight":
                   w(hkv, d), p + "self_attn.v_proj.weight": w(hkv, d),
                   p + "self_attn.o_proj.weight": w(d, d)})
        if not experts:
            sd.update({p + "mlp.gate_proj.weight": w(i, d), p + "mlp.up_proj.weight": w(i, d),
                       p + "mlp.down_proj.weight": w(d, i)})
            continue
        sd[p + "block_sparse_moe.gate.weight"] = w(experts, d)
        for j in range(experts):
            q = p + f"block_sparse_moe.experts.{j}."
            sd.update({q + "w1.weight": w(i, d), q + "w2.weight": w(d, i),
                       q + "w3.weight": w(i, d)})
    return sd


def _write_hf_checkpoint(path, sd, cfg, shards=1, fmt="safetensors"):
    """``sd`` as an HF checkpoint directory: ``config.json`` and the
    weights in ``shards`` files (with an index when more than one), as
    safetensors (the port's writer) or ``pytorch_model.bin``.  Returns the
    bytes written."""
    from vispec_tpu_torch.convert.export import write_safetensors

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    keys = list(sd)
    parts = [keys[i::shards] for i in range(shards)]
    stem, ext = ("model", "safetensors") if fmt == "safetensors" else ("pytorch_model", "bin")
    names = ([f"{stem}.{ext}"] if shards == 1 else
             [f"{stem}-{i + 1:05d}-of-{shards:05d}.{ext}" for i in range(shards)])
    for name, part in zip(names, parts):
        if fmt == "safetensors":
            write_safetensors({k: sd[k] for k in part}, os.path.join(path, name))
        else:
            torch.save({k: sd[k].cpu() for k in part}, os.path.join(path, name))
    if shards > 1:
        with open(os.path.join(path, f"{stem}.{ext}.index.json"), "w") as f:
            json.dump({"weight_map": {k: n for n, part in zip(names, parts) for k in part}}, f)
    return sum(os.path.getsize(os.path.join(path, n)) for n in names)


def _same_tree(got: dict, want: dict, prefix=""):
    """Names of the leaves of ``got`` that are not bit-equal to ``want``'s."""
    bad = []
    for k, v in want.items():
        if isinstance(v, dict):
            bad += _same_tree(got[k], v, prefix + k + "/")
        elif not (got[k].dtype == v.dtype and torch.equal(got[k], v)):
            bad.append(prefix + k)
    return bad


def phase_from_pretrained_device(dev):
    """``SpecModel.from_pretrained(device="cuda")`` from checkpoints written
    under build/ in the HF layout: a Llama at Vicuna-7B widths (2 layers,
    bf16, two safetensors shards and an index; then the same as
    ``pytorch_model.bin``), a Mixtral at 8x7B widths (2 layers, three
    shards) and a ViSpec draft written by ``convert.export.save_draft``.
    Every loaded tensor must be bit-equal to its source converted on the
    card (``convert.hf`` / ``models.mixtral`` on the in-memory state dict),
    a few are checked against the source directly, and the loaded model
    decodes.  Reports the load seconds and GB/s (bytes on disk over the
    load's wall time)."""
    import shutil

    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.convert import export, hf
    from vispec_tpu_torch.models import draft, mixtral
    from vispec_tpu_torch.spec.spec_model import SpecModel

    root = os.path.join(ROOT, "build", "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    g = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    llama_cfg = VICUNA_HF
    mixtral_cfg = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
                   "num_hidden_layers": 2, "eos_token_id": 2, **MIXTRAL}
    dcfg = DraftConfig(**MIXTRAL_DRAFT)
    dparams = draft.init_params(dcfg, g, dev, bf16)
    ddir = os.path.join(root, "draft")
    draft_json = {"vocab_size": dcfg.vocab_size, "hidden_size": dcfg.hidden_size,
                  "intermediate_size": dcfg.intermediate_size, "num_hidden_layers": 1,
                  "num_attention_heads": dcfg.num_attention_heads,
                  "num_key_value_heads": dcfg.num_key_value_heads,
                  "max_position_embeddings": dcfg.max_position_embeddings,
                  "rms_norm_eps": dcfg.rms_norm_eps, "rope_theta": dcfg.rope_theta,
                  "bias": True}
    export.save_draft(dparams, ddir, draft_json)
    draft_bytes = os.path.getsize(os.path.join(ddir, "model.safetensors"))
    prompt = np.random.default_rng(13).integers(3, 32000, 60).tolist()
    cases = (("llama_safetensors_2_shards", llama_cfg, 2, "safetensors"),
             ("llama_pytorch_model_bin", llama_cfg, 1, "bin"),
             ("mixtral_safetensors_3_shards", mixtral_cfg, 3, "safetensors"))
    for name, cfg, shards, fmt in cases:
        experts = cfg.get("num_local_experts", 0)
        sd = _hf_text_state_dict(g, cfg, experts, dev)
        tdir = os.path.join(root, name)
        nbytes = _write_hf_checkpoint(tdir, sd, cfg, shards, fmt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = SpecModel.from_pretrained(tdir, ddir if experts else None, max_len=2048,
                                          dtype=bf16, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        on_card = next(iter(model.tparams["layers"].values())).device.type == "cuda"
        if experts:
            tcfg = hf.mixtral_config_from_hf(cfg)
            want = mixtral.convert_mixtral(sd, tcfg, bf16, device=dev)
        else:
            want = hf.convert_llama(sd, hf.llama_config_from_hf(cfg), bf16, device=dev)
        bad = _same_tree(model.tparams, want)
        lay = "model.layers.1."
        direct = [torch.equal(model.tparams["embed"], sd["model.embed_tokens.weight"]),
                  torch.equal(model.tparams["layers"]["wq"][1],
                              sd[lay + "self_attn.q_proj.weight"].T),
                  torch.equal(model.tparams["lm_head"], sd["lm_head.weight"].T)]
        if experts:
            i, last = tcfg.intermediate_size, experts - 1
            e = lay + f"block_sparse_moe.experts.{last}."
            direct += [torch.equal(model.tparams["layers"]["we_down"][1, last],
                                   sd[e + "w2.weight"].T),
                       torch.equal(model.tparams["layers"]["we_gate"][1][:, last * i:],
                                   sd[e + "w1.weight"].T)]
            bad += _same_tree(model.dparams, dparams, "draft/")
            nbytes += draft_bytes
        res = (model.specgenerate if experts else model.ar_generate)(prompt,
                                                                     max_new_tokens=16)
        row = {"phase": "from_pretrained_device", "case": name,
               "architecture": cfg["architectures"][0],
               "draft": "save_draft" if experts else None, "format": fmt, "shards": shards,
               "gb_on_disk": nbytes / 1e9, "load_s": load_s, "load_gb_per_s":
               nbytes / 1e9 / load_s, "on_card": on_card, "not_bit_equal": bad,
               "direct_checks": direct, "new_tokens": res.new_tokens,
               "ok": on_card and not bad and all(direct) and res.new_tokens >= 16}
        emit(row)
        assert row["ok"], row
        del model, want, sd
        shutil.rmtree(tdir)
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(root)


def phase_mixtral_full_depth(dev):
    """Mixtral-8x7B at MIXTRAL_LAYERS of its 32 layers in bfloat16 (8 experts, dense
    over experts as in the JAX package), its draft at the same widths,
    max_len 2048: a 128-token prompt, ``DEPTH_TOKENS`` new tokens by spec and by AR,
    three runs each (median and range of tok/s); kernel 1a's launches
    (3 + layers + 4 per dispatched spec round: the target verifies, the
    draft append, 3 expansion levels; layers per AR step); peak memory; then one
    ``PROFILE_TOKENS``-token spec run under torch.profiler (device busy ms, idle share)."""
    model = _mixtral_model(dev, MIXTRAL_LAYERS, torch.bfloat16, seed=0)
    prompt = np.random.default_rng(0).integers(3, 32000, 128).tolist()
    model.specgenerate(prompt, max_new_tokens=8)  # warm-up
    model.ar_generate(prompt, max_new_tokens=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    layers, depth = model.tcfg.num_hidden_layers, model.spec.depth
    runs = {"spec": [], "ar": []}
    launches_ok = True
    for _ in range(3):
        for label, gen in (("spec", model.specgenerate), ("ar", model.ar_generate)):
            _zero_launch_counts()
            res = gen(prompt, max_new_tokens=DEPTH_TOKENS)
            got = _launch_counts()["1a"]
            want = (depth + res.dispatched * (layers + 1 + depth) if label == "spec"
                    else res.dispatched * layers)
            launches_ok &= got == want and res.new_tokens >= DEPTH_TOKENS
            runs[label].append((res.new_tokens / res.decode_time, got, want, res))
    spec, ar = runs["spec"][-1][3], runs["ar"][-1][3]
    a, b = spec.sequences[128:], ar.sequences[128:]
    n = min(len(a), len(b))
    weights_gb = sum(t.numel() * t.element_size() for t in model.tparams["layers"].values()
                     ) / 1e9
    row = {"phase": "mixtral_full_depth", "layers": layers, "of_layers": 32,
           "dtype": "bfloat16", "experts": model.tcfg.num_local_experts,
           "max_len": model.max_len, "prompt": 128, "layer_weights_gb": weights_gb,
           "spec_tok_per_s": float(np.median([r[0] for r in runs["spec"]])),
           "spec_tok_per_s_range": [min(r[0] for r in runs["spec"]),
                                    max(r[0] for r in runs["spec"])],
           "ar_tok_per_s": float(np.median([r[0] for r in runs["ar"]])),
           "ar_tok_per_s_range": [min(r[0] for r in runs["ar"]),
                                  max(r[0] for r in runs["ar"])],
           "rounds": spec.rounds, "dispatched_rounds": spec.dispatched,
           "tau": float(np.mean([x + 1 for x in spec.acceptance_lengths])),
           "launches_1a_spec": [r[1] for r in runs["spec"]],
           "expected_spec": [r[2] for r in runs["spec"]],
           "launches_1a_per_round": (runs["spec"][-1][1] - depth) / spec.dispatched,
           "launches_ar": [r[1] for r in runs["ar"]], "expected_ar": [r[2] for r in runs["ar"]],
           "agreeing_prefix": int(np.argmin(np.append(a[:n] == b[:n], False))),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30, "ok": launches_ok}
    emit(row)
    assert row["ok"], row
    emit({"phase": f"profile_mixtral_spec_{PROFILE_TOKENS}_tokens",
          **_profile(lambda: model.specgenerate(prompt, max_new_tokens=PROFILE_TOKENS))})
    return model


def phase_serving_mixtral_full_depth(dev, model):
    """The engine over the 24-layer bfloat16 Mixtral: B = 4, pad buckets
    (128, 256, 512), 8 requests from seed 0 (prompts of 64-448, caps of
    64-128).  All complete with no failed request; requires 28 launches of
    1c per dispatched round (24 target verifies, the draft append, 3
    expansion levels) and 3 of 1a per prefill."""
    reqs = _serving_requests(8)
    model.serving_engine(batch_size=4, pad_bucket=(128, 256, 512)).run_all(
        [{"input_ids": reqs[0][0], "max_new_tokens": 4}])  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    eng, outs, latency, wall = _serve(model, reqs, chunk_rounds=8)
    counts = _launch_counts()
    rounds, prefills = eng.stats["rounds"], eng._n_prefills
    depth = model.spec.depth
    want = {"1a": depth * prefills, "1b": 0,
            "1c": (model.tcfg.num_hidden_layers + 1 + depth) * rounds, "1c_int8": 0, "2": 0}
    tokens = sum(len(o) for o in outs)
    row = {"phase": "serving_mixtral_full_depth", "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16", "max_len": model.max_len, "batch_size": 4,
           "requests": len(reqs), "prompt_lens": [len(p) for p, _ in reqs],
           "caps": [c for _, c in reqs], "tokens": tokens, "wall_s": wall,
           "tok_per_s": tokens / wall, "latency_p50_s": float(np.median(latency)),
           "latency_max_s": max(latency), "rounds_dispatched": rounds, "prefills": prefills,
           "launches": counts, "expected": want,
           "launches_1c_per_round": counts["1c"] / rounds, "errors": dict(eng.errors),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 2**30}
    row["ok"] = (counts == want and not eng.errors
                 and all(_complete(o, c, model) for o, (_, c) in zip(outs, reqs)))
    emit(row)
    assert row["ok"], row
    del eng
    torch.cuda.empty_cache()
    return row


def phase_snapshot_full_depth(dev, model):
    """Vicuna-7B at DEPTH_LAYERS layers in bfloat16: a 1,024-token turn and 128 new
    tokens kept as a snapshot, then a 64-token turn.  The continuation
    prefill (the snapshot's rows copied in, the suffix through the target,
    the draft's boundary row) against the full prefill of the whole
    conversation: medians (and ranges) of 10 calls each, CUDA events; then
    both decode 32 tokens and their agreeing prefix is reported (bf16
    argmax near-ties: not required)."""
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.spec import loop
    from vispec_tpu_torch.spec.spec_model import _bucket, output_rows, plan_prompt

    rng = np.random.default_rng(14)
    r1 = model.specgenerate(rng.integers(3, 32000, 1024).tolist(), max_new_tokens=128,
                            keep_hiddens=True)
    snap = model.last_snapshot
    ids = r1.sequences.tolist() + rng.integers(3, 32000, 64).tolist()
    plen, pad, max_out = snap.cut_for(ids), _bucket(len(ids)), output_rows(model.spec, 128)
    sampling = loop.SamplingParams()

    def continuation():
        return model._prefill_from_snapshot(snap, ids, plen, sampling, None, max_out)

    def full():
        prompt = model._padded_prompt(ids, pad)
        plan, span = plan_prompt(model.dcfg, prompt.shifted, prompt.n_spans, len(ids), pad,
                                 dev)
        return loop.spec_prefill(model.tparams, model.dparams, model.tcfg, model.dcfg,
                                 model.spec, plan, sampling, prompt.embeds,
                                 kv.reset(model.target_cache), kv.reset(model.draft_cache),
                                 max_out, span)

    with torch.no_grad():
        _, cont_ms, cont_range = _median_cuda_ms(continuation)
        _, full_ms, full_range = _median_cuda_ms(full)
    with _CountContinuations() as c:
        cont = model.specgenerate(ids, max_new_tokens=32, continue_from=snap)
    whole = model.specgenerate(ids, max_new_tokens=32)
    a, b = cont.sequences[len(ids):], whole.sequences[len(ids):]
    n = min(len(a), len(b))
    snap_gb = sum(t.numel() * t.element_size() for t in (snap.t_k, snap.t_v, snap.d_k,
                                                          snap.d_v)) / 1e9
    row = {"phase": "snapshot_full_depth", "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16", "conversation": len(ids), "cut": plen,
           "suffix": len(ids) - plen, "pad_len": pad, "snapshot_gb": snap_gb,
           "continuation_prefill_ms": cont_ms, "continuation_prefill_ms_range": cont_range,
           "full_prefill_ms": full_ms, "full_prefill_ms_range": full_range,
           "full_over_continuation": full_ms / cont_ms, "continued": c.calls == 1,
           "new_tokens": [cont.new_tokens, whole.new_tokens],
           "agreeing_prefix": int(np.argmin(np.append(a[:n] == b[:n], False)))}
    row["ok"] = row["continued"] and cont.new_tokens >= 32
    emit(row)
    assert row["ok"], row
    model.last_snapshot = None
    torch.cuda.empty_cache()
    return row


def phase_autotune_full_depth(dev, model, name):
    """``autotune_total_token`` on a full-depth model: 20 target forwards
    at each candidate width (40, 48, 50, 56, 60) from a reset cache, timed
    by CUDA events; ms per forward and the weighted score of each, and the
    pick.  The model's ``spec`` is restored after."""
    spec, iters = model.spec, 20
    weights = dict(zip((40, 48, 50, 56, 60), (1.0, 1.05, 1.07, 1.1, 1.13)))
    pick = model.autotune_total_token(iters=iters)
    scores = model.last_autotune_s
    model.spec = spec
    row = {"phase": "autotune_full_depth", "model": name,
           "layers": model.tcfg.num_hidden_layers, "dtype": "bfloat16",
           "ms_per_forward": {c: t * weights[c] / iters * 1e3 for c, t in scores.items()},
           "weighted_ms": {c: t / iters * 1e3 for c, t in scores.items()}, "pick": pick,
           "ok": pick in weights}
    emit(row)
    assert row["ok"], row
    return row


# ---------------------------------------------------------------------------
# The evaluation harness and draft training
# ---------------------------------------------------------------------------


class _WordTokenizer:
    """The script's own tokenizer for the harness (the card's machine has no
    ``transformers``): whitespace-separated words; a word of the list it
    was built on is its id (from 3), ``w<id>`` is ``<id>``, any other word a
    crc32 bucket.  ``decode`` writes the list's word or ``w<id>``, so a
    decoded answer tokenizes back to its ids.  It has what the harness
    reads: ``__call__(text).input_ids``, ``decode(ids, ...)`` and
    ``special_tokens_map``."""

    special_tokens_map = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}

    def __init__(self, texts, vocab=32000):
        words = sorted({w for t in texts for w in t.split()})[: vocab - 3]
        self.vocab = vocab
        self.ids = {w: 3 + i for i, w in enumerate(words)}
        self.words = {i: w for w, i in self.ids.items()}

    def _id(self, word):
        if word in self.ids:
            return self.ids[word]
        m = re.fullmatch(r"w(\d+)", word)
        if m and int(m.group(1)) < self.vocab:
            return int(m.group(1))
        return 3 + zlib.crc32(word.encode()) % (self.vocab - 3)

    def __call__(self, text):
        return types.SimpleNamespace(input_ids=[1] + [self._id(w) for w in text.split()])

    def decode(self, ids, spaces_between_special_tokens=False, skip_special_tokens=False):
        return " ".join(self.words.get(int(i), f"w{int(i)}") for i in ids)


def _mt_bench(n):
    """The first ``n`` vendored MT-bench questions (both turns) and a
    tokenizer over all 80 questions' words and the vicuna template's."""
    from vispec_tpu_torch.evaluation import benchmarks, harness

    qs = list(benchmarks.iter_questions("vicuna", None, os.path.join(ROOT, "build", "none")))
    texts = [t for q in qs for t in q.turns] + [harness.vicuna_prompt(["x"], ["y"])]
    return qs[:n], _WordTokenizer(texts)


def _fresh(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return path


def _run_eval_pair(model, qs, tok, max_new, tag):
    """``run_eval`` over ``qs``, spec then baseline, each with the kernels'
    launch counts of its run; returns (records, paths, counts) by mode."""
    from vispec_tpu_torch.evaluation import harness

    recs, paths, counts = {}, {}, {}
    for mode in ("spec", "baseline"):
        paths[mode] = _fresh(os.path.join(ROOT, "build", "eval", f"{tag}_{mode}.jsonl"))
        _zero_launch_counts()
        recs[mode] = harness.run_eval(model, qs, paths[mode], baseline=mode == "baseline",
                                      max_new_tokens=max_new, num_warmup=0, tokenizer=tok,
                                      conv_template="vicuna", model_id=f"{tag}-{mode}")
        counts[mode] = _launch_counts()
    return recs, paths, counts


def phase_eval_exact(dev):
    """The harness on the card: ``run_eval`` over the first 2 vendored
    MT-bench questions (both turns, the vicuna template, 64 new tokens a
    turn) on a 2-layer float32 model at Vicuna-7B widths, spec and
    baseline.  Gates: every spec answer equals, token for token, the AR
    answer to the same conversation (a spec turn may commit a token past
    the budget, as in the JAX package, so the baseline's second-turn
    prompt can differ: each spec turn's prompt is rebuilt and decoded by
    ``ar_generate``); the baseline's first answers are those AR answers;
    ``speed.speedup_report`` of the two answer files is finite."""
    from vispec_tpu_torch.evaluation import harness, speed

    model = _full_width_model(dev, 2, torch.float32, seed=3)
    qs, tok = _mt_bench(2)
    recs, paths, counts = _run_eval_pair(model, qs, tok, 64, "exact")
    same = True
    for q, srec, brec in zip(qs, recs["spec"], recs["baseline"]):
        for j, answer in enumerate(srec["turns"]):
            ids = tok(harness.vicuna_prompt(q.turns[: j + 1], srec["turns"][:j])).input_ids
            ar = tok.decode(model.ar_generate(ids, max_new_tokens=64).sequences[len(ids):])
            ar = ar.split()
            same &= answer.split()[: len(ar)] == ar and len(ar) == 64
            if j == 0:
                same &= brec["turns"][0].split() == ar
    rep = speed.speedup_report(paths["spec"], paths["baseline"])
    finite = all(np.isfinite(v) for v in rep.values())
    row = {"phase": "eval_exact", "layers": 2, "dtype": "float32", "questions": len(qs),
           "turns": sum(len(r["turns"]) for r in recs["spec"]),
           "new_tokens": [r["new_tokens"] for r in recs["spec"]],
           "spec_equals_ar": same, "report": rep,
           "launches_1a": {m: c["1a"] for m, c in counts.items()},
           "ok": same and finite and len(recs["spec"]) == 2}
    emit(row)
    assert row["ok"], row
    del model
    torch.cuda.empty_cache()


def phase_eval_full_depth(dev, model, serving_row):
    """The harness at Vicuna-7B, DEPTH_LAYERS layers, bfloat16 (the
    ``full_width_depth`` model): ``run_eval`` spec and baseline over the
    first ``EVAL_QUESTIONS`` MT-bench questions, both turns,
    ``EVAL_TOKENS`` new tokens a turn; tok/s of each
    (``speed.speedup_report``, wall time closed on the device), the mean
    acceptance length, the speed-up and kernel 1a's launches per turn.
    Then ``bench_batch.arrival_bench`` on the B = 4 engine: 8 requests of
    ``ARRIVAL_TOKENS`` new tokens, Poisson arrivals at half the saturated
    request rate that ``serving_full_depth`` measured in this run (0.5 x
    its tok/s / ARRIVAL_TOKENS requests a second); its rate, throughput and latency percentiles
    (completion minus scheduled arrival), and kernel 1c's launches."""
    from vispec_tpu_torch.evaluation import bench_batch, speed

    qs, tok = _mt_bench(EVAL_QUESTIONS)
    recs, paths, counts = _run_eval_pair(model, qs, tok, EVAL_TOKENS, "full_depth")
    rep = speed.speedup_report(paths["spec"], paths["baseline"])
    turns = sum(len(r["turns"]) for r in recs["spec"])
    agree = []  # words (tokens) in common at the start of each turn's answers
    for r, q in zip(recs["spec"], recs["baseline"]):
        for a, b in zip(r["turns"], q["turns"]):
            a, b = a.split(), b.split()
            n = min(len(a), len(b))
            agree.append(int(np.argmin(np.append(np.array(a[:n]) == np.array(b[:n]), False))))
    row = {"phase": "eval_full_depth", "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16",
           "questions": len(qs), "turns": turns, "max_new_tokens": EVAL_TOKENS, **rep,
           "new_tokens_spec": [r["new_tokens"] for r in recs["spec"]],
           "new_tokens_baseline": [r["new_tokens"] for r in recs["baseline"]],
           "wall_time_spec": [r["wall_time"] for r in recs["spec"]],
           "wall_time_baseline": [r["wall_time"] for r in recs["baseline"]],
           "agreeing_prefix_per_turn": agree,
           "launches_1a_per_turn": {m: c["1a"] / turns for m, c in counts.items()}}
    row["ok"] = (all(np.isfinite(v) for v in rep.values())
                 and all(n >= 1 for r in recs["spec"] for n in r["new_tokens"])
                 and counts["spec"]["1a"] > 0 and counts["baseline"]["1a"] > 0)
    emit(row)
    assert row["ok"], row

    rate = 0.5 * serving_row["tok_per_s"] / ARRIVAL_TOKENS
    _zero_launch_counts()
    arr = bench_batch.arrival_bench(model, 4, ARRIVAL_TOKENS, rate, 8, seed=0, vocab=32000)
    launches = _launch_counts()
    toks = arr.pop("tokens")
    per_round = model.tcfg.num_hidden_layers + 1 + model.spec.depth
    row = {"phase": "arrival_full_depth", "layers": model.tcfg.num_hidden_layers,
           "dtype": "bfloat16",
           "saturated_tok_per_s": serving_row["tok_per_s"], **arr,
           "request_tokens": [len(t) for t in toks], "launches_1c": launches["1c"]}
    row["ok"] = (all(len(t) == ARRIVAL_TOKENS or (t and t[-1] == model.eos_token_id)
                     for t in toks)
                 and launches["1c"] > 0 and launches["1c"] % per_round == 0)
    emit(row)
    assert row["ok"], row


def _train_sample(seed, s, d, span=None, gen_from=None):
    """A fabricated training record of ``s`` rows at width ``d``; ``span``
    = (start, stop) image rows; the loss mask on from ``gen_from``."""
    rng = np.random.default_rng(seed)
    img = np.zeros(s, bool)
    if span is not None:
        img[span[0]:span[1]] = True
    mask = np.zeros(s, np.float32)
    mask[(gen_from if gen_from is not None else s // 3):] = 1.0
    return {"input_ids": rng.integers(0, 256, s).astype(np.int32),
            "hidden_state": rng.normal(0, 1, (s, d)).astype(np.float32),
            "inputs_embeds": rng.normal(0, 1, (s, d)).astype(np.float32),
            "loss_mask": mask, "image_mask": img}


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.detach().clone().to(device)
            for k, v in tree.items()}


def _tree_max_diff(a, b):
    return max((_tree_max_diff(v, b[k]) if isinstance(v, dict)
                else (v.float().cpu() - b[k].float().cpu()).abs().max().item())
               for k, v in a.items())


def _trees_equal(a, b):
    return all(_trees_equal(v, b[k]) if isinstance(v, dict) else torch.equal(v, b[k])
               for k, v in a.items())


def phase_train_exact(dev):
    """Training on the card against the same steps on the CPU, at toy widths
    in float32 (hidden 64, 4 heads over 2, head_dim 16, vocab 256), from one
    state and one batch (an image span included): three ``train_step``s
    (mtp_steps 2, warm-up 2, so the rate is non-zero from step 1), one
    ``train_step_stage1`` and one ``train_step_medusa`` (no warm-up).  Gates:
    the parameters within 1% of the learning rate of the CPU's after every
    step, the losses within 1e-4 (relative); ``getkacc``'s batched rollout
    (16 prefixes, kernel 1c over the float32 draft cache) gives the tokens
    of one rollout per prefix (kernel 1a) and the CPU's accuracies."""
    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.models import medusa
    from vispec_tpu_torch.train import step as tstep
    from vispec_tpu_torch.train import trainer

    cpu, lr = torch.device("cpu"), 2e-3
    dcfg = DraftConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=512)
    g = torch.Generator().manual_seed(7)
    base = draft_mod.init_params(dcfg, g, cpu, torch.float32)
    base["img_fc_w"] += 0.05 * torch.randn(base["img_fc_w"].shape, generator=g)
    base["fc_b"] += 0.1 * torch.randn(base["fc_b"].shape, generator=g)
    med = {"heads_w": 0.05 * torch.randn((medusa.NUM_HEADS, 64, 64), generator=g),
           "heads_b": 0.05 * torch.randn((medusa.NUM_HEADS, 64), generator=g)}
    head = 0.3 * torch.randn((64, 256), generator=g)
    cfg = trainer.TrainConfig(lr=lr, max_len=64, mtp_steps=2, max_images=2,
                              max_span_bucket=16)
    sample = _train_sample(5, 60, 64, span=(6, 20))
    ex = trainer.prepare_example(sample, cfg, dcfg, np.random.default_rng(5))
    batches = {cpu: trainer.batch_examples([ex], cpu)[0],
               dev: trainer.batch_examples([ex], dev)[0]}
    heads = {cpu: head, dev: head.to(dev)}
    steps = {
        "train_step": (base, 2, 3, lambda p, o, b, h, opt: tstep.train_step(
            p, o, dcfg, h, b, opt, mtp_steps=2, max_span=16)),
        "train_step_stage1": (base, 0, 1, lambda p, o, b, h, opt: tstep.train_step_stage1(
            p, o, dcfg, h, b, opt, max_span=16)),
        "train_step_medusa": (med, 0, 1, lambda p, o, b, h, opt: tstep.train_step_medusa(
            p, o, h, b, opt)),
    }
    row = {"phase": "train_exact", "dtype": "float32", "hidden": 64, "lr": lr}
    ok = True
    for name, (params, warmup, n, fn) in steps.items():
        opt = tstep.make_optimizer(lr, warmup, 1000)
        side = {d: [_tree_to(params, d)] for d in (cpu, dev)}
        for d in side:
            side[d].append(opt.init(side[d][0]))
        diffs, losses = [], []
        for _ in range(n):
            out = {}
            for d in (cpu, dev):
                p, o, m = fn(side[d][0], side[d][1], batches[d], heads[d], opt)
                side[d] = [p, o]
                out[d] = float(m["loss"])
            diffs.append(_tree_max_diff(side[dev][0], side[cpu][0]))
            losses.append([out[dev], out[cpu]])
        good = (max(diffs) <= 0.01 * lr
                and all(abs(a - b) <= 1e-4 * max(abs(b), 1.0) for a, b in losses))
        row[name] = {"steps": n, "max_param_diff": diffs, "loss_card_cpu": losses,
                     "ok": good}
        ok &= good

    # bf16 products (the card's float32-output bf16 GEMM under autograd):
    # the MTP loss's gradients against the CPU's, per leaf
    grads = {}
    for d in (cpu, dev):
        leaves = {path: t.detach().clone().to(d).requires_grad_(True)
                  for path, t in tstep.leaves(base) if path != "embed"}
        tree = tstep._rebuild(base, {path: leaves.get(path, t.to(d))
                                     for path, t in tstep.leaves(base)})
        loss, _ = tstep.mtp_forward(tstep.bf16_compute(tree), dcfg,
                                    tstep.bf16_compute(heads[d]),
                                    tstep.bf16_compute(batches[d]), 2, 16)
        grads[d] = dict(zip(leaves, (x.cpu() for x in torch.autograd.grad(loss, list(
            leaves.values())))))
    rel = {path: ((grads[dev][path] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
           for path, g in grads[cpu].items()}
    row["bf16_grad_rel_err_max"] = max(rel.values())
    row["bf16_grad_rel_err_worst_leaf"] = max(rel, key=rel.get)
    # each bf16 side is held within 1e-2 of JAX's bf16 gradients (the CPU by
    # tests/test_torch_training.py): the two sides within twice that
    ok &= max(rel.values()) <= 2e-2

    # getkacc: the batched rollout against one rollout per prefix, on the card
    params = _tree_to(base, dev)
    _zero_launch_counts()
    accs = trainer.getkacc(params, dcfg, heads[dev], sample, max_length=4,
                           max_prefixes=16, max_len=64, max_span=16)
    kacc_launches = _launch_counts()
    accs_cpu = trainer.getkacc(base, dcfg, head, sample, max_length=4, max_prefixes=16,
                               max_len=64, max_span=16)
    hidden = torch.as_tensor(sample["hidden_state"], device=dev)
    embeds = torch.as_tensor(sample["inputs_embeds"], device=dev)
    h_pads, e_pads, plans, seq = [], [], [], []
    _zero_launch_counts()
    for pre_len in range(3, 60, 4)[:16]:
        plan, _ = draft_mod.make_prefill_plan(sample["image_mask"][1:pre_len], pre_len - 1,
                                              dcfg.num_q, 64, max_images=8, max_span=16,
                                              device=dev)
        h = trainer._pad_rows(hidden[:pre_len - 1], 64)
        e = trainer._pad_rows(embeds[1:pre_len], 64)
        seq.append(trainer._kacc_rollout_one(params, dcfg, heads[dev], h, e, plan, 70, 4, 16))
        h_pads.append(h)
        e_pads.append(e)
        plans.append(plan)
    seq_launches = _launch_counts()
    _zero_launch_counts()
    batched = trainer._kacc_rollout_batched(
        params, dcfg, heads[dev], torch.stack(h_pads), torch.stack(e_pads),
        draft_mod.PrefillPlan(*(torch.stack(fs) for fs in zip(*plans))), 70, 4, 16)
    batched_launches = _launch_counts()
    same = torch.equal(batched.cpu(), torch.stack(seq).cpu())
    row["getkacc"] = {"prefixes": len(plans), "k": 4, "batched_equals_sequential": same,
                      "accs_card": accs, "accs_cpu": accs_cpu,
                      "launches_batched": batched_launches, "launches_sequential": seq_launches,
                      "launches_getkacc": kacc_launches}
    ok &= (same and accs == accs_cpu and batched_launches["1c"] == 4
           and batched_launches["1a"] == 0 and seq_launches["1a"] == 4 * len(plans)
           and kacc_launches["1c"] == 4)
    row["ok"] = ok
    emit(row)
    assert row["ok"], row


def phase_train_full_width(dev, model):
    """Training at Vicuna-7B width.  ``generate_sample`` with the
    DEPTH_LAYERS-layer bfloat16 target (the ``full_width_depth`` model)
    builds one sample: a 256-token MT-bench prompt and 256 generated tokens
    (kernel 1a at a launch a layer a step).  Then 10 ``train_step``s of a draft at the 7B's widths
    (float32 master weights, ``bf16=True``, bs 1, mtp_steps 2, max_len 512,
    lr 1e-5 without warm-up) on that one sample: median step ms, peak
    memory, and the loss falling from the first step to the last.  Then
    ``save_state`` / ``load_state`` (identical tensors) and ``getkacc`` at
    16 prefixes and max_length 5: its time and kernel 1c's launches (one a
    rollout step, over the float32 draft cache at B = 16, S = 1)."""
    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.evaluation import harness
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.spec.spec_model import padded_text_embeds
    from vispec_tpu_torch.train import data_gen, step as tstep, trainer

    qs, tok = _mt_bench(80)
    ids = [i for q in qs for i in tok(harness.vicuna_prompt([q.turns[0]], [])).input_ids]
    ids = ids[:256]
    embeds = padded_text_embeds(model.tparams, ids, 256, dev)
    never = model.tcfg.vocab_size  # no id reaches it: every sample runs its budget
    data_gen.generate_sample(model.tparams, model.tcfg, embeds, 256, None,
                             kv.reset(model.target_cache), max_new_tokens=16,
                             eos_token_id=never)  # warm-up
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    sample, cache = data_gen.generate_sample(model.tparams, model.tcfg, embeds, 256, None,
                                             kv.reset(model.target_cache),
                                             max_new_tokens=256, eos_token_id=never)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = _launch_counts()
    model.target_cache = kv.reset(cache)
    steps_run = gen_launches["1a"] / model.tcfg.num_hidden_layers
    row = {"phase": "train_full_width", "sample_rows": int(sample["hidden_state"].shape[0]),
           "generated": int(sample["loss_mask"].sum()), "generate_s": gen_s,
           "generate_tok_per_s": 256 / gen_s, "launches_1a": gen_launches["1a"],
           "steps_dispatched": steps_run}
    ok = (row["sample_rows"] == 512 and row["generated"] == 256
          and gen_launches["1a"] % model.tcfg.num_hidden_layers == 0
          and 256 <= steps_run <= 256 + 2 * 16 and gen_launches["1c"] == 0)

    dcfg = DraftConfig()
    g = torch.Generator(device=dev).manual_seed(11)
    dparams = draft_mod.init_params(dcfg, g, dev, torch.float32)
    head_w = model.tparams["lm_head"].float()
    cfg = trainer.TrainConfig(lr=1e-5, max_len=512, mtp_steps=2, warmup_steps=0, bf16=True)
    ex = trainer.prepare_example(sample, cfg, dcfg, np.random.default_rng(0))
    batch, _ = trainer.batch_examples([ex], dev)
    opt = tstep.make_optimizer(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.grad_clip)
    state = opt.init(dparams)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        dparams, state, metrics = tstep.train_step(dparams, state, dcfg, head_w, batch, opt,
                                                   mtp_steps=2, max_span=cfg.max_span_bucket,
                                                   bf16=True)
        losses.append(float(metrics["loss"]))  # a readback: the step is done
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    row.update(train_steps=10, step_ms_median=float(np.median(times)),
               step_ms_range=[min(times), max(times)], step_ms=times, losses=losses,
               loss_falls=losses[-1] < losses[0], peak_mem_gb=peak,
               draft_params=sum(t.numel() for _, t in tstep.leaves(dparams)))
    ok &= losses[-1] < losses[0] and all(np.isfinite(losses))

    cpdir = os.path.join(ROOT, "build", "train_state")
    t0 = time.perf_counter()
    path = trainer.save_state(cpdir, 0, dparams, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    epoch, params2, state2 = trainer.load_state(path, device=dev)
    load_s = time.perf_counter() - t0
    same = (epoch == 0 and state2.count == state.count and _trees_equal(params2, dparams)
            and _trees_equal(state2.mu, state.mu) and _trees_equal(state2.nu, state.nu))
    state_gb = os.path.getsize(path) / 1e9
    os.remove(path)
    del params2, state2
    row.update(state_round_trip=same, state_gb=state_gb, save_s=save_s, load_s=load_s)
    ok &= same

    del state
    torch.cuda.empty_cache()
    trainer.getkacc(dparams, dcfg, head_w, sample, max_length=5, max_prefixes=16,
                    max_len=512, max_span=64)  # warm-up
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    accs = trainer.getkacc(dparams, dcfg, head_w, sample, max_length=5, max_prefixes=16,
                           max_len=512, max_span=64)
    torch.cuda.synchronize()
    kacc_s = time.perf_counter() - t0
    kacc = _launch_counts()
    row.update(getkacc=accs, getkacc_s=kacc_s, getkacc_launches=kacc)
    ok &= kacc["1c"] == 5 and kacc["1a"] == 0
    row["ok"] = ok
    emit(row)
    assert row["ok"], row
    del dparams, head_w
    torch.cuda.empty_cache()


def phase_train_vlm_data_gen(dev, models):
    """Image-conditioned training data at LLaVA-1.5-7B (DEPTH_LAYERS layers bfloat16,
    the ``llava_full_depth`` model): ``generate_vlm_sample`` with one
    336x336 image (576 image tokens) and 64 generated tokens, then one
    ``train_step`` (float32 master, ``bf16=True``, mtp_steps 2, no warm-up)
    of a fresh draft at the 7B's widths whose plan has that image span, at
    the span's own bucket: the image adaptor's gradient path.  Gates: the
    sample's image mask is the 576-row span, the continuation is the
    target's own, and the step moves the adaptor and ``img_fc``."""
    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.spec.spec_model import _bucket
    from vispec_tpu_torch.train import data_gen, step as tstep, trainer

    model = models["llava-1.5"]
    req = _image_request(model, (336, 336), seed=40)
    ids, n = req["input_ids"], len(req["input_ids"])
    pixels = torch.as_tensor(req["pixel_values"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample = data_gen.generate_vlm_sample(model, ids, pixel_values=pixels,
                                          image_size=(336, 336), max_new_tokens=64)
    gen_s = time.perf_counter() - t0
    ar = model.ar_generate(ids, max_new_tokens=64, pixel_values=pixels,
                           image_size=(336, 336))
    gen = sample["input_ids"][n:].tolist()
    row = {"phase": "train_vlm_data_gen", "prompt": n, "image_tokens": 576,
           "generate_s": gen_s, "sample_rows": int(sample["hidden_state"].shape[0]),
           "image_mask_rows": int(sample["image_mask"].sum()),
           "continuation_equals_ar": gen == ar.sequences[n:n + len(gen)].tolist()}
    ok = (row["image_mask_rows"] == 576 and sample["loss_mask"][:n].sum() == 0
          and len(gen) == 64 and np.isfinite(sample["hidden_state"]).all()
          and row["continuation_equals_ar"])

    dcfg = DraftConfig(vocab_size=LLAVA_VOCAB)
    g = torch.Generator(device=dev).manual_seed(12)
    dparams = draft_mod.init_params(dcfg, g, dev, torch.float32)
    head_w = model.tparams["lm_head"].float()
    cfg = trainer.TrainConfig(lr=1e-5, max_len=768, mtp_steps=2, warmup_steps=0, bf16=True)
    ex = trainer.prepare_example(sample, cfg, dcfg, np.random.default_rng(0))
    batch, span = trainer.batch_examples([ex], dev)
    before = {k: v.clone() for k, v in (("adaptor_wk", dparams["adaptor"]["wk"]),
                                        ("adaptor_q", dparams["adaptor"]["q"]),
                                        ("img_fc_w", dparams["img_fc_w"]))}
    opt = tstep.make_optimizer(cfg.lr, 0, cfg.total_steps, cfg.grad_clip)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dparams, _, metrics = tstep.train_step(dparams, opt.init(dparams), dcfg, head_w, batch,
                                           opt, mtp_steps=2, max_span=_bucket(span, 64),
                                           bf16=True)
    loss = float(metrics["loss"])
    step_ms = (time.perf_counter() - t0) * 1e3
    after = {"adaptor_wk": dparams["adaptor"]["wk"], "adaptor_q": dparams["adaptor"]["q"],
             "img_fc_w": dparams["img_fc_w"]}
    moved = {k: (after[k] - v).abs().max().item() for k, v in before.items()}
    row.update(span=span, max_span=_bucket(span, 64), step_ms=step_ms, loss=loss,
               moved=moved, plan_images=int(batch.plans.num_images[0]))
    ok &= np.isfinite(loss) and all(v > 0 for v in moved.values())
    row["ok"] = ok
    emit(row)
    assert row["ok"], row
    del dparams, head_w, batch
    model.target_cache = None
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Multi-device inference: worlds of ranks that share the card over gloo
# ---------------------------------------------------------------------------

# (mode, tp, pp, sp, options): each at 2 layers in float32, Vicuna-7B widths
# (Mixtral-8x7B's for mixtral_ep2); the batch case runs on the tp2 model
PARALLEL_EXACT = (
    ("tp2", 2, 1, 1, {}),
    ("pp2", 1, 2, 1, {}),
    ("pp2_sp2", 1, 2, 2, {}),
    ("tp2_int4_draft_int8_kv", 2, 1, 1, {"quantize_draft": "int4", "quantize_kv": True}),
    ("mixtral_ep2", 2, 1, 1, {"mixtral": True}),
)
PARALLEL_WORLD_EXACT = 4  # pp2_sp2 needs four ranks; the others take dp 2
PARALLEL_WORLD_FULL = 2
PARALLEL_MIXTRAL_LAYERS = 8  # of 32: two ranks' bf16 shards and one full copy at a time
PARALLEL_BATCH = (40, 90, 130)  # specgenerate_batch prompts of the tp2 case
# new tokens of each full-width parallel run: two ranks on one card decode
# at 4-19 tok/s, held back by ~2 ms of host a collective (32 before slice
# 14's phases, 16 before slice 15's)
PARALLEL_TOKENS = 8
# new tokens of each parallel_exact run (64 before slice 14's phases, 32
# before slice 15's)
PARALLEL_EXACT_TOKENS = 16


def _parallel_model(dev, opts):
    """The float32 2-layer model of a parallel_exact mode (full_width_exact's
    and mixtral_exact's seeds) and its prompt."""
    if opts.get("mixtral"):
        return (_mixtral_model(dev, 2, torch.float32, seed=9),
                np.random.default_rng(9).integers(3, 32000, 100).tolist())
    quant = {k: v for k, v in opts.items() if k in ("quantize_draft", "quantize_kv")}
    return (_full_width_model(dev, 2, torch.float32, seed=1, **quant),
            np.random.default_rng(1).integers(3, 32000, 100).tolist())


def _staggered_shard(mesh, build, pp, sp):
    """Each rank in turn builds the whole model and keeps its shard, so that
    one whole copy at a time lives on the shared card."""
    import torch.distributed as dist

    model = None
    for turn in range(dist.get_world_size()):
        if turn == mesh.rank:
            model = build()
            model.shard_over(mesh, pp=pp, sp=sp)
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return model


def _rank_exact(dev):
    """One rank of the parallel_exact world: every mode's spec and AR tokens,
    its kernel launches, collectives and int4 shapes; the tp2 model also
    decodes a batch."""
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.parallel import sharding

    out = {}
    for mode, tp, pp, sp, opts in PARALLEL_EXACT:
        mesh = meshmod.make_mesh(tp=tp, pp=pp, sp=sp, device="cuda")
        model = _staggered_shard(mesh, lambda: _parallel_model(dev, opts)[0], pp > 1, sp > 1)
        prompt = np.random.default_rng(9 if opts.get("mixtral") else 1).integers(
            3, 32000, 100).tolist()
        q4_shapes, undo = _recording_q4_dispatch()
        _zero_launch_counts()
        sharding.COLLECTIVES.reset()
        try:
            spec = model.specgenerate(prompt, max_new_tokens=PARALLEL_EXACT_TOKENS)
            spec_counts, spec_coll = _launch_counts(), dict(sharding.COLLECTIVES.calls)
            ar = model.ar_generate(prompt, max_new_tokens=PARALLEL_EXACT_TOKENS)
        finally:
            undo()
        n = len(prompt) + PARALLEL_EXACT_TOKENS
        row = {"mesh": mesh.describe(), "spec": spec.sequences[:n].tolist(),
               "ar": ar.sequences[:n].tolist(), "dispatched": spec.dispatched,
               "launches_spec": spec_counts, "launches_all": _launch_counts(),
               "collectives_spec": spec_coll,
               "local_wq": list(model.tparams["layers"]["wq"].shape),
               "q4_shapes": sorted(q4_shapes)}
        if mode == "tp2":
            rng = np.random.default_rng(9)
            prompts = [rng.integers(3, 32000, n).tolist() for n in PARALLEL_BATCH]
            refs = [model.specgenerate(p, max_new_tokens=32).sequences[len(p):].tolist()
                    for p in prompts]
            _zero_launch_counts()
            got = model.specgenerate_batch([{"input_ids": p} for p in prompts],
                                           max_new_tokens=32)
            row["batch_equal"] = [o.sequences[len(p):len(p) + 32].tolist() == r[:32]
                                  for p, o, r in zip(prompts, got, refs)]
            row["launches_batch"] = _launch_counts()
        out[mode] = row
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _rank_full_run(model, prompt, tokens):
    """Warm-up, then spec and AR ``tokens`` each: tok/s, kernel launches,
    collectives and their host ms, peak memory; one spec run profiled."""
    from vispec_tpu_torch.parallel import sharding

    model.specgenerate(prompt, max_new_tokens=8)
    model.ar_generate(prompt, max_new_tokens=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    row = {}
    for label, gen in (("spec", model.specgenerate), ("ar", model.ar_generate)):
        _zero_launch_counts()
        sharding.COLLECTIVES.reset()
        res = gen(prompt, max_new_tokens=tokens)
        coll = sharding.COLLECTIVES
        row[label] = {"tokens": res.new_tokens, "s": res.decode_time,
                      "tok_per_s": res.new_tokens / res.decode_time,
                      "dispatched": res.dispatched, "launches": _launch_counts(),
                      "collectives": dict(coll.calls), "collective_calls": coll.total_calls,
                      "collective_host_ms": coll.total_seconds * 1e3,
                      "sequence": res.sequences[len(prompt):].tolist()}
        if label == "spec":
            row[label]["tau"] = float(np.mean([x + 1 for x in res.acceptance_lengths]))
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    row["profile"] = _profile(lambda: model.specgenerate(prompt,
                                                         max_new_tokens=PROFILE_TOKENS))
    return row


def _rank_full(dev):
    """One rank of the full-width world: Vicuna-7B at DEPTH_LAYERS layers in bfloat16
    over tp 2, then Mixtral-8x7B at PARALLEL_MIXTRAL_LAYERS layers over ep 2."""
    from vispec_tpu_torch.parallel import mesh as meshmod

    mesh = meshmod.make_mesh(tp=2, device="cuda")
    prompt = np.random.default_rng(0).integers(3, 32000, 128).tolist()
    model = _staggered_shard(mesh, lambda: _full_width_model(dev, DEPTH_LAYERS,
                                                             torch.bfloat16, 0),
                             False, False)
    out = {"mesh": mesh.describe(), "vicuna": _rank_full_run(model, prompt, PARALLEL_TOKENS)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = _staggered_shard(
        mesh, lambda: _mixtral_model(dev, PARALLEL_MIXTRAL_LAYERS, torch.bfloat16, 0),
        False, False)
    out["mixtral"] = _rank_full_run(model, prompt, PARALLEL_TOKENS)
    return out


def parallel_rank(rank, world, init_file, job, out_path):
    """A rank process of ``run_world``: joins the world, runs ``job`` and
    writes its result as JSON."""
    from vispec_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the mesh's device: a card of its own per rank (NCCL) where there are
    # enough, else the shared first card
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.init_distributed(init_method="file://" + init_file, num_processes=world,
                               process_id=rank)
    result = {"exact": _rank_exact, "full": _rank_full, "train_exact": _rank_train_exact,
              "train_full": _rank_train_full,
              "serve_exact": lambda d: _rank_serve(d, 2, torch.float32),
              "serve_full": lambda d: _rank_serve(d, DEPTH_LAYERS, torch.bfloat16)}[job](dev)
    with open(out_path, "w") as f:
        json.dump(result, f)


def run_world(job, world, timeout_s=600):
    """``world`` rank processes of this script on the one card (gloo with
    CUDA tensors), each running ``job``; returns their results in rank
    order.  The kernels are built already (``phase_build``): the ranks load
    them and never run nvcc."""
    tmp = os.path.join(ROOT, "build", "parallel")
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, f"{job}.init")
    if os.path.exists(init):
        os.remove(init)
    outs = [os.path.join(tmp, f"{job}_rank{r}.json") for r in range(world)]
    logs = [os.path.join(tmp, f"{job}_rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        if os.path.exists(outs[r]):
            os.remove(outs[r])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r), str(world),
             init, job, outs[r]], cwd=ROOT, stdout=open(logs[r], "w"),
            stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0 or not os.path.exists(outs[r])]
    if bad:
        tails = {r: open(logs[r]).read()[-3000:] for r in bad}
        raise RuntimeError(f"parallel world {job}: ranks {bad} failed: {tails}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def phase_parallel_exact(dev):
    """Multi-device inference against one process: each mode of
    PARALLEL_EXACT (2 layers, float32, Vicuna-7B or Mixtral-8x7B widths) in
    a world of four ranks sharing the card over gloo gives, on every rank,
    the single-process spec and AR tokens (PARALLEL_EXACT_TOKENS new
    tokens; spec == AR too);
    the tp2 model's ``specgenerate_batch`` equals its per-request runs.
    Returns the (K, N, M) the int4 draft sent kernel 2."""
    refs = {}
    for mode, _, _, _, opts in PARALLEL_EXACT:
        key = "mixtral" if opts.get("mixtral") else str(sorted(opts.items()))
        if key not in refs:
            model, prompt = _parallel_model(dev, opts)
            n, tokens = len(prompt) + PARALLEL_EXACT_TOKENS, PARALLEL_EXACT_TOKENS
            refs[key] = (model.specgenerate(prompt, max_new_tokens=tokens).sequences[:n].tolist(),
                         model.ar_generate(prompt, max_new_tokens=tokens).sequences[:n].tolist())
            del model
            gc.collect()
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_world("exact", PARALLEL_WORLD_EXACT)
    world_s = time.perf_counter() - t0
    q4_shapes = set()
    for mode, tp, pp, sp, opts in PARALLEL_EXACT:
        key = "mixtral" if opts.get("mixtral") else str(sorted(opts.items()))
        ref_spec, ref_ar = refs[key]
        per = [r[mode] for r in ranks]
        row = {"phase": "parallel_exact", "case": mode, "mesh": per[0]["mesh"],
               "layers": 2, "dtype": "float32", "world_s": world_s,
               "single_spec_equals_ar": ref_spec == ref_ar,
               "spec_equals_single": [p["spec"] == ref_spec for p in per],
               "ar_equals_single": [p["ar"] == ref_ar for p in per],
               "local_wq": per[0]["local_wq"], "dispatched": per[0]["dispatched"],
               "launches_spec": per[0]["launches_spec"],
               "launches_all": per[0]["launches_all"],
               "collectives_spec": per[0]["collectives_spec"]}
        if "batch_equal" in per[0]:
            row["batch_equal"] = [p["batch_equal"] for p in per]
            row["launches_batch"] = per[0]["launches_batch"]
        for p in per:
            q4_shapes.update(tuple(s) for s in p["q4_shapes"])
        row["ok"] = (row["single_spec_equals_ar"] and all(row["spec_equals_single"])
                     and all(row["ar_equals_single"]) and row["launches_spec"]["1a"] > 0
                     and all(all(b) for b in row.get("batch_equal", [[True]]))
                     and (mode != "tp2" or row["launches_batch"]["1c"] > 0)
                     and (not opts.get("quantize_kv") or row["launches_all"]["1b"] > 0)
                     and (not opts.get("quantize_draft") or row["launches_all"]["2"] > 0))
        emit(row)
        assert row["ok"], row
    return sorted(q4_shapes)


def _full_row(phase, layers, ranks, key, note):
    """The line of one full-width model of the parallel world."""
    runs = [r[key] for r in ranks]
    depth = 3
    spec_1a = [r["spec"]["launches"]["1a"] for r in runs]
    disp = [r["spec"]["dispatched"] for r in runs]
    ar_1a = [r["ar"]["launches"]["1a"] for r in runs]
    want_spec = [depth + d * (layers + 1 + depth) for d in disp]
    want_ar = [r["ar"]["dispatched"] * layers for r in runs]
    prof = [r["profile"] for r in runs]
    row = {"phase": phase, "mesh": ranks[0]["mesh"], "layers": layers, "dtype": "bfloat16",
           "note": note,
           "spec_tok_per_s": [r["spec"]["tok_per_s"] for r in runs],
           "ar_tok_per_s": [r["ar"]["tok_per_s"] for r in runs],
           "tau": runs[0]["spec"]["tau"], "dispatched_rounds": disp,
           "launches_1a_per_round": [(a - depth) / d for a, d in zip(spec_1a, disp)],
           "launches_1a_spec": spec_1a, "expected_spec": want_spec,
           "launches_1a_ar": ar_1a, "expected_ar": want_ar,
           "collectives_per_round": [r["spec"]["collective_calls"] / d
                                     for r, d in zip(runs, disp)],
           "collective_host_ms_per_round": [r["spec"]["collective_host_ms"] / d
                                            for r, d in zip(runs, disp)],
           "collective_host_ms_each": [r["spec"]["collective_host_ms"]
                                       / max(1, r["spec"]["collective_calls"]) for r in runs],
           "collectives_per_ar_step": [r["ar"]["collective_calls"] / r["ar"]["dispatched"]
                                       for r in runs],
           "collectives_spec": runs[0]["spec"]["collectives"],
           "device_idle_share_per_rank": [p["device_idle_share"] for p in prof],
           "profile_wall_ms": [p["wall_ms"] for p in prof],
           "profile_device_busy_ms": [p["device_busy_ms"] for p in prof],
           "profile_nccl_kernel_ms": [p["nccl_kernel_ms"] for p in prof],
           "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in runs],
           "ranks_agree": all(r["spec"]["sequence"] == runs[0]["spec"]["sequence"]
                              and r["ar"]["sequence"] == runs[0]["ar"]["sequence"]
                              for r in runs)}
    row["ok"] = (spec_1a == want_spec and ar_1a == want_ar and row["ranks_agree"]
                 and all(r["spec"]["tokens"] >= PARALLEL_TOKENS and r["ar"]["tokens"]
                         >= PARALLEL_TOKENS for r in runs))
    emit(row)
    assert row["ok"], row


def phase_parallel_full_width():
    """Vicuna-7B at DEPTH_LAYERS of 32 layers and Mixtral-8x7B at PARALLEL_MIXTRAL_LAYERS of
    32 layers, bfloat16, over two ranks (sharing the card over gloo, or a
    card each over NCCL where there are enough): tok/s of spec and AR,
    kernel 1a's launches per round against the expected count, collectives
    per round and their host ms, the idle share each rank's profiler sees,
    peak memory per rank."""
    ranks = run_world("full", PARALLEL_WORLD_FULL, timeout_s=900)
    note = ("two ranks on one card over gloo: tok/s measure the cost of the "
            "collectives, not a speed-up" if "shared" in ranks[0]["mesh"] else
            "a card per rank over NCCL")
    _full_row("parallel_full_width", DEPTH_LAYERS, ranks, "vicuna", note)
    _full_row("parallel_mixtral_ep2_full_width", PARALLEL_MIXTRAL_LAYERS, ranks, "mixtral",
              note + f"; {PARALLEL_MIXTRAL_LAYERS} of Mixtral's 32 layers")


# ---------------------------------------------------------------------------
# Parallel draft training and the engine on a sharded model (slice 14)
# ---------------------------------------------------------------------------

# the dp x sp training oracle's toy draft (float32) and its two meshes
PTRAIN_DRAFT = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_key_value_heads=4,
                    max_position_embeddings=64, num_q=2)
PTRAIN_MESHES = (("dp2_sp2", {"dp": 2, "sp": 2}), ("dp2_tp2", {"dp": 2, "tp": 2}))
# the JAX oracle's optimizer (make_optimizer()'s defaults), two steps
PTRAIN_OPT = dict(lr=3e-5, warmup_steps=2000, total_steps=800_000, grad_clip=0.5)
# the Vicuna-7B-width draft: two meshes of two ranks, steps of bs 2 at 1,024 rows
PTRAIN_FULL_MESHES = (("dp2", {"dp": 2}), ("tp2", {"tp": 2}))
PTRAIN_FULL_STEPS = 3
PTRAIN_FULL_LEN = 1024
PTRAIN_FULL_SPAN = (100, 676)  # LLaVA-1.5's 576 image rows
# the engine on a tp 2 7B: requests, new tokens each (16 before slice
# 15's phases), slots
SERVE_PARALLEL = (8, 8, 4)
SERVE_MODES = (("plain", {}), ("int8_kv_int4_draft", {"quantize_kv": True,
                                                     "quantize_draft": "int4"}))


def _ptrain_batch(dev, dcfg, rows, seeds, span):
    """A batch of one prepared example per seed (``rows`` + 1 record rows,
    the image span ``span``), built alike on every rank."""
    from vispec_tpu_torch.train import trainer

    cfg = trainer.TrainConfig(max_len=rows, max_images=1, max_span_bucket=64)
    exs = [trainer.prepare_example(_train_sample(seed, rows + 1, dcfg.hidden_size, span=span),
                                   cfg, dcfg, np.random.default_rng(seed)) for seed in seeds]
    return trainer.batch_examples(exs, dev)


def _ptrain_exact_run(dev, mesh):
    """Two steps of the toy draft from one state (an image span at rows 4-9,
    across the sp 2 boundary at row 8) on ``mesh`` (None: one process).
    Returns (losses, whole params, mu, nu, the local state, specs)."""
    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train import step as tstep

    dcfg = DraftConfig(**PTRAIN_DRAFT)
    batch, span = _ptrain_batch(dev, dcfg, 16, (21, 22), (4, 10))
    params = draft_mod.init_params(dcfg, torch.Generator(device=dev).manual_seed(23), dev,
                                   torch.float32)
    params["img_fc_w"] += 0.05 * torch.randn(params["img_fc_w"].shape, device=dev,
                                             generator=torch.Generator(dev).manual_seed(24))
    head = 0.1 * torch.randn((dcfg.hidden_size, dcfg.vocab_size), device=dev,
                             generator=torch.Generator(dev).manual_seed(25))
    specs = sharding.quantized_draft_specs(dcfg, params)
    if mesh is not None:
        params = sharding.apply_specs(mesh, params, specs)
        head = sharding.local_part(head, (None, "tp"), mesh.shape, mesh.coords).contiguous()
        batch = sharding.shard_train_batch(mesh, batch)
    opt = tstep.make_optimizer(**PTRAIN_OPT)
    state = opt.init(params)
    losses, collectives = [], []
    for _ in range(2):
        sharding.COLLECTIVES.reset()
        params, state, metrics = tstep.train_step(params, state, dcfg, head, batch, opt,
                                                  mtp_steps=1, max_span=span, mesh=mesh)
        losses.append(float(metrics["loss"]))
        collectives.append(sharding.COLLECTIVES.total_calls)
    whole = [sharding.gather_params(mesh, t, specs) for t in (params, state.mu, state.nu)]
    return losses, collectives, whole, (params, state), specs


def _rel_close(a, b, rtol, atol):
    """max over leaves of max(|a - b| - atol - rtol * |b|) <= 0, and that
    excess."""
    from vispec_tpu_torch.train.step import leaves

    worst = max(((x.float() - y.float()).abs() - atol - rtol * y.float().abs()).max().item()
                for (_, x), (_, y) in zip(leaves(a), leaves(b)))
    return worst <= 0, worst


def _rank_train_exact(dev):
    """One rank of parallel_train_exact: for each mesh, the one-process
    steps and the sharded steps, compared on this rank; then an orbax save
    of the rank's shards and its reload, bit for bit."""
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.train import trainer

    ref_losses, _, ref_whole, _, _ = _ptrain_exact_run(dev, None)
    out = {}
    for name, axes in PTRAIN_MESHES:
        mesh = meshmod.make_mesh(device="cuda", **axes)
        losses, coll, whole, (local, state), specs = _ptrain_exact_run(dev, mesh)
        row = {"mesh": mesh.describe(), "losses": losses, "ref_losses": ref_losses,
               "collectives_per_step": coll,
               "loss_ok": all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, ref_losses))}
        for part, got, want in zip(("params", "mu", "nu"), whole, ref_whole):
            row[f"{part}_ok"], row[f"{part}_excess"] = _rel_close(got, want, 1e-4, 1e-6)
        cpdir = os.path.join(ROOT, "build", "parallel", f"ptrain_{name}")
        path = trainer.save_state(cpdir, 0, local, state, backend="orbax", mesh=mesh,
                                  specs=specs)
        epoch, params2, state2 = trainer.load_state(path, mesh=mesh)
        row["orbax_round_trip"] = (epoch == 0 and state2.count == state.count
                                   and _trees_equal(params2, local)
                                   and _trees_equal(state2.mu, state.mu)
                                   and _trees_equal(state2.nu, state.nu))
        row["orbax_files"] = len(os.listdir(path))
        out[name] = row
    return out


def phase_parallel_train_exact():
    """Parallel draft training against one process: the toy float32 draft
    (hidden 32, 4 heads) of the CPU oracle, two steps from one state, in a
    world of four ranks sharing the card, at dp 2 x sp 2 (an image span
    across the sp boundary) and dp 2 x tp 2: every rank's loss within 1e-5
    (relative) of one process's, every updated leaf and both Adam moments
    within rtol 1e-4 / atol 1e-6; an orbax (torch.distributed.checkpoint)
    save of each rank's shards reloads bit for bit."""
    t0 = time.perf_counter()
    ranks = run_world("train_exact", PARALLEL_WORLD_EXACT)
    world_s = time.perf_counter() - t0
    for name, _ in PTRAIN_MESHES:
        per = [r[name] for r in ranks]
        row = {"phase": "parallel_train_exact", "case": name, "mesh": per[0]["mesh"],
               "dtype": "float32", "hidden": PTRAIN_DRAFT["hidden_size"], "world_s": world_s,
               "losses": [p["losses"] for p in per], "one_process_losses": per[0]["ref_losses"],
               "collectives_per_step": per[0]["collectives_per_step"],
               "excess_over_tol": {part: max(p[f"{part}_excess"] for p in per)
                                   for part in ("params", "mu", "nu")},
               "orbax_round_trip": [p["orbax_round_trip"] for p in per],
               "orbax_files": per[0]["orbax_files"]}
        row["ok"] = all(p["loss_ok"] and p["params_ok"] and p["mu_ok"] and p["nu_ok"]
                        and p["orbax_round_trip"] for p in per)
        emit(row)
        assert row["ok"], row


def _ptrain_full_setup(dev, mesh):
    """The Vicuna-7B-width draft (DraftConfig(): hidden 4,096, MLP 11,008, 32
    heads, vocab 32,000), a frozen head, a batch of two 1,024-row samples
    (each with a 576-row image span) and Adam, on ``mesh`` (None: one
    process)."""
    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train import step as tstep

    dcfg = DraftConfig()
    params = draft_mod.init_params(dcfg, torch.Generator(device=dev).manual_seed(31), dev,
                                   torch.float32)
    head = 0.02 * torch.randn((dcfg.hidden_size, dcfg.vocab_size), device=dev,
                              generator=torch.Generator(dev).manual_seed(32))
    batch, _ = _ptrain_batch(dev, dcfg, PTRAIN_FULL_LEN, (33, 34), PTRAIN_FULL_SPAN)
    specs = sharding.quantized_draft_specs(dcfg, params)
    if mesh is not None:
        params = sharding.apply_specs(mesh, params, specs)
        head = sharding.local_part(head, (None, "tp"), mesh.shape, mesh.coords).contiguous()
        batch = sharding.shard_train_batch(mesh, batch)
    opt = tstep.make_optimizer(1e-5, 0, 800_000, 0.5)
    return dcfg, params, head, batch, opt, specs


def _ptrain_full_steps(dev, mesh):
    """PTRAIN_FULL_STEPS bf16 steps (mtp_steps 2): losses, ms, collectives
    and their host ms each step, peak memory; with tp, getkacc on the
    rank's shards (kernel 1c in float32 at the rank's heads)."""
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train import step as tstep
    from vispec_tpu_torch.train import trainer

    dcfg, params, head, batch, opt, _ = _ptrain_full_setup(dev, mesh)
    state = opt.init(params)
    span = PTRAIN_FULL_SPAN[1] - PTRAIN_FULL_SPAN[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    row = {"losses": [], "step_ms": [], "collectives": [], "collective_host_ms": []}
    for _ in range(PTRAIN_FULL_STEPS):
        sharding.COLLECTIVES.reset()
        t0 = time.perf_counter()
        params, state, metrics = tstep.train_step(params, state, dcfg, head, batch, opt,
                                                  mtp_steps=2, max_span=span, bf16=True,
                                                  mesh=mesh)
        row["losses"].append(float(metrics["loss"]))  # a readback: the step is done
        row["step_ms"].append((time.perf_counter() - t0) * 1e3)
        row["collectives"].append(sharding.COLLECTIVES.total_calls)
        row["collective_host_ms"].append(sharding.COLLECTIVES.total_seconds * 1e3)
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    row["local_rows"] = list(batch.hidden_states.shape)
    row["local_wq"] = list(params["layer"]["wq"].shape)
    if mesh is not None and mesh.shape["tp"] > 1:
        del state
        torch.cuda.empty_cache()
        sample = _train_sample(33, 513, dcfg.hidden_size, gen_from=256)
        trainer.getkacc(params, dcfg, head, sample, max_length=5, max_prefixes=16,
                        max_len=512, max_span=64, mesh=mesh)  # warm-up
        torch.cuda.synchronize()
        _zero_launch_counts()
        t0 = time.perf_counter()
        row["getkacc"] = trainer.getkacc(params, dcfg, head, sample, max_length=5,
                                         max_prefixes=16, max_len=512, max_span=64, mesh=mesh)
        torch.cuda.synchronize()
        row["getkacc_s"] = time.perf_counter() - t0
        row["getkacc_launches"] = _launch_counts()
    return row


def _rank_train_full(dev):
    """One rank of parallel_train_full_width: each mesh of PTRAIN_FULL_MESHES
    in turn."""
    from vispec_tpu_torch.parallel import mesh as meshmod

    out = {}
    for name, axes in PTRAIN_FULL_MESHES:
        mesh = meshmod.make_mesh(device="cuda", **axes)
        out[name] = {"mesh": mesh.describe(), **_ptrain_full_steps(dev, mesh)}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_parallel_train_full_width(dev):
    """Draft training at Vicuna-7B width (float32 master weights, bf16
    products, mtp_steps 2, bs 2 of 1,024 rows) over two ranks: dp 2, then
    tp 2 (each on the one card over gloo, or a card each over NCCL).  Per
    mesh: step ms a rank, collectives a step and their host ms, peak
    memory a rank, the losses against one process's steps on the same
    batch (within 2e-2: bf16 products summed in another order), and at tp 2
    ``getkacc`` on the rank's shards with kernel 1c's launches (5 a call)."""
    single = _ptrain_full_steps(dev, None)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = run_world("train_full", PARALLEL_WORLD_FULL, timeout_s=900)
    for name, axes in PTRAIN_FULL_MESHES:
        per = [r[name] for r in ranks]
        rel = max(abs(a - b) / abs(b) for p in per for a, b in zip(p["losses"],
                                                                     single["losses"]))
        row = {"phase": "parallel_train_full_width", "case": name, "mesh": per[0]["mesh"],
               "hidden": 4096, "mlp": 11008, "vocab": 32000, "rows": PTRAIN_FULL_LEN,
               "bs": 2, "mtp_steps": 2, "steps": PTRAIN_FULL_STEPS,
               "step_ms_per_rank": [p["step_ms"] for p in per],
               "step_ms_median_after_first": [float(np.median(p["step_ms"][1:])) for p in per],
               "one_process_step_ms": single["step_ms"],
               "collectives_per_step": per[0]["collectives"],
               "collective_host_ms_per_step": [p["collective_host_ms"] for p in per],
               "peak_mem_gb_per_rank": [p["peak_mem_gb"] for p in per],
               "one_process_peak_mem_gb": single["peak_mem_gb"],
               "losses": [p["losses"] for p in per], "one_process_losses": single["losses"],
               "loss_rel_diff_max": rel, "local_rows": per[0]["local_rows"],
               "local_wq": per[0]["local_wq"]}
        ok = rel <= 2e-2 and all(np.isfinite(p["losses"]).all() for p in per)
        if "getkacc" in per[0]:
            row.update(getkacc=[p["getkacc"] for p in per],
                       getkacc_s=[p["getkacc_s"] for p in per],
                       getkacc_launches=per[0]["getkacc_launches"])
            ok &= (all(p["getkacc_launches"]["1c"] == 5 for p in per)
                   and all(p["getkacc"] == per[0]["getkacc"] for p in per))
        row["ok"] = ok
        emit(row)
        assert row["ok"], row
    return ranks


def _serve_run(model):
    """The engine over SERVE_PARALLEL's requests after a warm-up: tokens,
    rounds, kernel launches, collectives, wall seconds."""
    from vispec_tpu_torch.parallel import sharding

    n, tokens, slots = SERVE_PARALLEL
    prompts = [p for p, _ in _serving_requests(n, seed=3)]
    model.serving_engine(batch_size=slots, max_new_tokens=4,
                         pad_bucket=(128, 256, 512)).run_all(prompts[:slots])  # warm-up
    eng = model.serving_engine(batch_size=slots, max_new_tokens=tokens,
                               pad_bucket=(128, 256, 512))
    torch.cuda.synchronize()
    _zero_launch_counts()
    sharding.COLLECTIVES.reset()
    t0 = time.perf_counter()
    outs = eng.run_all(prompts)
    torch.cuda.synchronize()
    return {"tokens": [o.tolist() for o in outs], "rounds": eng.stats["rounds"],
            "launches": _launch_counts(), "collectives": sharding.COLLECTIVES.total_calls,
            "collective_host_ms": sharding.COLLECTIVES.total_seconds * 1e3,
            "wall_s": time.perf_counter() - t0}


def _serve_model(dev, layers, dtype, quant):
    model = _full_width_model(dev, layers, dtype, 0, quantize_kv=quant.get("quantize_kv", False))
    if quant.get("quantize_draft"):
        model.quantize_draft_inplace(quant["quantize_draft"])
    return model


def _rank_serve(dev, layers, dtype):
    """One rank of a serving_parallel world: the model over tp 2 in each
    mode of SERVE_MODES (each rank builds the whole model in turn,
    quantizes, keeps its shard), and the (K, N, M) the quantized mode sent
    kernel 2."""
    from vispec_tpu_torch.parallel import mesh as meshmod

    mesh = meshmod.make_mesh(tp=2, device="cuda")
    out = {"mesh": mesh.describe()}
    for mode, quant in SERVE_MODES:
        model = _staggered_shard(mesh, lambda: _serve_model(dev, layers, dtype, quant),
                                 False, False)
        shapes, undo = _recording_q4_dispatch()
        try:
            out[mode] = _serve_run(model)
        finally:
            undo()
        out[mode]["q4_shapes"] = sorted(shapes)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _agreeing_prefix(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def _serving_parallel(dev, phase, job, layers, dtype):
    """The engine over the Vicuna-7B widths at ``layers`` layers in
    ``dtype`` at tp 2 (two ranks) and unsharded, in each mode of
    SERVE_MODES: 8 requests (prompts 64-448) of 16 new tokens in 4 slots,
    every rank submitting the same requests in order.  Returns a row a
    mode (tokens against the unsharded engine's, and the unsharded
    engine's against one ``specgenerate`` a request; kernel launches and
    collectives a round) and the (K, N, M) kernel 2 ran at."""
    singles = {}
    for mode, quant in SERVE_MODES:
        model = _serve_model(dev, layers, dtype, quant)
        singles[mode] = _serve_run(model)
        n, tokens, _ = SERVE_PARALLEL
        singles[mode]["specgenerate"] = [
            model.specgenerate(p, max_new_tokens=tokens).sequences[len(p):].tolist()
            for p, _ in _serving_requests(n, seed=3)]
        model.target_cache = model.draft_cache = None
        del model
        gc.collect()
        torch.cuda.empty_cache()
    ranks = run_world(job, PARALLEL_WORLD_FULL, timeout_s=900)
    rows, shapes = [], set()
    for mode, _ in SERVE_MODES:
        per, single = [r[mode] for r in ranks], singles[mode]
        rounds = per[0]["rounds"]
        row = {"phase": phase, "case": mode, "mesh": ranks[0]["mesh"], "layers": layers,
               "dtype": str(dtype).replace("torch.", ""), "requests": SERVE_PARALLEL[0],
               "new_tokens": SERVE_PARALLEL[1], "slots": SERVE_PARALLEL[2],
               "tokens_equal_unsharded": [p["tokens"] == single["tokens"] for p in per],
               "agreeing_prefix_per_request": [
                   _agreeing_prefix(a, b) for a, b in zip(per[0]["tokens"], single["tokens"])],
               "unsharded_engine_vs_specgenerate_prefix": [
                   _agreeing_prefix(a, b) for a, b in zip(single["tokens"],
                                                          single["specgenerate"])],
               "ranks_agree": all(p["tokens"] == per[0]["tokens"] for p in per),
               "rounds": [p["rounds"] for p in per], "unsharded_rounds": single["rounds"],
               "launches_per_round": {k: v / rounds for k, v in per[0]["launches"].items()},
               "unsharded_launches_per_round": {k: v / single["rounds"]
                                                for k, v in single["launches"].items()},
               "collectives_per_round": [p["collectives"] / p["rounds"] for p in per],
               "collective_host_ms_each": [p["collective_host_ms"] / max(1, p["collectives"])
                                           for p in per],
               "wall_s": [p["wall_s"] for p in per], "unsharded_wall_s": single["wall_s"]}
        for p in per:
            shapes.update(tuple(x) for x in p["q4_shapes"])
        rows.append(row)
    return rows, sorted(shapes)


def phase_serving_parallel_exact(dev):
    """The engine on a sharded model against the unsharded engine, exactly:
    Vicuna-7B widths at 2 layers in float32 (TF32 off), tp 2, plain and
    int8 KV with an int4 draft.  Gates: every rank's tokens equal the
    unsharded engine's; kernel 1c (float32 q; over the int8 cache in the
    quantized mode) and kernel 2 launched."""
    rows, shapes = _serving_parallel(dev, "serving_parallel_exact", "serve_exact", 2,
                                     torch.float32)
    for row in rows:
        quantized = row["case"] != "plain"
        launches = row["launches_per_round"]
        row["ok"] = (all(row["tokens_equal_unsharded"])
                     and launches["1c_int8" if quantized else "1c"] > 0
                     and (not quantized or launches["2"] > 0))
        emit(row)
        assert row["ok"], row
    return shapes


def phase_serving_parallel_full_depth(dev):
    """The same at full width: Vicuna-7B at DEPTH_LAYERS layers in bfloat16, tp 2, plain
    and quantized.  Gates: the ranks agree token for token, and each round
    launches what one device's round launches (1c layers + 4; quantized: 1c
    over the int8 cache layers, over the bf16 draft cache 4, kernel 2 40).  The
    tokens against the unsharded engine's are reported (agreeing prefix per
    request): the tp sums run in another order, and bf16 rounding turns a
    few of those differences into another argmax at a near-tie."""
    rows, shapes = _serving_parallel(dev, "serving_parallel_full_depth", "serve_full",
                                     DEPTH_LAYERS, torch.bfloat16)
    for row in rows:
        # the rounds' kernels (prefills launch 1a and kernel 2 as well)
        rounds = ("1c", "1c_int8") if row["case"] != "plain" else ("1c",)
        row["ok"] = (row["ranks_agree"]
                     and all(row["launches_per_round"][k]
                             == row["unsharded_launches_per_round"][k] > 0 for k in rounds)
                     and (row["case"] == "plain" or row["launches_per_round"]["2"] > 0))
        emit(row)
        assert row["ok"], row
    return shapes


def _example(name, *args, timeout=300):
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"vispec_tpu_torch.examples.{name}", *args],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    return r, time.perf_counter() - t0


def phase_examples_device():
    """The serving examples on the card (their default device): ``serving``
    (12 requests on 4 slots, bf16, prefix-cached) and ``serve_http
    --selftest`` (6 concurrent HTTP clients on 127.0.0.1, each response equal
    to specgenerate's)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    runs = {"serving": (_example("serving"), "served 12 requests"),
            "serve_http": (_example("serve_http", "--selftest", "--port", str(port),
                                    "--batch", "2"), "6/6 concurrent HTTP requests match")}
    row = {"phase": "examples_device"}
    for name, ((r, secs), line) in runs.items():
        lines = r.stdout.strip().splitlines()
        row[name] = {"rc": r.returncode, "s": secs, "printed": lines[-2:],
                     "ok": r.returncode == 0 and line in r.stdout}
        if not row[name]["ok"]:
            row[name]["stderr"] = r.stderr[-2000:]
    row["ok"] = all(row[name]["ok"] for name in runs)
    emit(row)
    assert row["ok"], row


def phase_kernel_shards(dev):
    """Kernels 1a, 1b and 1c against their plain versions at the shapes
    that the parallel phases give them: 16 heads over 16 KV heads (Vicuna-7B
    and its draft at tp 2), 16 over 4 (Mixtral-8x7B and its draft at ep 2),
    a pp stage's one layer of a 2-layer cache, the int8 cache at tp 2 with
    float32 q (the quantized parallel_exact mode), the batched verify and
    expansion at tp 2 (float32 B = 3; the tp 2 engine's bf16 and int8 B =
    4), and getkacc's rollout at tp 2 (float32, B = 16, S = 1).  These shapes
    are fixed by the configurations, so the phase runs with the other kernel
    phases, before the parallel phases' processes share the card (after them
    torch.profiler's CUDA activity recorded no kernel in this process).
    Returns the rows by kernel."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(13)
    tree = torch.tril(torch.rand((30, 30), generator=g) < 0.3)
    tree.fill_diagonal_(True)
    tree[:, 0] = True
    expand = torch.zeros((8, 24), dtype=torch.bool)
    expand[:, :16] = torch.rand((8, 16), generator=g) < 0.3
    expand[torch.arange(8), 16 + torch.arange(8)] = True
    tree, expand = tree.to(dev), expand.to(dev)
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    tri = torch.tril(torch.ones((5, 5), dtype=torch.bool, device=dev))
    bf16, f32 = torch.bfloat16, torch.float32
    rows_1a = [
        kernel_case("tp2_target_verify", 80, dev, bf16, 16, 16, 30, 30, 301, 32, tree, flush),
        kernel_case("tp2_ar_step", 81, dev, bf16, 16, 16, 1, 1, 319, 32, ones, flush),
        kernel_case("tp2_draft_append", 82, dev, bf16, 16, 16, 5, 5, 317, None, tri, flush),
        kernel_case("tp2_draft_expand", 83, dev, bf16, 16, 16, 8, 24, 300, None, expand,
                    flush),
        kernel_case("tp2_target_verify_f32", 84, dev, f32, 16, 16, 30, 30, 301, 2, tree,
                    flush),
        kernel_case("pp2_stage_target_verify_f32", 85, dev, f32, 32, 32, 30, 30, 301, 1,
                    tree, flush),
        kernel_case("ep2_mixtral_target_verify", 86, dev, bf16, 16, 4, 30, 30, 301,
                    PARALLEL_MIXTRAL_LAYERS, tree, flush),
        kernel_case("ep2_mixtral_ar_step", 87, dev, bf16, 16, 4, 1, 1, 319,
                    PARALLEL_MIXTRAL_LAYERS, ones, flush),
        kernel_case("ep2_mixtral_draft_expand", 88, dev, bf16, 16, 4, 8, 24, 300, None,
                    expand, flush),
        kernel_case("ep2_mixtral_target_verify_f32", 89, dev, f32, 16, 4, 30, 30, 301, 2,
                    tree, flush),
    ]
    rows_1b = [
        kernel_case_int8("tp2_target_verify_int8_f32", 90, dev, 16, 16, 30, 30, 301, 2, tree,
                         flush, dtype=f32),
        kernel_case_int8("tp2_ar_step_int8_f32", 91, dev, 16, 16, 1, 1, 319, 2, ones, flush,
                         dtype=f32),
        kernel_case_int8("tp2_target_verify_int8", 92, dev, 16, 16, 30, 30, 301, 32, tree,
                         flush),
    ]
    b, starts, layers = 3, (301, 129, 777), (0, 1, 1)
    tree_b = torch.tril(torch.rand((b, 30, 30), generator=g) < 0.3)
    tree_b |= torch.eye(30, dtype=torch.bool)
    tree_b[:, :, 0] = True
    expand_b = torch.zeros((b, 8, 24), dtype=torch.bool)
    expand_b[:, :, :16] = torch.rand((b, 8, 16), generator=g) < 0.3
    expand_b[:, torch.arange(8), 16 + torch.arange(8)] = True
    tree_b, expand_b = tree_b.to(dev).contiguous(), expand_b.to(dev).contiguous()
    # the tp 2 engine's rounds (serving_parallel_exact, B = 4 at 7B starts and
    # layers) and getkacc at tp 2 (parallel_train_full_width: 16 prefixes, one
    # query row each, over the float32 draft cache of 519 rows)
    starts4, layers4 = (301, 129, 777, 1500), (0, 5, 17, 31)
    tree4 = torch.tril(torch.rand((4, 30, 30), generator=g) < 0.3)
    tree4 |= torch.eye(30, dtype=torch.bool)
    tree4[:, :, 0] = True
    expand4 = torch.zeros((4, 8, 24), dtype=torch.bool)
    expand4[:, :, :16] = torch.rand((4, 8, 16), generator=g) < 0.3
    expand4[:, torch.arange(8), 16 + torch.arange(8)] = True
    tree4, expand4 = tree4.to(dev).contiguous(), expand4.to(dev).contiguous()
    ones16 = torch.ones((16, 1, 1), dtype=torch.bool, device=dev)
    rows_1c = [
        kernel_case_batched("tp2_batched_target_verify_f32", 93, dev, f32, 16, 16, 30, 30,
                            starts, layers, tree_b, flush, n_layers=2),
        kernel_case_batched("tp2_batched_draft_expand_f32", 94, dev, f32, 16, 16, 8, 24,
                            starts, None, expand_b, flush),
        kernel_case_batched("tp2_batched_target_verify", 95, dev, bf16, 16, 16, 30, 30,
                            starts4, layers4, tree4, flush),
        kernel_case_batched("tp2_batched_draft_expand", 96, dev, bf16, 16, 16, 8, 24,
                            starts4, None, expand4, flush),
        kernel_case_batched("tp2_batched_getkacc_f32_b16", 97, dev, f32, 16, 16, 1, 1,
                            KACC_STARTS, None, ones16, flush, max_len=519),
    ]
    rows_1c_int8 = [
        kernel_case_batched("tp2_batched_target_verify_int8", 98, dev, bf16, 16, 16, 30, 30,
                            starts4, layers4, tree4, flush, int8=True),
    ]
    torch.cuda.empty_cache()
    return rows_1a, rows_1b, rows_1c, rows_1c_int8


def phase_kernel_shards_q4(dev, q4_shapes):
    """Kernel 2 against its plain version at every (K, N, M) the int4 draft
    sent it at tp 2 (the parallel phases return them)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    rows = [q4_case(dev, k, n, m, flush, prefix="tp2_q4") for k, n, m in q4_shapes]
    torch.cuda.empty_cache()
    return rows


def _card():
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                      sys.argv[6])
        return
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})
    if sys.argv[1:2] and sys.argv[1] in CHECKOUT_PHASES:
        checkout_runs(sys.argv[1], sys.argv[2:])
        print(_card(), flush=True)
        return
    if sys.argv[1:2] == ["--parallel"]:
        phase_build()
        phase_parallel_exact(dev)
        phase_parallel_full_width()
        phase_parallel_train_exact()
        phase_parallel_train_full_width(dev)
        print(_card(), flush=True)
        return

    phase_build()
    rows = phase_kernel(dev)
    rows_int8 = phase_kernel_int8(dev)
    rows_1c, rows_1c_int8 = phase_kernel_batched(dev)
    rows_q4 = phase_kernel_q4(dev)
    shard_1a, shard_1b, shard_1c, shard_1c_int8 = phase_kernel_shards(dev)
    phase_int8_qdot_cost(dev)
    phase_tau_fixture(dev)
    phase_tau_fixture_batch(dev)
    phase_full_width_exact(dev)
    phase_quant_exact(dev)
    phase_batch_exact(dev)
    phase_round_graph_exact(dev)
    phase_sampling_device(dev)
    phase_sampling_exact(dev)
    phase_tau_fixture_sampling(dev)
    phase_vision_tower_device(dev)
    phase_llava_exact(dev)
    phase_qwen_vision_tower_device(dev)
    rows_q4 += phase_qwen_exact(dev)
    rows_q4 += phase_mixtral_exact(dev)
    phase_snapshot_exact(dev)
    phase_from_pretrained_device(dev)
    phase_eval_exact(dev)
    phase_train_exact(dev)
    model, prompt, bf16_row = phase_full_width_depth(dev)
    serving_row = phase_serving_full_depth(dev, model)
    phase_eval_full_depth(dev, model, serving_row)
    phase_train_full_width(dev, model)
    med = phase_sampling_full_depth(dev, model, prompt)
    phase_serving_sampling_full_depth(dev, model, med)
    del med
    gc.collect()
    torch.cuda.empty_cache()
    phase_snapshot_full_depth(dev, model)
    phase_autotune_full_depth(dev, model, "vicuna-7b")
    quant_counts, qmodel = phase_quant_full_depth(dev, model, prompt, bf16_row)
    serving_quant_counts = phase_serving_quant_full_depth(dev, qmodel)
    del model, qmodel  # the 7B text weights, quantized in place, make room
    gc.collect()
    torch.cuda.empty_cache()
    llava_models = _llava_models(dev, DEPTH_LAYERS, torch.bfloat16, seed=0)
    phase_llava_full_depth(dev, llava_models)
    phase_serving_vision_full_depth(dev, llava_models["llava-1.5"])
    phase_train_vlm_data_gen(dev, llava_models)
    del llava_models
    gc.collect()
    torch.cuda.empty_cache()
    qwen = _qwen_model(dev, DEPTH_LAYERS, torch.bfloat16, seed=0)
    phase_qwen_full_depth(dev, qwen)
    phase_serving_qwen_full_depth(dev, qwen)
    del qwen
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = phase_mixtral_full_depth(dev)
    phase_serving_mixtral_full_depth(dev, mixtral)
    phase_autotune_full_depth(dev, mixtral, f"mixtral-8x7b-{MIXTRAL_LAYERS}-layers")
    del mixtral
    gc.collect()
    torch.cuda.empty_cache()
    q4_tp2_shapes = phase_parallel_exact(dev)
    phase_parallel_full_width()
    phase_parallel_train_exact()
    phase_parallel_train_full_width(dev)
    q4_tp2_shapes = sorted(set(q4_tp2_shapes) | set(phase_serving_parallel_exact(dev))
                           | set(phase_serving_parallel_full_depth(dev)))
    phase_examples_device()
    shard_2 = phase_kernel_shards_q4(dev, q4_tp2_shapes)

    def entry(name, source, replaces, launches, case_rows, main_row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in case_rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    # each kernel's main row: the target verify (32 of 36 launches per bf16
    # round; 32 of 36 int8-KV launches per quantized round; for 1c the B = 4
    # verify, 32 of 36 launches per batched round) and the int4 product at
    # [4096, 4096], M = 8 (6 of the 10 products per expansion level)
    q4_main = next(r for r in rows_q4 if r["case"] == "q4_4096x4096_m8")
    # the rows at the parallel phases' shard shapes join each kernel's rows
    # (max_abs_err is the largest over all of them)
    emit({"kernels": [
        entry("verify_attention", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", bf16_row["launches_spec"],
              rows + shard_1a, rows[0]),
        entry("verify_attention_int8", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", quant_counts["1b"],
              rows_int8 + shard_1b, rows_int8[0]),
        entry("q4_matmul", "vispec_tpu_torch/csrc/q4_matmul.cu",
              "vispec_tpu/ops/quant.py:162", quant_counts["2"], rows_q4 + shard_2, q4_main),
        entry("verify_attention_batched", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", serving_row["launches"]["1c"],
              rows_1c + shard_1c, rows_1c[0]),
        entry("verify_attention_batched_int8", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", serving_quant_counts["1c_int8"],
              rows_1c_int8 + shard_1c_int8, rows_1c_int8[0]),
    ]})
    print(_card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
