"""Chip smoke test of the PyTorch + CUDA port (vispec_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (in
parallel), holds each against its plain PyTorch version at the main paths'
shapes (Vicuna-7B width), then drives greedy ViSpec decoding end to end: the
trained toy checkpoint in tests/data/tau_fixture.npz, a 2-layer float32
Vicuna-7B-width model (speculative output must equal autoregressive), the
full 32-layer bfloat16 model with random weights from a seed, and the
quantized serving mode (int8 KV cache, int4 draft, int8 target) at 2 layers
in float32 (spec == AR) and at 32 layers in bfloat16 (the same model,
quantized in place).  Prints one JSON line per phase, a
``{"kernels": [...]}`` line, the card's name and power limit, and as its
last line ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero without that line; so does a machine without a
CUDA device.
"""

import json
import os
import subprocess
import sys
import time
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


def emit(obj):
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
        ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "ok": True, "seconds": seconds, "library": so.name,
              "ptxas": ptxas})
    emit({"phase": "build_all", "ok": True, "seconds": total})


def kernel_case(name, seed, dev, dtype, h, hkv, s, t_reg, start, layers, mask, flush,
                max_len=2048, d=128):
    """One main-path geometry: kernel vs plain version (max abs error), and
    the times of the kernel, the plain version and SDPA as a yardstick."""
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

    ms = timed_ms(lambda: va.verify_attention(*args, layer_idx=layer), flush)
    plain_ms = timed_ms(lambda: va.verify_attention_ref(*args, layer_idx=layer), flush)
    library_ms = timed_ms(library, flush)
    elem = q.element_size()
    moved = 2 * total * hkv * d * elem + 2 * q.numel() * elem + mask.numel()
    ops = 4 * h * s * total * d
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "H": h, "Hkv": hkv,
           "S": s, "T_reg": t_reg, "tree_start": start, "max_len": max_len, "D": d,
           "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit({"phase": "kernel_vs_plain", **row})
    assert err <= TOL[dtype], f"{name}: max abs err {err} > {TOL[dtype]}"
    return row


def phase_kernel(dev):
    """Table row 1a's four main-path geometries at 7B width (H = Hkv = 32,
    D = 128, max_len 2048), plus GQA and float32.  Starts are not 64-row
    aligned and every region crosses a 64-row tile edge."""
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
        kernel_case("target_verify", 0, dev, bf16, 32, 32, 30, 30, 301, 32, tree, flush),
        kernel_case("ar_step", 1, dev, bf16, 32, 32, 1, 1, 319, 32, ones, flush),
        kernel_case("draft_append", 2, dev, bf16, 32, 32, 5, 5, 317, None, tri, flush),
        kernel_case("draft_expand", 3, dev, bf16, 32, 32, 8, 24, 300, None, expand, flush),
        kernel_case("gqa_groups4", 4, dev, bf16, 32, 8, 30, 30, 301, 32, tree, flush),
        kernel_case("target_verify_f32", 5, dev, f32, 32, 32, 30, 30, 301, 32, tree, flush),
    ]
    return rows


def kernel_case_int8(name, seed, dev, h, hkv, s, t_reg, start, layers, mask, flush,
                     max_len=2048, d=128):
    """Kernel 1b at one main-path geometry: bf16 q over a stacked int8 cache
    with per-row scales, read at layer ``layers - 1``.  No single PyTorch
    call attends over int8 rows with per-row scales, so ``library_ms`` is
    null; dequantize + SDPA over the live rows is printed as an extra."""
    import torch.nn.functional as F

    from vispec_tpu_torch.ops import kv_cache as kvc
    from vispec_tpu_torch.ops import verify_attention as va
    from vispec_tpu_torch.ops.attention import tree_verify_mask

    dtype = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (layers, hkv, max_len, d)
    q = torch.randn((h, s, d), generator=g, device=dev, dtype=dtype)
    k, ks = kvc.quantize_rows(torch.randn(shape, generator=g, device=dev, dtype=dtype))
    v, vs = kvc.quantize_rows(torch.randn(shape, generator=g, device=dev, dtype=dtype))
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    layer = torch.tensor(layers - 1, dtype=torch.int32, device=dev)
    args = (q, k, v, st, mask, layer, ks, vs)
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

    ms = timed_ms(lambda: va.verify_attention(*args), flush)
    plain_ms = timed_ms(lambda: va.verify_attention_ref(*args), flush)
    extra_ms = timed_ms(dequant_sdpa, flush)
    moved = (2 * total * hkv * d + 2 * total * hkv * 4 + 2 * q.numel() * 2
             + mask.numel())
    ops = 4 * h * s * total * d
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    row = {"case": name, "kernel": "1b", "dtype": "bfloat16", "cache": "int8", "H": h,
           "Hkv": hkv, "S": s, "T_reg": t_reg, "tree_start": start, "max_len": max_len,
           "D": d, "max_abs_err": err, "tol": TOL[dtype], "ms": ms, "plain_ms": plain_ms,
           "library_ms": None,
           "library_note": "no single PyTorch call attends over int8 rows with "
                           "per-row scales",
           "dequant_sdpa_ms": extra_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit({"phase": "kernel_vs_plain", **row})
    assert err <= TOL[dtype], f"{name} int8: max abs err {err} > {TOL[dtype]}"
    return row


def phase_kernel_int8(dev):
    """Table row 1b's main-path geometries at 7B width: the target verify and
    the AR step over the 32-layer int8 cache, and GQA with 4 groups."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    g = torch.Generator().manual_seed(1)
    tree = torch.tril(torch.rand((30, 30), generator=g) < 0.3)
    tree.fill_diagonal_(True)
    tree[:, 0] = True
    tree = tree.to(dev)
    ones = torch.ones((1, 1), dtype=torch.bool, device=dev)
    return [
        kernel_case_int8("target_verify_int8", 10, dev, 32, 32, 30, 30, 301, 32, tree, flush),
        kernel_case_int8("ar_step_int8", 11, dev, 32, 32, 1, 1, 319, 32, ones, flush),
        kernel_case_int8("gqa_groups4_int8", 12, dev, 32, 8, 30, 30, 301, 32, tree, flush),
    ]


def q4_case(dev, k, n, m, flush):
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
    row = {"case": f"q4_{k}x{n}_m{m}", "kernel": "2", "K": k, "N": n, "M": m,
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
    kernel)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    rows = [q4_case(dev, k, n, m, flush)
            for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
            for m in (1, 8, 64)]
    torch.cuda.empty_cache()
    return rows


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


def phase_tau_fixture(dev):
    """The trained toy checkpoint (head_dim 16, GQA 2) in float32: spec equals
    AR on tests/test_e2e_tau.py's six prompts, tau >= recorded - 0.15."""
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
    model = SpecModel(tcfg, dcfg, SpecConfig(total_tokens=16, depth=3, top_k=4),
                      from_numpy(npz_side(z, "t"), dev), from_numpy(npz_side(z, "d"), dev),
                      max_len=512, dtype=torch.float32, eos_token_id=999, device=dev)
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


def _decode_round_without_host_sync(model, prompt):
    """One decode round with CUDA's sync debug mode set to error: the round
    must not wait on the device (no .item(), no blocking copy)."""
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.ops import kv_cache as kv
    from vispec_tpu_torch.spec import loop

    dev = model.device
    pad = 128
    plan, span = draft_mod.make_prefill_plan(None, len(prompt), model.dcfg.num_q, pad,
                                             max_span=64, device=dev)
    with torch.no_grad():
        state = loop.spec_prefill(
            model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, plan,
            loop.SamplingParams(), model._padded_embeds(np.asarray(prompt), pad),
            kv.reset(model.target_cache), kv.reset(model.draft_cache), 64, span)
        eos = torch.tensor(2, dtype=torch.int32, device=dev)
        cap = torch.tensor(32, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.decode_round(model.tparams, model.dparams, model.tcfg, model.dcfg,
                              model.spec, loop.SamplingParams(), state, eos, cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def _profile(fn):
    """Wall time of ``fn`` under torch.profiler, the device time of the
    kernels it ran, the idle share, and the top kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = sorted((e for e in stats if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    host = sorted((e for e in stats if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_ms": [[e.key[:60], e.count, e.device_time_total / 1e3]
                               for e in kernels[:6]],
            "top_host_self_ms": [[e.key[:40], e.count, e.self_cpu_time_total / 1e3]
                                 for e in host[:6]]}


def phase_full_width_depth(dev):
    """Vicuna-7B at all 32 layers in bfloat16, max_len 2048, SpecConfig()
    (30 tokens, depth 3, top-k 8): a 128-token prompt, 128 new tokens by spec
    and by AR.  Counts the kernel's launches on the main path against the
    expected count; spec/AR agreement is reported, not required (bf16 argmax
    near-ties differ between the batch-30 verify and the batch-1 AR step)."""
    from vispec_tpu_torch.ops import verify_attention as va

    model = _full_width_model(dev, 32, torch.bfloat16, seed=0)
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
    emit({"phase": "profile_spec_16_tokens",
          **_profile(lambda: model.specgenerate(prompt, max_new_tokens=16))})
    emit({"phase": "profile_ar_16_tokens",
          **_profile(lambda: model.ar_generate(prompt, max_new_tokens=16))})
    return model, prompt, row


def phase_quant_full_depth(dev, model, prompt, bf16_row):
    """The quantized serving mode at all 32 layers in bfloat16: the previous
    phase's model, its draft quantized to int4 (with an int4 ranking head)
    and then its target to int8 in place, over an int8 KV cache.  Same
    prompt and budgets.  Counts each kernel's launches on this path against
    the count the code gives: per spec round, 32 int8-KV verifies, 4 draft
    attentions over the bf16 draft cache (1 append + 3 expansion levels)
    and 40 int4 products (append: 2 fuse + 7 layer; expansion: 1 root
    ranking + 3 x (2 fuse + 7 layer + 1 ranking)); at prefill, 3 draft
    attentions and 31 int4 products (the prefill's 128-row draft layer
    takes the dequantize path); per AR step, 32 int8-KV verifies."""
    from vispec_tpu_torch.ops import quant
    from vispec_tpu_torch.ops import verify_attention as va
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
        return {"1a": va.verify_attention.launches,
                "1b": va.verify_attention.launches_int8, "2": quant.q4_matmul.launches}

    def zero():
        va.verify_attention.launches = 0
        va.verify_attention.launches_int8 = 0
        quant.q4_matmul.launches = 0

    zero()
    spec = qmodel.specgenerate(prompt, max_new_tokens=128)
    spec_counts = counts()
    zero()
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
    emit({"phase": "profile_quant_spec_16_tokens",
          **_profile(lambda: qmodel.specgenerate(prompt, max_new_tokens=16))})
    return spec_counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU port only",
              file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "device": torch.cuda.get_device_name(0)})

    phase_build()
    rows = phase_kernel(dev)
    rows_int8 = phase_kernel_int8(dev)
    rows_q4 = phase_kernel_q4(dev)
    phase_int8_qdot_cost(dev)
    phase_tau_fixture(dev)
    phase_full_width_exact(dev)
    phase_quant_exact(dev)
    model, prompt, bf16_row = phase_full_width_depth(dev)
    quant_counts = phase_quant_full_depth(dev, model, prompt, bf16_row)

    def entry(name, source, replaces, launches, case_rows, main_row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in case_rows),
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]}

    # each kernel's main row: the target verify (32 of 36 launches per bf16
    # round; 32 of 36 int8-KV launches per quantized round) and the int4
    # product at [4096, 4096], M = 8 (6 of the 10 products per expansion level)
    q4_main = next(r for r in rows_q4 if r["case"] == "q4_4096x4096_m8")
    emit({"kernels": [
        entry("verify_attention", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", bf16_row["launches_spec"],
              rows, rows[0]),
        entry("verify_attention_int8", "vispec_tpu_torch/csrc/verify_attention.cu",
              "vispec_tpu/ops/pallas_attention.py:32", quant_counts["1b"],
              rows_int8, rows_int8[0]),
        entry("q4_matmul", "vispec_tpu_torch/csrc/q4_matmul.cu",
              "vispec_tpu/ops/quant.py:162", quant_counts["2"], rows_q4, q4_main),
    ]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
