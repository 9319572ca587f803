"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere.  The file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed (see README, "PyTorch + CUDA port")."""

import pytest
import torch

from vispec_tpu_torch.ops import kv_cache as kvc
from vispec_tpu_torch.ops import quant
from vispec_tpu_torch.ops import verify_attention as va


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, dtype, h, hkv, s, t_reg, start, layers, d, max_len=1024):
    g = torch.Generator(device=dev).manual_seed(start)
    shape = (hkv, max_len, d) if layers is None else (layers, hkv, max_len, d)
    q = torch.randn((h, s, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    v = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    mask = torch.rand((s, t_reg), generator=g, device=dev) < 0.5
    mask[torch.arange(s), torch.arange(s) % t_reg] = True
    st = torch.tensor(start, dtype=torch.int32, device=dev)
    layer = None if layers is None else torch.tensor(layers - 1, dtype=torch.int32,
                                                     device=dev)
    return (q, k, v, st, mask), layer


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,hkv,s,t_reg,start,layers,d,tol", [
    # f32: summation order only; bf16: p rounded to bf16 at another point of
    # the softmax than the plain version, and a bf16 output
    (torch.float32, 32, 32, 30, 30, 301, 3, 128, 1e-4),  # target verify
    (torch.bfloat16, 32, 32, 1, 1, 319, 3, 128, 2e-2),  # AR step
    (torch.bfloat16, 32, 32, 8, 24, 300, None, 128, 2e-2),  # draft expansion
    (torch.bfloat16, 32, 8, 30, 30, 301, None, 128, 2e-2),  # GQA, 4 groups
    (torch.float32, 4, 2, 16, 16, 45, 2, 16, 1e-4),  # the tau fixture's widths
    # Qwen2.5-VL-7B: 28 heads over 4 KV heads (groups of 7, 210 rows a KV
    # head at the verify), the float32 exact model's CUDA-core kernel
    (torch.float32, 28, 4, 30, 30, 301, 3, 128, 1e-4),
])
def test_verify_attention_kernel_matches_plain(cuda_device, dtype, h, hkv, s, t_reg,
                                               start, layers, d, tol):
    args, layer = _case(cuda_device, dtype, h, hkv, s, t_reg, start, layers, d)
    before = va.verify_attention.launches
    out = va.verify_attention(*args, layer_idx=layer)
    ref = va.verify_attention_ref(*args, layer_idx=layer)
    torch.cuda.synchronize()
    assert va.verify_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _edge_mask(dev, s, t_reg, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = torch.rand((s, t_reg), generator=g, device=dev) < 0.5
    mask[torch.arange(s), torch.arange(s) % t_reg] = True
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize("name,h,hkv,s,t_reg,start,layers,max_len", [
    # bf16, D = 128: the tensor-core partial kernel.  One block per (kv head,
    # chunk) walks 16-row query tiles, so the edges are the ragged last tile,
    # the second pass, and the chunk the region ends in.
    ("s1", 32, 32, 1, 1, 319, 3, 1024),  # one live row in a 16-row tile
    ("s5", 32, 32, 5, 5, 317, None, 1024),  # 3-D cache (no layer dim)
    ("s30", 32, 32, 30, 30, 301, 3, 1024),  # two tiles, the second ragged
    ("gs120", 32, 8, 30, 30, 301, 3, 1024),  # GQA 4 groups: two passes of 64 rows
    ("gs64", 8, 4, 32, 32, 100, None, 512),  # exactly one full pass
    ("gs65", 10, 2, 13, 13, 100, None, 512),  # one row into the second pass
    ("start0", 32, 32, 30, 30, 0, 2, 512),  # no committed prefix: every column masked by the region
    ("ends_at_max_len", 32, 32, 30, 30, 512 - 30, 2, 512),
    ("one_column_into_a_chunk", 32, 32, 30, 30, 5 * 64 + 1 - 30, 2, 512),
    ("region_fills_a_chunk_edge", 32, 32, 30, 30, 4 * 64 - 30, 2, 512),  # ends on the edge
    # Qwen2.5-VL-7B at max_len 4096: groups of 7 make 210 rows a KV head at
    # the verify (four passes, the last 18 rows: a tile of 2), 7 at the AR
    # step; the draft's 28 heads over 28 KV heads at the expansion
    ("qwen_verify_gs210", 28, 4, 30, 30, 1381, 3, 4096),
    ("qwen_ar_step_gs7", 28, 4, 1, 1, 1400, 3, 4096),
    ("qwen_draft_expand_h28", 28, 28, 8, 24, 1380, None, 4096),
])
def test_verify_attention_mma_kernel_edges(cuda_device, name, h, hkv, s, t_reg, start, layers,
                                           max_len):
    dev = cuda_device
    (q, k, v, st, _), layer = _case(dev, torch.bfloat16, h, hkv, s, t_reg, start, layers,
                                    128, max_len=max_len)
    # rows past the region must never be read: poison them
    k[..., start + t_reg:, :] = float("nan")
    v[..., start + t_reg:, :] = float("nan")
    args = (q, k, v, st, _edge_mask(dev, s, t_reg, start + s))
    out = va.verify_attention(*args, layer_idx=layer)
    ref = va.verify_attention_ref(*(a.nan_to_num() if a.is_floating_point() else a
                                    for a in args), layer_idx=layer)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_verify_attention_mma_kernel_row_with_no_visible_column_in_a_middle_chunk(cuda_device):
    """A region wider than a chunk, with query rows that see nothing of the
    chunk lying wholly inside it (row max -inf, sum 0 there), and one row that
    sees a single region column only."""
    dev, s, t_reg, start, max_len = cuda_device, 8, 200, 40, 512
    (q, k, v, st, _), _ = _case(dev, torch.bfloat16, 32, 32, s, t_reg, start, None, 128,
                                max_len=max_len)
    mask = _edge_mask(dev, s, t_reg, 7)
    mask[3, 64 - start:128 - start] = False  # chunk 1 = region columns 24..87
    mask[5, 64 - start:192 - start] = False  # chunks 1 and 2
    mask[6] = False
    mask[6, 150] = True
    out = va.verify_attention(q, k, v, st, mask)
    ref = va.verify_attention_ref(q, k, v, st, mask)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,s,t_reg", [(32, 32, 30, 30), (32, 8, 30, 30), (32, 32, 5, 5),
                                           (28, 4, 30, 30)])  # Qwen2.5-VL-7B, B = 4
def test_verify_attention_batched_mma_kernel_ragged_slots(cuda_device, h, hkv, s, t_reg):
    """B = 4 at the serving round's starts, each slot at another layer."""
    dev, b, layers, max_len = cuda_device, 4, 4, 2048
    starts, layer_of = (301, 129, 777, 1500), (0, 3, 1, 2)
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((b, h, s, 128), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, layers, hkv, max_len, 128), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn(k.shape, generator=g, device=dev, dtype=torch.bfloat16)
    mask = torch.stack([_edge_mask(dev, s, t_reg, i) for i in range(b)])
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    layer = torch.tensor(layer_of, dtype=torch.int32, device=dev)
    before = va.verify_attention_batched.launches
    out = va.verify_attention_batched(q, k, v, st, mask, layer)
    ref = va.verify_attention_batched_ref(q, k, v, st, mask, layer)
    torch.cuda.synchronize()
    assert va.verify_attention_batched.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    # each slot equals the single-request kernel on that slot, bit for bit
    for i in range(b):
        one = va.verify_attention(q[i], k[i], v[i], st[i], mask[i], layer[i])
        assert torch.equal(one, out[i])


def _attention_kernels(fn):
    """{kernel: launches} of the attention kernels that ``fn`` runs on the
    card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            tag = next((t for t in ("partial_kernel_mma", "combine_kernel", "partial_kernel")
                        if t in e.key), None)
            if tag:
                out[tag] = out.get(tag, 0) + e.count
    return out


@pytest.mark.gpu
def test_verify_attention_other_instantiations_keep_their_kernel(cuda_device):
    """The dispatch: head_dim 128 is one launch of the tensor-core kernel
    for bf16 and float32 q, over q's own cache and an int8 cache alike (no
    combine); head_dim 16 runs the CUDA-core partial kernel and the combine.
    Each within its dtype's limit of the plain version."""
    dev = cuda_device
    for dtype, d, int8, tol in [(torch.float32, 128, False, 1e-4),
                                (torch.bfloat16, 128, False, 2e-2),
                                (torch.float32, 128, True, 1e-4),
                                (torch.bfloat16, 128, True, 2e-2),
                                (torch.float32, 16, False, 1e-4),
                                (torch.bfloat16, 16, False, 2e-2),
                                (torch.float32, 16, True, 1e-4),
                                (torch.bfloat16, 16, True, 2e-2)]:
        h, hkv = (4, 2) if d == 16 else (32, 8)
        (q, k, v, st, mask), layer = _case(dev, dtype, h, hkv, 30, 30, 301, 2, d)
        ks = vs = None
        if int8:
            k, ks = kvc.quantize_rows(k)
            v, vs = kvc.quantize_rows(v)
        outs = []
        ran = _attention_kernels(
            lambda: outs.append(va.verify_attention(q, k, v, st, mask, layer, ks, vs)))
        want = ({"partial_kernel_mma": 1} if d == 128 else
                {"partial_kernel": 1, "combine_kernel": 1})
        assert ran == want, (dtype, d, int8, ran)
        ref = va.verify_attention_ref(q, k, v, st, mask, layer, ks, vs)
        err = (outs[0].float() - ref.float()).abs().max().item()
        assert err <= tol, (dtype, d, int8, err)


@pytest.mark.gpu
@pytest.mark.parametrize("name,h,hkv,s,t_reg,start,layers,max_len", [
    # float32 q at D = 128: the tensor-core kernel in 3xTF32, at the bf16
    # kernel's edges (a ragged last query tile, a second pass, the chunk the
    # region ends in)
    ("s1", 32, 32, 1, 1, 319, 3, 1024),
    ("s5", 32, 32, 5, 5, 317, None, 1024),
    ("s30", 32, 32, 30, 30, 301, 3, 1024),
    ("gs120", 32, 8, 30, 30, 301, 3, 1024),
    ("gs64", 8, 4, 32, 32, 100, None, 512),
    ("gs65", 10, 2, 13, 13, 100, None, 512),
    ("start0", 32, 32, 30, 30, 0, 2, 512),
    ("ends_at_max_len", 32, 32, 30, 30, 512 - 30, 2, 512),
    ("one_column_into_a_chunk", 32, 32, 30, 30, 5 * 64 + 1 - 30, 2, 512),
    ("region_fills_a_chunk_edge", 32, 32, 30, 30, 4 * 64 - 30, 2, 512),
    ("qwen_verify_gs210", 28, 4, 30, 30, 1381, 3, 4096),
    ("getkacc_s1", 32, 32, 1, 1, 400, None, 519),  # max_len not a multiple of 64
])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_verify_attention_f32_mma_kernel_edges(cuda_device, name, h, hkv, s, t_reg, start,
                                               layers, max_len, int8):
    dev = cuda_device
    (q, k, v, st, _), layer = _case(dev, torch.float32, h, hkv, s, t_reg, start, layers, 128,
                                    max_len=max_len)
    mask = _edge_mask(dev, s, t_reg, start + s)
    if int8:
        clean, poisoned = _int8_poisoned(k, v, start + t_reg)
        ks, vs = poisoned[2:]
        out = va.verify_attention(q, *poisoned[:2], st, mask, layer, ks, vs)
        ref = va.verify_attention_ref(q, *clean[:2], st, mask, layer, *clean[2:])
    else:
        k[..., start + t_reg:, :] = float("nan")  # rows past the region are never read
        v[..., start + t_reg:, :] = float("nan")
        out = va.verify_attention(q, k, v, st, mask, layer)
        ref = va.verify_attention_ref(q, k.nan_to_num(), v.nan_to_num(), st, mask, layer)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_verify_attention_f32_mma_kernel_row_with_no_visible_column_in_a_middle_chunk(
        cuda_device, dtype, tol):
    """Rows that see nothing of a chunk inside the region, and a row that sees
    one region column only, over float32 q (and bf16 q over an int8 cache)."""
    dev, s, t_reg, start, max_len = cuda_device, 8, 200, 40, 512
    (q, k, v, st, _), _ = _case(dev, dtype, 32, 32, s, t_reg, start, None, 128,
                                max_len=max_len)
    mask = _edge_mask(dev, s, t_reg, 7)
    mask[3, 64 - start:128 - start] = False
    mask[5, 64 - start:192 - start] = False
    mask[6] = False
    mask[6, 150] = True
    for int8 in (False, True):
        kk, vv, ks, vs = (k, v, None, None)
        if int8:
            (kk, ks), (vv, vs) = kvc.quantize_rows(k), kvc.quantize_rows(v)
        out = va.verify_attention(q, kk, vv, st, mask, None, ks, vs)
        ref = va.verify_attention_ref(q, kk, vv, st, mask, None, ks, vs)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= tol, int8


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,s,t_reg", [(32, 32, 30, 30), (32, 8, 30, 30), (32, 32, 1, 1),
                                           (28, 4, 30, 30)])
@pytest.mark.parametrize("int8", [False, True], ids=["f32_cache", "int8_cache"])
def test_verify_attention_batched_f32_mma_kernel_ragged_slots(cuda_device, h, hkv, s, t_reg,
                                                              int8):
    """float32 q at B = 4: a slot whose region ends at max_len, one with no
    committed prefix, one whose region ends one column into a chunk, a short
    one, each at another layer, rows past each slot's region poisoned.  Each
    slot equals the single-request kernel on that slot, bit for bit."""
    dev, b, layers, max_len = cuda_device, 4, 4, 1024
    starts, layer_of = (max_len - t_reg, 0, 5 * 64 + 1 - t_reg, 77), (0, 3, 1, 2)
    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((b, h, s, 128), generator=g, device=dev)
    k = torch.randn((b, layers, hkv, max_len, 128), generator=g, device=dev)
    v = torch.randn(k.shape, generator=g, device=dev)
    mask = torch.stack([_edge_mask(dev, s, t_reg, i) for i in range(b)])
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    layer = torch.tensor(layer_of, dtype=torch.int32, device=dev)
    if int8:
        clean, (k8, v8, ks, vs) = _int8_poisoned(k, v, [x + t_reg for x in starts])
        args, ref_args = (k8, v8, st, mask, layer, ks, vs), (*clean[:2], st, mask, layer,
                                                              *clean[2:])
    else:
        ref_args = (k.clone(), v.clone(), st, mask, layer)
        for i, x in enumerate(starts):
            k[i, ..., x + t_reg:, :] = float("nan")
            v[i, ..., x + t_reg:, :] = float("nan")
        args = (k, v, st, mask, layer)
    out = va.verify_attention_batched(q, *args)
    ref = va.verify_attention_batched_ref(q, *ref_args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4
    for i in range(b):
        one = va.verify_attention(q[i], *(a[i] for a in args))
        assert torch.equal(one, out[i])


# (tree_start, live chunks of 64 rows) at T_reg = 30, max_len 4096: a cluster
# of 8 with one live chunk (seven blocks with none), 7, exactly 8, 9 (one
# block walks two), LLaVA-1.6's 47 and the whole 64 (a region that ends at
# max_len)
FOLD_CASES = [(10, 1), (370, 7), (470, 8), (520, 9), (2950, 47), (4066, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("start,live", FOLD_CASES, ids=[f"live{n}" for _, n in FOLD_CASES])
@pytest.mark.parametrize("dtype,int8,tol", [(torch.bfloat16, False, 2e-2),
                                            (torch.bfloat16, True, 2e-2),
                                            (torch.float32, False, 1e-4),
                                            (torch.float32, True, 1e-4)],
                         ids=["bf16", "bf16_int8", "f32", "f32_int8"])
def test_verify_attention_fold_over_live_chunks(cuda_device, start, live, dtype, int8, tol):
    """The cluster's reduction at 1 to 64 live chunks, GQA with 4 groups (two
    passes of query rows), against the plain version; rows past the live end
    poisoned."""
    assert -(-(start + 30) // 64) == live
    dev, max_len = cuda_device, 4096
    (q, k, v, st, _), _ = _case(dev, dtype, 32, 8, 30, 30, start, None, 128, max_len=max_len)
    mask = _edge_mask(dev, 30, 30, start)
    if int8:
        clean, poisoned = _int8_poisoned(k, v, start + 30)
        out = va.verify_attention(q, *poisoned[:2], st, mask, None, *poisoned[2:])
        ref = va.verify_attention_ref(q, *clean[:2], st, mask, None, *clean[2:])
    else:
        ref = va.verify_attention_ref(q, k, v, st, mask)
        k[:, start + 30:] = float("nan")
        v[:, start + 30:] = float("nan")
        out = va.verify_attention(q, k, v, st, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False), (torch.float32, True)],
                         ids=["bf16", "bf16_int8", "f32", "f32_int8"])
def test_verify_attention_mma_kernel_is_reproducible(cuda_device, dtype, int8):
    """No atomics and a fixed reduction order: two runs agree bit for bit,
    single and batched, at 47 live chunks (every block of a cluster of 8
    walks five or six)."""
    dev = cuda_device
    (q, k, v, st, mask), layer = _case(dev, dtype, 32, 8, 30, 30, 2950, 2, 128, max_len=4096)
    ks = vs = None
    if int8:
        k, ks = kvc.quantize_rows(k)
        v, vs = kvc.quantize_rows(v)
    a = va.verify_attention(q, k, v, st, mask, layer, ks, vs)
    b = va.verify_attention(q, k, v, st, mask, layer, ks, vs)
    batch = [x[None].expand(2, *x.shape).contiguous() for x in (q, k, v, mask)]
    scales = [None if x is None else x[None].expand(2, *x.shape).contiguous()
              for x in (ks, vs)]
    two = torch.stack([st, st])
    layers = torch.stack([layer, layer])
    c = va.verify_attention_batched(batch[0], batch[1], batch[2], two, batch[3], layers,
                                    *scales)
    d = va.verify_attention_batched(batch[0], batch[1], batch[2], two, batch[3], layers,
                                    *scales)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert torch.equal(c[0], a) and torch.equal(c[1], a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,int8", [(torch.bfloat16, False), (torch.bfloat16, True),
                                        (torch.float32, False), (torch.float32, True)],
                         ids=["bf16", "bf16_int8", "f32", "f32_int8"])
def test_verify_attention_writes_every_output_element(cuda_device, dtype, int8):
    """The output buffer is taken from the allocator's cache after a tensor
    of its size was filled with NaN there: the cluster's reduction writes
    every element (GQA, two passes of query rows)."""
    dev = cuda_device
    (q, k, v, st, mask), layer = _case(dev, dtype, 32, 8, 30, 30, 301, 2, 128)
    ks = vs = None
    if int8:
        k, ks = kvc.quantize_rows(k)
        v, vs = kvc.quantize_rows(v)
    ref = va.verify_attention_ref(q, k, v, st, mask, layer, ks, vs)
    torch.cuda.synchronize()
    poison = torch.full_like(q, float("nan"))
    ptr = poison.data_ptr()
    del poison
    out = va.verify_attention(q, k, v, st, mask, layer, ks, vs)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr  # the poisoned block came back as the output
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= (1e-4 if dtype == torch.float32
                                                              else 2e-2)


def _int8_poisoned(k, v, live):
    """``(k8, v8, ks, vs)`` quantized per row, and the same with every row at
    and past ``live`` (a count per slot along the leading dim, or one count)
    set to 127 and its scales to NaN: the kernel must not read those rows."""
    k8, ks = kvc.quantize_rows(k)
    v8, vs = kvc.quantize_rows(v)
    clean = (k8, v8, ks, vs)
    poisoned = tuple(t.clone() for t in clean)
    for i, n in enumerate(live if isinstance(live, (list, tuple)) else [live]):
        sel = (i,) if isinstance(live, (list, tuple)) else ()
        for t in poisoned[:2]:
            t[sel][..., n:, :] = 127
        for t in poisoned[2:]:
            t[sel][..., n:] = float("nan")
    return clean, poisoned


@pytest.mark.gpu
@pytest.mark.parametrize("name,h,hkv,s,t_reg,start,layers,max_len", [
    # bf16 q over an int8 cache at D = 128: the tensor-core partial kernel
    # with raw int8 rows converted in shared memory and P.V as hi + lo
    ("s1", 32, 32, 1, 1, 319, 3, 1024),
    ("s5", 32, 32, 5, 5, 317, None, 1024),  # 3-D cache (no layer dim)
    ("s30", 32, 32, 30, 30, 301, 3, 1024),
    ("gs120", 32, 8, 30, 30, 301, 3, 1024),  # GQA 4 groups: two passes of 64 rows
    ("gs65", 10, 2, 13, 13, 100, None, 512),
    ("start0", 32, 32, 30, 30, 0, 2, 512),
    ("ends_at_max_len", 32, 32, 30, 30, 512 - 30, 2, 512),
    ("one_column_into_a_chunk", 32, 32, 30, 30, 5 * 64 + 1 - 30, 2, 512),
    ("qwen_verify_gs210", 28, 4, 30, 30, 1381, 3, 4096),  # Qwen2.5-VL-7B, quantized
])
def test_verify_attention_int8_mma_kernel_edges(cuda_device, name, h, hkv, s, t_reg, start,
                                                layers, max_len):
    dev = cuda_device
    (q, k, v, st, _), layer = _case(dev, torch.bfloat16, h, hkv, s, t_reg, start, layers,
                                    128, max_len=max_len)
    mask = _edge_mask(dev, s, t_reg, start + s)
    clean, poisoned = _int8_poisoned(k, v, start + t_reg)
    before = va.verify_attention.launches_int8
    out = va.verify_attention(q, *poisoned[:2], st, mask, layer, *poisoned[2:])
    ref = va.verify_attention_ref(q, *clean[:2], st, mask, layer, *clean[2:])
    torch.cuda.synchronize()
    assert va.verify_attention.launches_int8 == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_verify_attention_int8_mma_kernel_row_with_no_visible_column_in_a_middle_chunk(
        cuda_device):
    """As the bf16 case: rows that see nothing of a chunk inside the region,
    and a row that sees one region column only."""
    dev, s, t_reg, start, max_len = cuda_device, 8, 200, 40, 512
    (q, k, v, st, _), _ = _case(dev, torch.bfloat16, 32, 32, s, t_reg, start, None, 128,
                                max_len=max_len)
    k8, ks = kvc.quantize_rows(k)
    v8, vs = kvc.quantize_rows(v)
    mask = _edge_mask(dev, s, t_reg, 7)
    mask[3, 64 - start:128 - start] = False
    mask[5, 64 - start:192 - start] = False
    mask[6] = False
    mask[6, 150] = True
    out = va.verify_attention(q, k8, v8, st, mask, None, ks, vs)
    ref = va.verify_attention_ref(q, k8, v8, st, mask, None, ks, vs)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,s,t_reg", [(32, 32, 30, 30), (32, 8, 30, 30), (32, 32, 1, 1),
                                           (28, 4, 30, 30)])  # Qwen2.5-VL-7B, B = 4
def test_verify_attention_batched_int8_mma_kernel_ragged_slots(cuda_device, h, hkv, s, t_reg):
    """B = 4 over an int8 cache: a slot whose region ends at max_len, one with
    no committed prefix, one whose region ends one column into a chunk, each
    at another layer, rows past each slot's region poisoned.  Each slot
    equals the single-request kernel on that slot, bit for bit."""
    dev, b, layers, max_len = cuda_device, 4, 4, 1024
    starts, layer_of = (max_len - t_reg, 0, 5 * 64 + 1 - t_reg, 77), (0, 3, 1, 2)
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((b, h, s, 128), generator=g, device=dev, dtype=torch.bfloat16)
    k = torch.randn((b, layers, hkv, max_len, 128), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn(k.shape, generator=g, device=dev, dtype=torch.bfloat16)
    clean, (k8, v8, ks, vs) = _int8_poisoned(k, v, [st + t_reg for st in starts])
    mask = torch.stack([_edge_mask(dev, s, t_reg, i) for i in range(b)])
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    layer = torch.tensor(layer_of, dtype=torch.int32, device=dev)
    before = va.verify_attention_batched.launches_int8
    out = va.verify_attention_batched(q, k8, v8, st, mask, layer, ks, vs)
    ref = va.verify_attention_batched_ref(q, *clean[:2], st, mask, layer, *clean[2:])
    torch.cuda.synchronize()
    assert va.verify_attention_batched.launches_int8 == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    for i in range(b):
        one = va.verify_attention(q[i], k8[i], v8[i], st[i], mask[i], layer[i], ks[i], vs[i])
        assert torch.equal(one, out[i])


@pytest.mark.gpu
def test_verify_attention_int8_mma_kernel_is_reproducible(cuda_device):
    """No atomics and a fixed combine order: two runs agree bit for bit."""
    (q, k, v, st, mask), layer = _case(cuda_device, torch.bfloat16, 32, 8, 30, 30, 301, 2,
                                       128)
    k8, ks = kvc.quantize_rows(k)
    v8, vs = kvc.quantize_rows(v)
    a = va.verify_attention(q, k8, v8, st, mask, layer, ks, vs)
    b = va.verify_attention(q, k8, v8, st, mask, layer, ks, vs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_verify_attention_kernel_refuses_unbuilt_head_dim(cuda_device):
    args, _ = _case(cuda_device, torch.float32, 2, 2, 4, 4, 10, None, 64, max_len=64)
    before = va.verify_attention.launches
    with pytest.raises(ValueError, match="head_dim"):
        va.verify_attention(*args)
    assert va.verify_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,h,hkv,s,t_reg,start,layers,d,tol", [
    # int8 K/V with per-row scales (table row 1b): the kernel scales scores
    # and p, the plain version dequantizes the rows (summation order only,
    # plus the bf16 output)
    (torch.bfloat16, 32, 32, 30, 30, 301, 3, 128, 2e-2),  # target verify
    (torch.bfloat16, 32, 32, 1, 1, 319, 3, 128, 2e-2),  # AR step
    (torch.bfloat16, 32, 8, 30, 30, 301, 2, 128, 2e-2),  # GQA, 4 groups
    (torch.float32, 32, 32, 30, 30, 301, 2, 128, 1e-4),  # the 2-layer f32 model
    (torch.float32, 4, 2, 16, 16, 45, None, 16, 1e-4),  # head_dim 16, 3-D cache
])
def test_verify_attention_int8_kernel_matches_plain(cuda_device, dtype, h, hkv, s, t_reg,
                                                    start, layers, d, tol):
    (q, k, v, st, mask), layer = _case(cuda_device, dtype, h, hkv, s, t_reg, start, layers, d)
    k8, ks = kvc.quantize_rows(k)
    v8, vs = kvc.quantize_rows(v)
    args = (q, k8, v8, st, mask, layer, ks, vs)
    before, before_1a = va.verify_attention.launches_int8, va.verify_attention.launches
    out = va.verify_attention(*args)
    ref = va.verify_attention_ref(*args)
    torch.cuda.synchronize()
    assert va.verify_attention.launches_int8 == before + 1
    assert va.verify_attention.launches == before_1a
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol


def _q4_case(dev, k, n, group_size, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return quant.quantize_q4(torch.randn((k, n), generator=g, device=dev) * 0.02,
                             group_size=group_size), g


# The 7B draft's matrices, two small ones, and ragged ones: N = 144 (a
# second column tile with 16 live columns), groups of 24 and 8 rows (a group
# ends halfway through a k16 step), 25 and 65 groups (uneven K splits).
Q4_SHAPES = [(4096, 4096, 128), (11008, 4096, 128), (4096, 32000, 128), (768, 512, 128),
             (64, 128, 32), (1200, 144, 24), (1040, 144, 8), (48, 144, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,group_size", Q4_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 5, 8, 17, 20, 32, 33, 64])
def test_q4_matmul_kernel_matches_plain(cuda_device, k, n, group_size, m):
    """Kernel 2 against the same quantized math in float32 (summation order
    only) and against its plain version, which rounds the dequantized
    weights to bf16 (relative to the output's largest magnitude)."""
    w4, g = _q4_case(cuda_device, k, n, group_size, k + n + m)
    assert k // w4.s.shape[0] == group_size
    x = torch.randn((m, k), generator=g, device=cuda_device, dtype=torch.bfloat16)
    before = quant.q4_matmul.launches
    out = quant.q4_matmul(x, w4)
    ref = quant.qdot4_ref(x, w4)
    exact = x.float() @ quant.dequantize(w4, torch.float32)
    torch.cuda.synchronize()
    assert quant.q4_matmul.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert ((out - exact).abs().max() / exact.abs().max()).item() <= 1e-5
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,group_size,m", [(11008, 4096, 128, 20), (4096, 4096, 128, 64),
                                              (1040, 144, 8, 33)])
def test_q4_matmul_kernel_is_reproducible(cuda_device, k, n, group_size, m):
    """The K split is reduced in a fixed order: two calls agree bitwise."""
    w4, g = _q4_case(cuda_device, k, n, group_size, 3 * m)
    x = torch.randn((m, k), generator=g, device=cuda_device, dtype=torch.bfloat16)
    a = quant.q4_matmul(x, w4)
    b = quant.q4_matmul(x, w4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n,group_size,m", [(1200, 144, 24, 5), (4096, 4096, 128, 33),
                                              (1040, 144, 8, 17)])
def test_q4_matmul_kernel_reads_nothing_past_its_operands(cuda_device, k, n, group_size, m):
    """x's rows past M and the floats past the last scale are NaN in the same
    allocations; none of it reaches the output."""
    w4, g = _q4_case(cuda_device, k, n, group_size, 5 * m)
    xbuf = torch.full((64, k), float("nan"), device=cuda_device, dtype=torch.bfloat16)
    xbuf[:m] = torch.randn((m, k), generator=g, device=cuda_device, dtype=torch.bfloat16)
    sbuf = torch.full((w4.s.numel() + 4 * n,), float("nan"), device=cuda_device)
    sbuf[:w4.s.numel()] = w4.s.reshape(-1)
    poisoned = quant.Q4Tensor(w4.packed, sbuf[:w4.s.numel()].view(w4.s.shape))
    x = xbuf[:m]
    out = quant.q4_matmul(x, poisoned)
    exact = x.float() @ quant.dequantize(w4, torch.float32)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert ((out - exact).abs().max() / exact.abs().max()).item() <= 1e-5


@pytest.mark.gpu
def test_q4_matmul_kernel_refuses_what_it_does_not_take(cuda_device):
    w4 = quant.quantize_q4(torch.randn((20, 256), device=cuda_device))  # group size 10
    x = torch.randn((4, 20), device=cuda_device, dtype=torch.bfloat16)
    before = quant.q4_matmul.launches
    with pytest.raises(ValueError, match="group size"):
        quant.q4_matmul(x, w4)
    with pytest.raises(ValueError, match="M = 65"):
        quant.q4_matmul(torch.zeros((65, 64), device=cuda_device, dtype=torch.bfloat16),
                        quant.quantize_q4(torch.randn((64, 128), device=cuda_device)))
    assert quant.q4_matmul.launches == before
    # qdot4 sends such shapes to dequantize + GEMM, by shape alone
    assert quant.qdot4(x, w4).shape == (4, 256)
    assert quant.q4_matmul.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,int8,b,d,layers", [
    # the batched grid (table row 1c): B slots in one launch pair, each with
    # its own cache, start, layer and mask; the same tolerances as 1a/1b
    (torch.bfloat16, False, 1, 128, 3),
    (torch.bfloat16, False, 4, 128, 3),
    (torch.float32, False, 3, 128, None),  # the draft's layerless cache
    (torch.float32, False, 2, 16, 2),  # head_dim 16 (the tau fixture's)
    (torch.bfloat16, True, 4, 128, 3),  # int8 K/V with per-row scales
    (torch.float32, True, 2, 16, None),
])
def test_verify_attention_batched_kernel_matches_plain(cuda_device, dtype, int8, b, d,
                                                       layers):
    dev, max_len, s, t_reg = cuda_device, 512, 12, 12
    h, hkv = (4, 2) if d == 16 else (8, 4)
    g = torch.Generator(device=dev).manual_seed(b * d)
    shape = (b, hkv, max_len, d) if layers is None else (b, layers, hkv, max_len, d)
    q = torch.randn((b, h, s, d), generator=g, device=dev, dtype=dtype)
    k = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    v = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    ks = vs = None
    if int8:
        k, ks = kvc.quantize_rows(k)
        v, vs = kvc.quantize_rows(v)
    mask = torch.rand((b, s, t_reg), generator=g, device=dev) < 0.5
    mask[:, torch.arange(s), torch.arange(s)] = True
    # ragged starts: a region ending at max_len, a slot at start 0
    st = torch.tensor([max_len - t_reg, 0, 301, 77][:b], dtype=torch.int32, device=dev)
    layer = None if layers is None else torch.tensor(
        [layers - 1, 0, 1, layers - 1][:b], dtype=torch.int32, device=dev)
    args = (q, k, v, st, mask.contiguous(), layer, ks, vs)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(va.verify_attention_batched, counter)
    before_1a = (va.verify_attention.launches, va.verify_attention.launches_int8)
    out = va.verify_attention_batched(*args)
    ref = va.verify_attention_batched_ref(*args)
    torch.cuda.synchronize()
    assert getattr(va.verify_attention_batched, counter) == before + 1
    assert (va.verify_attention.launches, va.verify_attention.launches_int8) == before_1a
    assert out.dtype == dtype and out.shape == q.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_verify_attention_batched_refuses_a_cache_without_the_slot_dim(cuda_device):
    (q, k, v, st, mask), layer = _case(cuda_device, torch.float32, 4, 2, 4, 4, 10, 2, 16,
                                       max_len=64)
    before = va.verify_attention_batched.launches
    with pytest.raises(ValueError, match="slot dim"):
        va.verify_attention_batched(q[None].expand(2, *q.shape).contiguous(), k, v,
                                    st.repeat(2), mask[None].expand(2, *mask.shape)
                                    .contiguous(), layer.repeat(2))
    assert va.verify_attention_batched.launches == before


# ---------------------------------------------------------------------------
# Sampling and Medusa: the key stream, host reads, depth-5 regions
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_key_stream_is_equal_on_the_card_and_the_cpu(cuda_device):
    """Keys, splits and uniforms are integer hashes: bit for bit the same on
    the card; the Gumbel noise within float32 log rounding."""
    from vispec_tpu_torch.ops import rng

    kc, kd = rng.keys(range(100), "cpu"), rng.keys(range(100), cuda_device)
    assert torch.equal(kd.cpu(), kc)
    assert torch.equal(torch.stack(rng.split(kd, 3)).cpu(), torch.stack(rng.split(kc, 3)))
    assert torch.equal(rng.uniform(kd, (5, 30)).cpu(), rng.uniform(kc, (5, 30)))
    torch.testing.assert_close(rng.gumbel(kd, (1000,)).cpu(), rng.gumbel(kc, (1000,)),
                               rtol=1e-5, atol=1e-5)


def _toy_model(dev, **kw):
    """A tests/torch_parity.py-sized model on the card (head dim 16)."""
    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.models import draft, llama
    from vispec_tpu_torch.spec.spec_model import SpecModel

    w = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512)
    tcfg, dcfg = LlamaConfig(num_hidden_layers=3, **w), DraftConfig(**w)
    g = torch.Generator(device=dev).manual_seed(0)
    tparams = llama.init_params(tcfg, g, dev, torch.float32)
    dparams = draft.init_params(dcfg, g, dev, torch.float32)
    dparams["embed"] = tparams["embed"]
    return SpecModel(tcfg, dcfg, SpecConfig(total_tokens=12, depth=3, top_k=4), tparams,
                     dparams, max_len=256, dtype=torch.float32, device=dev, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sampled", "per_request", "medusa"])
def test_sampled_and_medusa_rounds_make_no_host_read(cuda_device, mode):
    """One decode round under CUDA's sync debug mode set to error: a sampled
    round (T 1, top-p 0.9, a repetition penalty), a per-request round and a
    Medusa round wait on nothing."""
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.models import medusa
    from vispec_tpu_torch.ops import rng
    from vispec_tpu_torch.spec import loop
    from vispec_tpu_torch.spec.spec_model import padded_text_embeds

    dev = cuda_device
    mparams = medusa.init_params(64, dev, torch.float32) if mode == "medusa" else None
    model = _toy_model(dev, mparams=mparams)
    prompt = list(range(10, 30))
    embeds = padded_text_embeds(model.tparams, prompt, 128, dev)
    key = rng.key(0, dev)
    if mode == "medusa":
        sampling = loop.SamplingParams()
        state = loop.medusa_prefill(model.tparams, mparams, model.tcfg, model.spec, sampling,
                                    embeds, len(prompt), model.target_cache, 64)
    else:
        sampling, samp, seen = loop.SamplingParams(1.0, 0.9, 0, 1.3), None, None
        if mode == "per_request":
            sampling = loop.SamplingParams(0.0, 0.0, 8, per_request=True)
            samp = torch.tensor([1.0, 0.9, 1.3, 4.0], device=dev)
        seen = model._seen_mask(loop.SamplingParams(1.0, repetition_penalty=1.3), prompt)
        plan, span = draft_mod.make_prefill_plan(None, len(prompt), model.dcfg.num_q, 128,
                                                 max_span=64, device=dev)
        state = loop.spec_prefill(model.tparams, model.dparams, model.tcfg, model.dcfg,
                                  model.spec, plan, sampling, embeds, model.target_cache,
                                  model.draft_cache, 64, span, key=key, seen=seen, samp=samp)
    eos = torch.tensor(2, dtype=torch.int32, device=dev)
    cap = torch.tensor(32, dtype=torch.int32, device=dev)
    model._round(sampling, state, eos, cap)  # warm-up: first launches, kernel build
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = model._round(sampling, state, eos, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(state.new_token) >= 1  # the round committed at least its bonus token


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_medusa_depth5_region_matches_plain_in_1a_and_1c(cuda_device, dtype):
    """Medusa's verify region: trees of depth 5 from ``medusa.expand_tree``
    (30 nodes, SpecConfig()) as the region mask at Vicuna-7B's verify
    shape, through kernel 1a and, four different trees at ragged starts,
    through kernel 1c, against the plain versions."""
    from vispec_tpu_torch.configs import SpecConfig
    from vispec_tpu_torch.models import medusa

    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(21)
    heads = {k: v + 0.3 * torch.randn(v.shape, generator=g, device=dev)
             for k, v in medusa.init_params(128, dev, torch.float32).items()}
    head_w = torch.randn((128, 1000), generator=g, device=dev)
    trees = medusa.expand_tree(heads, SpecConfig(), torch.randn((4, 128), generator=g,
                                                                device=dev),
                               torch.zeros(4, dtype=torch.int32, device=dev), head_w)
    assert int(trees.depth.max()) == 5 and trees.mask.shape == (4, 30, 30)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    layers, max_len = 4, 2048
    q = torch.randn((4, 32, 30, 128), generator=g, device=dev, dtype=dtype)
    k = torch.randn((4, layers, 32, max_len, 128), generator=g, device=dev, dtype=dtype)
    v = torch.randn(k.shape, generator=g, device=dev, dtype=dtype)
    st = torch.tensor([301, 129, 777, 1500], dtype=torch.int32, device=dev)
    layer = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=dev)
    one = va.verify_attention(q[0], k[0], v[0], st[0], trees.mask[0], layer[0])
    ref = va.verify_attention_ref(q[0], k[0], v[0], st[0], trees.mask[0], layer[0])
    out = va.verify_attention_batched(q, k, v, st, trees.mask, layer)
    ref_b = va.verify_attention_batched_ref(q, k, v, st, trees.mask, layer)
    torch.cuda.synchronize()
    assert (one.float() - ref.float()).abs().max().item() <= tol
    assert (out.float() - ref_b.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_batched_kernel_at_the_getkacc_shape_matches_plain(cuda_device):
    """Kernel 1c at ``trainer.getkacc``'s rollout: 16 prefixes, one query row
    each, over a float32 draft cache of 512 + 5 + 2 rows (a row count that
    is not a multiple of the 64-row tile), 32 heads over 32."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(70)
    b, h, d, rows = 16, 32, 128, 519
    q = torch.randn((b, h, 1, d), generator=g, device=dev)
    k = torch.randn((b, h, rows, d), generator=g, device=dev)
    v = torch.randn((b, h, rows, d), generator=g, device=dev)
    starts = torch.randint(2, rows - 1, (b,), generator=g, device=dev, dtype=torch.int32)
    starts[0] = rows - 1  # a region ending at the cache's last row
    ones = torch.ones((b, 1, 1), dtype=torch.bool, device=dev)
    before = va.verify_attention_batched.launches
    out = va.verify_attention_batched(q, k, v, starts, ones)
    ref = va.verify_attention_batched_ref(q, k, v, starts, ones)
    torch.cuda.synchronize()
    assert va.verify_attention_batched.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One ``train_step`` (mtp_steps 2, float32, no warm-up so the update is
    live) of a toy draft with an image span, on the card and on the CPU from
    one state: the parameters within 1% of the learning rate, the loss
    within 1e-4 (relative)."""
    import numpy as np

    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.train import step as tstep
    from vispec_tpu_torch.train import trainer

    cpu, lr = torch.device("cpu"), 2e-3
    dcfg = DraftConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=512)
    g = torch.Generator().manual_seed(3)
    params = draft_mod.init_params(dcfg, g, cpu, torch.float32)
    head = 0.3 * torch.randn((64, 256), generator=g)
    rng = np.random.default_rng(3)
    img = np.zeros(60, bool)
    img[6:20] = True
    mask = np.zeros(60, np.float32)
    mask[20:] = 1
    sample = {"hidden_state": rng.normal(0, 1, (60, 64)).astype(np.float32),
              "inputs_embeds": rng.normal(0, 1, (60, 64)).astype(np.float32),
              "loss_mask": mask, "image_mask": img}
    cfg = trainer.TrainConfig(lr=lr, max_len=64, max_images=2, max_span_bucket=16)
    ex = trainer.prepare_example(sample, cfg, dcfg, np.random.default_rng(5))
    opt = tstep.make_optimizer(lr, 0, 1000)
    out = {}
    for dev in (cpu, cuda_device):
        # copies: a step updates its parameters in place
        p = {k: ({kk: vv.clone().to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.clone().to(dev)) for k, v in params.items()}
        batch, _ = trainer.batch_examples([ex], dev)
        p, _, m = tstep.train_step(p, opt.init(p), dcfg, head.to(dev), batch, opt,
                                   mtp_steps=2, max_span=16)
        out[dev.type] = (p, float(m["loss"]))
    (pc, lc), (pd, ld) = out["cpu"], out["cuda"]
    assert abs(ld - lc) <= 1e-4 * max(abs(lc), 1.0)
    for path, t in tstep.leaves(pd):
        ref = dict(tstep.leaves(pc))[path]
        assert (t.cpu() - ref).abs().max().item() <= 0.01 * lr, path
