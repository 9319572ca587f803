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


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096), (768, 512), (64, 128)])
@pytest.mark.parametrize("m", [1, 5, 8, 64])
def test_q4_matmul_kernel_matches_plain(cuda_device, k, n, m):
    """Kernel 2 against the same quantized math in float32 (summation order
    only) and against its plain version, which rounds the dequantized
    weights to bf16 (relative to the output's largest magnitude)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + n + m)
    w4 = quant.quantize_q4(torch.randn((k, n), generator=g, device=cuda_device) * 0.02)
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
