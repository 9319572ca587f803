"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere.  The file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed (see README, "PyTorch + CUDA port")."""

import pytest
import torch

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
