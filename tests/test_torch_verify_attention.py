"""The port's verify_attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its XLA ``attend`` oracle.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_kernels_gpu.py.

Tolerance: 2e-4 abs/rel in float32, as tests/test_pallas_attention.py holds
the Pallas kernel to the same oracle (summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_parity import t2n, in_fresh_interpreter_module
from vispec_tpu.ops import pallas_attention
from vispec_tpu.ops.attention import attend as j_attend
from vispec_tpu.ops.attention import tree_verify_mask as j_tree_verify_mask
from vispec_tpu_torch.ops import verify_attention as tva

TOL = dict(rtol=2e-4, atol=2e-4)


def _case(hkv, groups, s, t_reg, start, layers=None, d=128, max_len=1024, seed=0):
    rng = np.random.default_rng(seed)
    h = hkv * groups
    cache_shape = (hkv, max_len, d) if layers is None else (layers, hkv, max_len, d)
    q = rng.normal(0, 1, (h, s, d)).astype(np.float32)
    k = rng.normal(0, 1, cache_shape).astype(np.float32)
    v = rng.normal(0, 1, cache_shape).astype(np.float32)
    # random region visibility; every row sees its own column and column 0
    tm = rng.uniform(size=(s, t_reg)) < 0.5
    tm[np.arange(s), np.arange(s) % t_reg] = True
    tm[:, 0] = True
    return q, k, v, tm, start


def _port(q, k, v, tm, start, layer=None):
    return t2n(tva.verify_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(start, dtype=torch.int32), torch.from_numpy(tm),
        layer_idx=None if layer is None else torch.tensor(layer, dtype=torch.int32)))


def _jax_kernel(q, k, v, tm, start, layer=None):
    with pltpu.force_tpu_interpret_mode():
        out = pallas_attention.verify_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(start, jnp.int32), jnp.asarray(tm), block=256,
            layer_idx=None if layer is None else jnp.asarray(layer, jnp.int32))
    return np.asarray(out)


def _jax_oracle(q, k, v, tm, start, layer=None):
    if layer is not None:
        k, v = k[layer], v[layer]
    s, t_reg = tm.shape
    if s == t_reg:
        mask = j_tree_verify_mask(jnp.asarray(tm), jnp.asarray(start, jnp.int32),
                                  k.shape[1])
    else:  # the JAX mask builder takes a square tree mask only
        mask = np.zeros((s, k.shape[1]), bool)
        mask[:, :start] = True
        mask[:, start:start + t_reg] = tm
        mask = jnp.asarray(mask)
    return np.asarray(j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask))


@pytest.mark.parametrize("hkv,groups,s,start", [(2, 1, 8, 100), (2, 2, 8, 500),
                                                (4, 1, 16, 37)])
def test_plain_matches_jax_kernel_and_oracle(hkv, groups, s, start):
    q, k, v, tm, start = _case(hkv, groups, s, s, start)
    out = _port(q, k, v, tm, start)
    np.testing.assert_allclose(out, _jax_oracle(q, k, v, tm, start), **TOL)
    np.testing.assert_allclose(out, _jax_kernel(q, k, v, tm, start), **TOL)


def test_layer_stacked_cache_with_layer_idx():
    q, k, v, tm, start = _case(2, 2, 8, 8, 300, layers=3, max_len=512, seed=1)
    out = _port(q, k, v, tm, start, layer=2)
    np.testing.assert_allclose(out, _jax_oracle(q, k, v, tm, start, layer=2), **TOL)
    np.testing.assert_allclose(out, _jax_kernel(q, k, v, tm, start, layer=2), **TOL)


def test_expand_shaped_region_wider_than_queries():
    """The draft's beam expansion: K=8 queries over a depth*K=24 scratch
    region (T_reg > S)."""
    q, k, v, tm, start = _case(2, 1, 8, 24, 77, max_len=512, seed=2)
    out = _port(q, k, v, tm, start)
    np.testing.assert_allclose(out, _jax_oracle(q, k, v, tm, start), **TOL)
    np.testing.assert_allclose(out, _jax_kernel(q, k, v, tm, start), **TOL)


def test_plain_in_bf16_matches_jax_kernel_in_bf16():
    """The plain version in the working type (bf16 q and cache) against the
    JAX kernel in interpret mode on the same bf16 inputs: GQA with 4 groups,
    S = 30, the region (rows 50..79) crossing a 64-row edge.  On the card the
    CUDA kernel is held to this plain version, so it is held to JAX here.

    Tolerance: one bf16 ulp at the output's scale.  Both compute f32 scores
    and softmax and round p to bf16 before P.V, but the JAX kernel rounds p
    relative to a running block maximum and rescales, and both round the
    output to bf16 once: results may land on neighbouring bf16 values.  With
    unit-normal values the outputs stay below 2 in magnitude, where
    neighbouring bf16 values lie 2^-7 apart."""
    hkv, groups, s, start = 2, 4, 30, 50
    q, k, v, tm, start = _case(hkv, groups, s, s, start, layers=2, max_len=256, seed=4)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    out = tva.verify_attention(bf(q), bf(k), bf(v), torch.tensor(start, dtype=torch.int32),
                               torch.from_numpy(tm),
                               layer_idx=torch.tensor(1, dtype=torch.int32))
    assert out.dtype == torch.bfloat16
    out = t2n(out.float())
    jb = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_attention.verify_attention(
            jb(q), jb(k), jb(v), jnp.asarray(start, jnp.int32), jnp.asarray(tm), block=64,
            layer_idx=jnp.asarray(1, jnp.int32))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(ref).max() < 2.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -7)
    # about half of the outputs agree to the bit (0.52 of them when this was
    # written), none differs by more than the one step allowed above
    assert (out == ref).mean() > 0.25


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    q, k, v, tm, start = _case(2, 1, 4, 4, 20, d=16, max_len=64, seed=3)
    before = tva.verify_attention.launches
    out = _port(q, k, v, tm, start)
    ref = t2n(tva.verify_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), start,
        torch.from_numpy(tm)))
    np.testing.assert_array_equal(out, ref)
    assert tva.verify_attention.launches == before


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
