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

from tests.torch_parity import t2n
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


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    q, k, v, tm, start = _case(2, 1, 4, 4, 20, d=16, max_len=64, seed=3)
    before = tva.verify_attention.launches
    out = _port(q, k, v, tm, start)
    ref = t2n(tva.verify_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), start,
        torch.from_numpy(tm)))
    np.testing.assert_array_equal(out, ref)
    assert tva.verify_attention.launches == before
