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


# The clusters of each size the H100 80GB HBM3 holds at once, by (q dtype,
# int8 cache, query rows of a kv head up to 64), from the occupancy query
# (``resident_clusters``) as chip_smoke.py --attention-sweep printed it: a
# size whose extra slots of shared memory cost blocks an SM holds fewer.
H100_RESIDENT = {
    ("bfloat16", False, 1): {8: 45, 4: 92, 2: 198, 1: 396},
    ("bfloat16", False, 5): {8: 45, 4: 92, 2: 198, 1: 396},
    ("bfloat16", False, 8): {8: 45, 4: 92, 2: 198, 1: 264},
    ("bfloat16", False, 30): {8: 45, 4: 92, 2: 132, 1: 132},
    ("bfloat16", False, 64): {8: 45, 4: 62, 2: 66, 1: 0},
    ("bfloat16", True, 1): {8: 45, 4: 92, 2: 198, 1: 396},
    ("bfloat16", True, 30): {8: 45, 4: 62, 2: 66, 1: 132},
    ("float32", False, 1): {8: 30, 4: 62, 2: 132, 1: 264},
    ("float32", False, 30): {8: 30, 4: 30, 2: 66, 1: 132},
    ("float32", False, 64): {8: 30, 4: 30, 2: 66, 1: 0},
}

# (name, slots, kv heads, query rows of a kv head, q dtype, int8 cache,
# cluster size): chip_smoke.py's attention rows and the size the sweep
# found fastest or within a few per cent of it (PERF.md §6)
PICKS = [
    ("target_verify", 1, 32, 30, "bfloat16", False, 8),
    ("ar_step", 1, 32, 1, "bfloat16", False, 8),
    ("gqa_groups4", 1, 8, 120, "bfloat16", False, 8),
    ("target_verify_f32", 1, 32, 30, "float32", False, 8),  # 2 waves of 30 clusters
    ("target_verify_int8", 1, 32, 30, "bfloat16", True, 8),
    ("batched_target_verify", 4, 32, 30, "bfloat16", False, 4),
    ("batched_llava_verify_4096", 4, 32, 30, "bfloat16", False, 4),
    ("batched_draft_append", 4, 32, 5, "bfloat16", False, 4),
    ("batched_draft_expand", 4, 32, 8, "bfloat16", False, 4),
    ("batched_gqa_groups4", 4, 8, 120, "bfloat16", False, 8),
    ("batched_target_verify_f32", 4, 32, 30, "float32", False, 8),
    ("mixtral_batched_verify_f32", 4, 8, 120, "float32", False, 8),
    ("batched_target_verify_int8", 4, 32, 30, "bfloat16", True, 8),
    ("batched_step_int8", 4, 32, 1, "bfloat16", True, 4),
    ("batched_getkacc_f32_b16", 16, 32, 1, "float32", False, 1),
    ("tp2_batched_getkacc_f32_b16", 16, 16, 1, "float32", False, 2),
]


def _resident(dtype, int8, gs):
    return H100_RESIDENT[(dtype, int8, min(gs, tva.QTILE))]


@pytest.mark.parametrize("name,nslots,hkv,gs,dtype,int8,want", PICKS,
                         ids=[p[0] for p in PICKS])
def test_cluster_picker_on_the_h100(name, nslots, hkv, gs, dtype, int8, want):
    """The cluster size the host picks from a call's shapes and the card's
    resident clusters, at each attention shape chip_smoke.py runs."""
    assert tva.pick_cluster(nslots, hkv, gs, _resident(dtype, int8, gs)) == want


@pytest.mark.parametrize("hkv,gs,dtype,int8", [(32, 30, "bfloat16", False),
                                               (32, 30, "bfloat16", True),
                                               (32, 30, "float32", False),
                                               (32, 1, "float32", False)])
def test_cluster_picker_keeps_its_size_while_the_grid_allows(hkv, gs, dtype, int8):
    """Slot counts that change only B keep the pick while the grid still
    fits the waves that chose it: the size changes only where a count of
    slots crosses a wave of the size it had, and a larger batch never takes
    a larger cluster."""
    resident = _resident(dtype, int8, gs)
    picks = [tva.pick_cluster(b, hkv, gs, resident) for b in range(1, 33)]
    assert all(a >= b for a, b in zip(picks, picks[1:])), picks
    for b in range(1, 32):
        if picks[b] != picks[b - 1]:  # B = b + 1 leaves the waves of the old size
            old = picks[b - 1]
            assert -(-(b + 1) * hkv // resident[old]) > 2, (b + 1, picks)


# bf16 q over int8 in its register build (p * v_scale packed inside P.V,
# two blocks an SM): the clusters of 8 the H100 holds at once, at every row
# count chip_smoke.py runs (the occupancy query, as its sweep printed it)
H100_REGISTER8 = 30

# (name, slots, kv heads, query rows of a kv head, register build): the
# bf16-over-int8 rows of chip_smoke.py; the register build where one wave
# holds the grid (Qwen2.5-VL's and the GQA requests, the tp 2 shard), the
# P tiles elsewhere
INT8_BUILDS = [
    ("target_verify_int8", 1, 32, 30, False),
    ("ar_step_int8", 1, 32, 1, False),
    ("gqa_groups4_int8", 1, 8, 120, True),
    ("qwen_target_verify_int8", 1, 4, 210, True),
    ("qwen_ar_step_int8", 1, 4, 7, True),
    ("mixtral_ar_step_int8", 1, 8, 4, True),
    ("tp2_target_verify_int8", 1, 16, 30, True),
    ("batched_target_verify_int8", 4, 32, 30, False),
    ("qwen_batched_verify_int8", 4, 4, 210, False),
    ("mixtral_batched_verify_int8", 4, 8, 120, False),
]


@pytest.mark.parametrize("name,nslots,hkv,gs,register", INT8_BUILDS,
                         ids=[b[0] for b in INT8_BUILDS])
def test_int8_build_choice_on_the_h100(name, nslots, hkv, gs, register):
    """bf16 q over int8 takes its register build exactly where one wave of
    its clusters of 8 holds the grid."""
    assert tva.register_build_holds(nslots, hkv, gs, H100_REGISTER8) == register


def test_cluster_picker_needs_no_device():
    """The picker is a function of shapes and the resident table alone: the
    same inputs give the same size on a machine without a card, and no
    size's shared memory that does not fit is ever picked."""
    for (dtype, int8, rows), resident in H100_RESIDENT.items():
        for nslots in (1, 2, 4, 8, 16, 64):
            c = tva.pick_cluster(nslots, 32, rows, resident)
            assert c in tva.CLUSTERS and resident[c] > 0
            assert c == tva.pick_cluster(nslots, 32, rows, dict(resident))


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
