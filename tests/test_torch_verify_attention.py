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


# The clusters of each (cluster size, walkers) shape the H100 80GB HBM3
# holds at once, by (q dtype, int8 cache (bf16 q: the P-tile build), query
# rows of a kv head up to 64), from the occupancy query
# (``resident_clusters``) as chip_smoke.py --attention-sweep printed it: a
# shape whose tiles and extra slots of shared memory cost blocks an SM holds
# fewer; two walkers over a bf16 cache fit three blocks an SM.  The walker
# shape exists for bf16 q over a bf16 cache only.
_SMALL = {(8, 1): 45, (4, 1): 92, (2, 1): 198, (1, 1): 396}
_BF16_SMALL = {**_SMALL, (4, 2): 92}
H100_RESIDENT = {
    ("bfloat16", False, 1): _BF16_SMALL,
    ("bfloat16", False, 5): _BF16_SMALL,
    ("bfloat16", False, 8): {**_BF16_SMALL, (1, 1): 264},
    ("bfloat16", False, 30): {**_BF16_SMALL, (2, 1): 132, (1, 1): 132},
    ("bfloat16", False, 64): {**_BF16_SMALL, (4, 1): 62, (2, 1): 66, (1, 1): 0},
    ("bfloat16", True, 1): _SMALL,
    ("bfloat16", True, 4): {**_SMALL, (1, 1): 264},
    ("bfloat16", True, 7): {**_SMALL, (2, 1): 132, (1, 1): 264},
    ("bfloat16", True, 30): {(8, 1): 45, (4, 1): 62, (2, 1): 66, (1, 1): 132},
    ("bfloat16", True, 64): {(8, 1): 45, (4, 1): 62, (2, 1): 66, (1, 1): 0},
    ("float32", False, 1): {(8, 1): 30, (4, 1): 62, (2, 1): 132, (1, 1): 264},
    ("float32", False, 30): {(8, 1): 30, (4, 1): 30, (2, 1): 66, (1, 1): 132},
    ("float32", False, 64): {(8, 1): 30, (4, 1): 30, (2, 1): 66, (1, 1): 0},
}

# bf16 q over int8 in its register build (p * v_scale packed inside P.V,
# two blocks an SM): the clusters of 8 the H100 holds at once, at every row
# count chip_smoke.py runs (the occupancy query, as its sweep printed it)
H100_REGISTER8 = 30

# (name, slots, kv heads, query rows of a kv head, q dtype, int8 cache,
# (cluster size, walkers, P tiles)): chip_smoke.py's attention rows and the
# shape the host picks.  Each entry with a row in chip_smoke.py
# --attention-sweep (PERF.md §6) is the fastest shape there or
# within 3% of it, but for batched_llava_verify_4096 (a cluster of 2 is 7%
# faster on LLaVA's short slots, which the host cannot tell from the 7B
# verify's longer ones); batched_step_bf16, tp2_batched_target_verify and
# tp2_batched_getkacc_f32_b16 have no sweep row and pin the rule: one
# request at (8, 1) (over int8 the register build where one wave
# of it holds the grid); the B = 4 bf16 rounds at (4, 2), three blocks an
# SM, every rank of a block at once; the B = 4 verify over int8 at (8, 1)
# and its step at (4, 1) (no walkers over int8); float32 q and more than 32 query rows a kv head (GQA, Qwen) with one
# walker; getkacc's 16 one-row slots at (1, 1), its tp 2 shard at (2, 1)
PICKS = [
    ("target_verify", 1, 32, 30, "bfloat16", False, (8, 1, False)),
    ("ar_step", 1, 32, 1, "bfloat16", False, (8, 1, False)),
    ("draft_append", 1, 32, 5, "bfloat16", False, (8, 1, False)),
    ("draft_expand", 1, 32, 8, "bfloat16", False, (8, 1, False)),
    ("gqa_groups4", 1, 8, 120, "bfloat16", False, (8, 1, False)),
    ("qwen_target_verify", 1, 4, 210, "bfloat16", False, (8, 1, False)),
    ("target_verify_f32", 1, 32, 30, "float32", False, (8, 1, False)),  # 2 waves of 30
    ("target_verify_int8", 1, 32, 30, "bfloat16", True, (8, 1, True)),
    ("ar_step_int8", 1, 32, 1, "bfloat16", True, (8, 1, True)),
    ("gqa_groups4_int8", 1, 8, 120, "bfloat16", True, (8, 1, False)),
    ("qwen_ar_step_int8", 1, 4, 7, "bfloat16", True, (8, 1, False)),
    ("batched_target_verify", 4, 32, 30, "bfloat16", False, (4, 2, False)),
    ("batched_llava_verify_4096", 4, 32, 30, "bfloat16", False, (4, 2, False)),
    ("batched_draft_append", 4, 32, 5, "bfloat16", False, (4, 2, False)),
    ("batched_draft_expand", 4, 32, 8, "bfloat16", False, (4, 2, False)),
    ("batched_step_bf16", 4, 32, 1, "bfloat16", False, (4, 2, False)),
    ("batched_gqa_groups4", 4, 8, 120, "bfloat16", False, (8, 1, False)),
    ("qwen_batched_verify", 4, 4, 210, "bfloat16", False, (8, 1, False)),
    ("mixtral_batched_draft_append", 4, 8, 5, "bfloat16", False, (8, 1, False)),
    ("tp2_batched_target_verify", 4, 16, 30, "bfloat16", False, (8, 1, False)),
    ("batched_target_verify_f32", 4, 32, 30, "float32", False, (8, 1, False)),
    ("mixtral_batched_verify_f32", 4, 8, 120, "float32", False, (8, 1, False)),
    ("batched_target_verify_int8", 4, 32, 30, "bfloat16", True, (8, 1, True)),
    ("batched_step_int8", 4, 32, 1, "bfloat16", True, (4, 1, True)),
    ("qwen_batched_verify_int8", 4, 4, 210, "bfloat16", True, (8, 1, True)),
    ("mixtral_batched_verify_int8", 4, 8, 120, "bfloat16", True, (8, 1, True)),
    ("batched_getkacc_f32_b16", 16, 32, 1, "float32", False, (1, 1, False)),
    ("tp2_batched_getkacc_f32_b16", 16, 16, 1, "float32", False, (2, 1, False)),
]


def _resident(dtype, int8, gs):
    return H100_RESIDENT[(dtype, int8, min(gs, tva.QTILE))]


def _pick(nslots, hkv, gs, dtype, int8):
    return tva.pick_shape(nslots, hkv, gs, _resident(dtype, int8, gs),
                          H100_REGISTER8 if dtype == "bfloat16" and int8 else None)


@pytest.mark.parametrize("name,nslots,hkv,gs,dtype,int8,want", PICKS,
                         ids=[p[0] for p in PICKS])
def test_cluster_picker_on_the_h100(name, nslots, hkv, gs, dtype, int8, want):
    """The (cluster size, walkers, build) the host picks from a call's
    shapes and the card's resident clusters, at each attention shape
    chip_smoke.py runs; two walkers only where 32 rows hold a kv head's query
    rows and the q is bf16."""
    got = _pick(nslots, hkv, gs, dtype, int8)
    assert got == want
    if gs > tva.QTILE // 2 or dtype == "float32":
        assert got[1] == 1


@pytest.mark.parametrize("hkv,gs,dtype,int8", [(32, 30, "bfloat16", False),
                                               (32, 5, "bfloat16", False),
                                               (32, 30, "bfloat16", True),
                                               (32, 1, "bfloat16", True),
                                               (32, 30, "float32", False),
                                               (32, 1, "float32", False)])
def test_cluster_picker_keeps_its_size_while_the_grid_allows(hkv, gs, dtype, int8):
    """Slot counts that change only B keep the pick while the grid still
    fits the waves that chose it: the shape changes only where a count of
    slots takes the old shape past two waves, and a larger batch never takes
    a shorter chain of virtual ranks a block (ceil(8 / C / W))."""
    resident = _resident(dtype, int8, gs)
    picks = [tva.pick_cluster(b, hkv, gs, resident) for b in range(1, 33)]
    chain = [-(-tva.VRANKS // c // w) for c, w in picks]
    assert all(a <= b for a, b in zip(chain, chain[1:])), picks
    for b in range(1, 32):
        if picks[b] != picks[b - 1]:  # B = b + 1 leaves the waves of the old shape
            assert -(-(b + 1) * hkv // resident[picks[b - 1]]) > 2, (b + 1, picks)


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
    same inputs give the same shape on a machine without a card; no shape
    whose shared memory does not fit is ever picked, and two walkers only
    where a walker's 32 rows hold the kv head's query rows."""
    for (dtype, int8, rows), resident in H100_RESIDENT.items():
        for nslots in (1, 2, 4, 8, 16, 64):
            c, w, pt = _pick(nslots, 32, rows, dtype, int8)
            built = tva.shapes_built(getattr(torch, dtype), int8, pt)
            assert (c, w) in built and (not pt or resident[(c, w)] > 0)
            assert w == 1 or rows <= tva.QTILE // w
            assert (c, w, pt) == _pick(nslots, 32, rows, dtype, int8)


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
