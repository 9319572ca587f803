"""The port's batched decoding against the JAX package, float32 on the CPU.

Kernel 1c's plain version against the vmapped Pallas kernel in interpret
mode (2e-4, as tests/test_pallas_attention.py holds the kernel); the
slot-stacked tree ops against ``jax.vmap`` of JAX's (exact, ties included);
the batched target forward against ``jax.vmap`` of JAX's (1e-4: a full
forward in float32, other summation order); batched rounds,
``generate_batch`` and ``specgenerate_batch`` token-exact against JAX and
against the port's own ``specgenerate``; the tau fixture's per-slot
acceptance lengths equal to JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, T_DCFG, T_SPEC, T_TCFG, make_models,
                                t2n, to_numpy_tree, in_fresh_interpreter_module)
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops import pallas_attention
from vispec_tpu.ops import tree as jtree
from vispec_tpu.ops.attention import tree_verify_mask as j_tree_verify_mask
from vispec_tpu.spec import batch as jbatch
from vispec_tpu.spec import loop as jloop
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy, npz_side
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops import tree as ttree
from vispec_tpu_torch.ops import verify_attention as tva
from vispec_tpu_torch.spec import batch as tbatch
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

TOL = dict(rtol=2e-4, atol=2e-4)

# tests/test_batch.py's geometry
GEOMETRY = dict(
    target=dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512),
    draft=dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512),
    spec=dict(total_tokens=12, depth=3, top_k=4),
)
JT, JD, JS = (JLlamaConfig(**GEOMETRY["target"]), JDraftConfig(**GEOMETRY["draft"]),
              JSpecConfig(**GEOMETRY["spec"]))
TT, TD, TS = (tconfigs.LlamaConfig(**GEOMETRY["target"]),
              tconfigs.DraftConfig(**GEOMETRY["draft"]),
              tconfigs.SpecConfig(**GEOMETRY["spec"]))
PROMPTS = [list(range(20, 50)), list(range(60, 85)), list(range(5, 40))]
EOS = 99999
MAX_LEN = 256


def _models(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = jllama.init_params(JT, k1, jnp.float32)
    jd = jdraft.init_params(JD, k2, jnp.float32)
    jd["embed"] = jt["embed"]
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jt, jd, tt, td


@pytest.fixture(scope="module")
def batch_refs():
    """The JAX package's generate_batch on tests/test_batch.py's prompts (B =
    3 and B = 1), built once for the module."""
    jt, jd, tt, td = _models(0)
    kw = dict(max_new_tokens=15, max_len=MAX_LEN, eos_id=EOS, dtype=jnp.float32)
    outs = jbatch.generate_batch(jt, jd, JT, JD, JS, PROMPTS, **kw)
    outs1 = jbatch.generate_batch(jt, jd, JT, JD, JS, PROMPTS[:1], **kw)
    return tt, td, [np.asarray(o) for o in outs], np.asarray(outs1[0])


# ---------------------------------------------------------------------------
# Kernel 1c's plain version
# ---------------------------------------------------------------------------


def test_batched_plain_matches_vmapped_jax_kernel():
    """tests/test_pallas_attention.py::test_vmapped_matches_xla's geometry:
    b = 3, per-slot starts 100 / 37 / 381, GQA 2, d = 128."""
    b, hkv, groups, s, d, max_len = 3, 2, 2, 8, 128, 512
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (b, hkv * groups, s, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, max_len, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, max_len, d)).astype(np.float32)
    tm = np.tril(rng.uniform(size=(b, s, s)) < 0.5)
    tm[:, np.arange(s), np.arange(s)] = True
    tm[:, :, 0] = True
    starts = np.asarray([100, 37, 381], np.int32)

    fn = jax.vmap(lambda qi, ki, vi, st, tmi: pallas_attention.verify_attention(
        qi, ki, vi, st, tmi, block=256))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(starts), jnp.asarray(tm)))
    got = tva.verify_attention_batched(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(starts), torch.from_numpy(tm))
    np.testing.assert_allclose(t2n(got), want, **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_batched_int8_plain_matches_vmapped_jax_kernel(groups):
    """tests/test_pallas_attention.py::test_vmapped_quantized_matches_dequant's
    geometry: a stacked layer dim with per-slot layers 1 / 0 over int8 K/V
    with per-row scales (quantized by JAX, handed over as numpy)."""
    b, n_layers, hkv, s, d, max_len = 2, 2, 2, 4, 128, 256
    rng = np.random.default_rng(2)
    q = jnp.asarray(rng.normal(0, 1, (b, hkv * groups, s, d)), jnp.float32)
    kf = jnp.asarray(rng.normal(0, 1, (b, n_layers, hkv, max_len, d)), jnp.float32)
    vf = jnp.asarray(rng.normal(0, 1, (b, n_layers, hkv, max_len, d)), jnp.float32)
    kq, ks = jax.vmap(jax.vmap(jkv.quantize_rows))(kf)
    vq, vs = jax.vmap(jax.vmap(jkv.quantize_rows))(vf)
    tm = jnp.asarray(np.tril(np.ones((b, s, s), bool)))
    starts = jnp.asarray([64, 130], jnp.int32)
    layers = jnp.asarray([1, 0], jnp.int32)
    fn = jax.vmap(lambda qi, ki, vi, st, tmi, li, ksi, vsi:
                  pallas_attention.verify_attention(qi, ki, vi, st, tmi, block=128,
                                                    layer_idx=li, k_scale=ksi,
                                                    v_scale=vsi))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(q, kq, vq, starts, tm, layers, ks, vs))
    got = tva.verify_attention_batched(
        *(torch.from_numpy(np.asarray(x)) for x in (q, kq, vq, starts, tm, layers, ks, vs)))
    np.testing.assert_allclose(t2n(got), want, **TOL)


def test_batched_wrapper_refuses_a_cache_without_the_slot_dim():
    """The JAX rule asserts per-slot caches (pallas_attention.py:270-273);
    the port raises instead of broadcasting a cache over the slots."""
    q = torch.zeros((2, 4, 3, 16))
    single = torch.zeros((2, 2, 64, 16))  # [L, Hkv, max_len, D]: no slot dim
    mask = torch.ones((2, 3, 3), dtype=torch.bool)
    starts = torch.tensor([5, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="slot dim"):
        tva.verify_attention_batched(q, single, single, starts, mask,
                                     layer_idx=torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="slot dim"):
        tva.verify_attention_batched(q, single[0], single[0], starts, mask)


# ---------------------------------------------------------------------------
# Slot-stacked tree ops and target forward
# ---------------------------------------------------------------------------


def _tree_inputs(rng, b, num_cand, top_k):
    """Flat candidate pools with many tied scores; every candidate scores no
    higher than its parent, so a selected node's parent is selected too."""
    par1 = np.zeros((b, num_cand), np.int32)
    scores = np.zeros((b, num_cand), np.float32)
    for i in range(b):
        for j in range(num_cand):
            par1[i, j] = 0 if j < top_k else rng.integers(1, j - top_k + 2)
            base = 0.0 if par1[i, j] == 0 else scores[i, par1[i, j] - 1]
            scores[i, j] = base - 0.5 * rng.integers(0, 3)
    tokens = rng.integers(0, 6, (b, num_cand)).astype(np.int32)
    sample = rng.integers(0, 6, (b,)).astype(np.int32)
    return sample, tokens, scores, par1


def test_batched_tree_ops_match_vmapped_jax():
    rng = np.random.default_rng(5)
    b, t, depth, k = 3, 12, 3, 4
    sample, tokens, scores, par1 = _tree_inputs(rng, b, k + depth * k * k, k)
    jt = jax.vmap(lambda a, c, d, e: jtree.build_tree(a, c, d, e, t, depth + 1))(
        *(jnp.asarray(x) for x in (sample, tokens, scores, par1)))
    tt = ttree.build_tree(*(torch.from_numpy(x) for x in (sample, tokens, scores, par1)),
                          t, depth + 1)
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(tt, name)), np.asarray(getattr(jt, name)),
                                      err_msg=name)

    argmax = rng.integers(0, 6, (b, t)).astype(np.int32)  # small vocab: many matches
    jbest, jacc = jax.vmap(lambda tr, a: jtree.greedy_accept(tr, a))(jt, jnp.asarray(argmax))
    tbest, tacc = ttree.greedy_accept(tt, torch.from_numpy(argmax))
    np.testing.assert_array_equal(t2n(tbest), np.asarray(jbest))
    np.testing.assert_array_equal(t2n(tacc), np.asarray(jacc))
    assert np.asarray(jacc).max() > 0  # the walk accepted something

    jpath = jax.vmap(lambda tr, n: jtree.path_to_root(tr, n, depth + 2))(jt, jbest)
    np.testing.assert_array_equal(t2n(ttree.path_to_root(tt, tbest, depth + 2)),
                                  np.asarray(jpath))


def test_batched_forward_hidden_matches_vmapped_jax():
    """Three slots at ragged starts 40 / 17 / 90, each verifying its own
    tree over its own cache, under dynamic-NTK rope (a per-slot theta)."""
    b, t, max_len = 3, 12, 256
    cfg = dict(GEOMETRY["target"], num_hidden_layers=3, rope_scaling_type="dynamic",
               rope_scaling_factor=2.0, max_position_embeddings=64)
    jcfg, tcfg = JLlamaConfig(**cfg), tconfigs.LlamaConfig(**cfg)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = from_numpy(to_numpy_tree(jp), CPU)
    rng = np.random.default_rng(6)
    starts = np.asarray([40, 17, 90], np.int32)
    shape = (b, 3, 2, max_len, 16)
    k0 = rng.normal(0, 1, shape).astype(np.float32)
    v0 = rng.normal(0, 1, shape).astype(np.float32)
    tokens = rng.integers(0, 128, (b, t)).astype(np.int32)
    tm = np.tril(rng.uniform(size=(b, t, t)) < 0.4)
    tm[:, np.arange(t), np.arange(t)] = True
    tm[:, :, 0] = True
    depth = (tm.sum(-1) - 1).astype(np.int32)

    def one(tok, cache, st, m, dep):
        emb = jllama.embed(jp, tok)
        mask = j_tree_verify_mask(m, st, max_len)
        return jllama.forward_hidden(jp, jcfg, emb, st + dep, cache, mask,
                                     region=(st, m), return_new_kv=True, seq_len=st + t)

    jcache = jkv.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(starts),
                         real_length=jnp.asarray(starts))
    jh, jc, jnew = jax.vmap(one)(jnp.asarray(tokens), jcache, jnp.asarray(starts),
                                 jnp.asarray(tm), jnp.asarray(depth))
    st = torch.from_numpy(starts)
    tcache = tkv.KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()),
                         length=st, real_length=st.clone())
    th, tc, tnew = tllama.forward_hidden(
        tp, tcfg, tllama.embed(tp, torch.from_numpy(tokens)),
        st[:, None] + torch.from_numpy(depth), tcache, None,
        region=(st, torch.from_numpy(tm)), return_new_kv=True, seq_len=st + t)
    np.testing.assert_allclose(t2n(th), np.asarray(jh), atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(t2n(tnew[i]), np.asarray(jnew[i]), atol=1e-4)
    for i, s0 in enumerate(starts):  # each slot wrote its rows at its own start
        np.testing.assert_allclose(t2n(tc.k[i])[..., :s0 + t, :],
                                   np.asarray(jc.k[i])[..., :s0 + t, :], atol=1e-4)


# ---------------------------------------------------------------------------
# Batched rounds and the generation entry points
# ---------------------------------------------------------------------------


def _assert_same_tree(jtr, ttr):
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(ttr, name)), np.asarray(getattr(jtr, name)),
                                      err_msg=name)


def test_four_batched_rounds_match_jax_batched_decode_round():
    """batched_prefill, then four batched rounds with per-slot caps, against
    the JAX package's batched_prefill and batched_decode_round."""
    jt, jd, tt, td = make_models(seed=4)
    prompts = [list(range(10, 30)), list(range(40, 51)), list(range(3, 40))]
    caps = np.asarray([40, 2, 40], np.int32)  # slot 1 latches done mid-way
    max_out = 40 + 2 * (J_SPEC.depth + 2)
    slack = 40
    jreqs = jbatch.text_requests(jt, J_DCFG, prompts, MAX_LEN, slack)
    jstates = jbatch.batched_prefill(jt, jd, J_TCFG, J_DCFG, J_SPEC, jloop.SamplingParams(),
                                     jreqs, MAX_LEN, max_out, jnp.float32)
    treqs = tbatch.prepare_requests(T_DCFG, prompts, MAX_LEN, slack,
                                    tbatch.text_prompt(tt, CPU), device=CPU)
    tstates = tbatch.batched_prefill(tt, td, T_TCFG, T_DCFG, T_SPEC, tloop.SamplingParams(),
                                     treqs, MAX_LEN, max_out, torch.float32, device=CPU)
    _assert_same_tree(jstates.tree, tstates.tree)
    for _ in range(4):
        jstates = jbatch.batched_decode_round(jt, jd, J_TCFG, J_DCFG, J_SPEC,
                                              jloop.SamplingParams(), jstates,
                                              np.int32(EOS), jnp.asarray(caps))
        tstates, counts = tbatch.batched_decode_rounds_chunk(
            tt, td, T_TCFG, T_DCFG, T_SPEC, tloop.SamplingParams(), tstates, EOS, caps,
            n_rounds=1)
        _assert_same_tree(jstates.tree, tstates.tree)
        np.testing.assert_array_equal(t2n(counts[0]), np.asarray(jstates.new_token))
        for name in ("out_len", "new_token", "done"):
            np.testing.assert_array_equal(t2n(getattr(tstates, name)),
                                          np.asarray(getattr(jstates, name)), err_msg=name)
        for cache in ("target_cache", "draft_cache"):
            for name in ("length", "real_length"):
                np.testing.assert_array_equal(
                    t2n(getattr(getattr(tstates, cache), name)),
                    np.asarray(getattr(getattr(jstates, cache), name)), err_msg=cache)
        np.testing.assert_array_equal(t2n(tstates.output), np.asarray(jstates.output))
    assert bool(np.asarray(jstates.done)[1])
    for i, n in enumerate(np.asarray(jstates.target_cache.length)):
        np.testing.assert_allclose(t2n(tstates.target_cache.k[i])[..., :n, :],
                                   np.asarray(jstates.target_cache.k[i])[..., :n, :],
                                   atol=1e-4)


def test_generate_batch_matches_jax_and_specgenerate(batch_refs):
    tt, td, jouts, _ = batch_refs
    outs = tbatch.generate_batch(tt, td, TT, TD, TS, PROMPTS, max_new_tokens=15,
                                 max_len=MAX_LEN, eos_id=EOS, dtype=torch.float32,
                                 device=CPU)
    model = TSpecModel(TT, TD, TS, tt, td, max_len=MAX_LEN, dtype=torch.float32,
                       eos_token_id=EOS, device=CPU)
    for p, got, want in zip(PROMPTS, outs, jouts):
        assert got.tolist() == want.tolist()
        ref = model.specgenerate(p, max_new_tokens=15)
        n = min(len(got), ref.new_tokens)
        assert n >= 15
        assert got[:n].tolist() == ref.sequences[len(p):len(p) + n].tolist()


def test_batch_of_one_matches_jax_and_specgenerate(batch_refs):
    """B = 1 takes the single-request round, as JAX squeezes its unit batch."""
    tt, td, _, jout1 = batch_refs
    (got,) = tbatch.generate_batch(tt, td, TT, TD, TS, PROMPTS[:1], max_new_tokens=15,
                                   max_len=MAX_LEN, eos_id=EOS, dtype=torch.float32,
                                   device=CPU)
    assert got.tolist() == jout1.tolist()
    model = TSpecModel(TT, TD, TS, tt, td, max_len=MAX_LEN, dtype=torch.float32,
                       eos_token_id=EOS, device=CPU)
    ref = model.specgenerate(PROMPTS[0], max_new_tokens=15)
    assert got[:15].tolist() == ref.sequences[30:45].tolist()


def test_specgenerate_batch_reuses_its_cache_pool(batch_refs):
    """SpecModel.specgenerate_batch equals JAX's batched outputs and the
    port's specgenerate; a second call reuses the pooled stacked caches."""
    tt, td, jouts, _ = batch_refs
    model = TSpecModel(TT, TD, TS, tt, td, max_len=MAX_LEN, dtype=torch.float32,
                       eos_token_id=EOS, device=CPU)
    results = model.specgenerate_batch([{"input_ids": p} for p in PROMPTS],
                                       max_new_tokens=15)
    assert len(model._batch_pool) == 1
    storage = model._batch_pool[0][0].k.data_ptr()
    for p, res, want in zip(PROMPTS, results, jouts):
        assert res.new_tokens == 15
        assert res.sequences[len(p):].tolist() == want[:15].tolist()
        ref = model.specgenerate(p, max_new_tokens=15)
        assert res.sequences.tolist() == ref.sequences[:len(p) + 15].tolist()
        assert res.acceptance_lengths == ref.acceptance_lengths[:len(res.acceptance_lengths)]
    results2 = model.specgenerate_batch([{"input_ids": p} for p in PROMPTS[:2]],
                                        max_new_tokens=8)
    assert len(model._batch_pool) == 1 and model._batch_pool[0][0].k.data_ptr() == storage
    for p, res in zip(PROMPTS, results2):
        assert res.sequences[len(p):].tolist() == results[PROMPTS.index(p)].sequences[
            len(p):len(p) + 8].tolist()
    # sampled: request i draws from the key of seed + i, as specgenerate does
    sampled = model.specgenerate_batch([{"input_ids": p} for p in PROMPTS[:2]],
                                       temperature=0.7, max_new_tokens=8, seed=4)
    for i, (p, res) in enumerate(zip(PROMPTS, sampled)):
        ref = model.specgenerate(p, temperature=0.7, max_new_tokens=8, seed=4 + i)
        assert res.sequences.tolist() == ref.sequences[:len(p) + 8].tolist()
    with pytest.raises(ValueError, match="without a Qwen2.5-VL vision tower"):
        model.specgenerate_batch([{"input_ids": PROMPTS[0],
                                   "pixel_values_videos": np.zeros((2, 4, 4, 3))}])


def test_tau_fixture_batched_acceptance_matches_jax():
    """tests/data/tau_fixture.npz, its six prompts in one batch: the only
    run where slots accept different lengths in the same round.  Per-slot
    acceptance lengths and tokens equal JAX's specgenerate_batch."""
    z = np.load(os.path.join(os.path.dirname(__file__), "data", "tau_fixture.npz"))
    widths = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=512)
    spec = dict(total_tokens=16, depth=3, top_k=4)
    jmodel = JSpecModel(JLlamaConfig(num_hidden_layers=2, **widths), JDraftConfig(**widths),
                        JSpecConfig(**spec),
                        jax.tree.map(jnp.asarray, npz_side(z, "t")),
                        jax.tree.map(jnp.asarray, npz_side(z, "d")),
                        max_len=512, dtype=jnp.float32, eos_token_id=999)
    tmodel = TSpecModel(tconfigs.LlamaConfig(num_hidden_layers=2, **widths),
                        tconfigs.DraftConfig(**widths), tconfigs.SpecConfig(**spec),
                        from_numpy(npz_side(z, "t"), CPU), from_numpy(npz_side(z, "d"), CPU),
                        max_len=512, dtype=torch.float32, eos_token_id=999, device=CPU)
    reqs = [{"input_ids": np.random.default_rng(100 + s).integers(1, 90, 16).tolist()}
            for s in range(6)]
    jres = jmodel.specgenerate_batch(reqs, max_new_tokens=40)
    tres = tmodel.specgenerate_batch(reqs, max_new_tokens=40)
    for j, t in zip(jres, tres):
        assert t.sequences.tolist() == np.asarray(j.sequences).tolist()
        assert t.acceptance_lengths == list(j.acceptance_lengths)
    first = [t.acceptance_lengths for t in tres]
    assert any(len({a[i] for a in first}) > 1 for i in range(min(map(len, first))))


def test_pick_chunk_rounds_matches_jax():
    rng = np.random.default_rng(8)
    cases = [(8, np.zeros(2), np.zeros(2), np.array([24, 24]), np.array([True, True])),
             (8, np.array([16, 0]), np.array([4, 0]), np.array([24, 24]),
              np.array([True, True])),
             (8, np.array([3, 0]), np.array([4, 0]), np.array([4, 24]),
              np.array([False, True])),
             (2, np.zeros(1), np.zeros(1), np.array([24]), np.array([True]))]
    for _ in range(40):
        b = int(rng.integers(1, 5))
        rounds = rng.integers(0, 10, b)
        prev = rounds + rng.integers(0, 3 * rounds + 1)
        cases.append((int(rng.choice([1, 2, 3, 4, 8, 16])), prev, rounds,
                      prev + rng.integers(0, 40, b), rng.uniform(size=b) < 0.7))
    for case in cases:
        assert tbatch.pick_chunk_rounds(*case) == jbatch.pick_chunk_rounds(*case), case


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
