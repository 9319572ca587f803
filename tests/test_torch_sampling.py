"""The port's sampling (ops/sampling.py, ops/rng.py, the sampled tree walk)
against the JAX package on the same numpy inputs, float32 on the CPU.

Warps and probabilities within 1e-6; the acceptance walk and the
categorical draw exact when handed JAX's own uniforms and Gumbel noise;
draws from the port's own key stream held to the distributions the JAX
tests hold (tests/test_tree.py: 4 sigma + 0.01 of the sequential
reference, 0.035 of the target p)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tree import PARENT, TOKENS, manual_tree, np_reference_accept
from tests.torch_parity import CPU, t2n, in_fresh_interpreter_module
from vispec_tpu.ops import sampling as jsamp
from vispec_tpu.ops import tree as jtree
from vispec_tpu_torch.ops import rng
from vispec_tpu_torch.ops import sampling as tsamp
from vispec_tpu_torch.ops import tree as ttree


def _ttree(jt):
    """The port's Tree of a JAX Tree."""
    return ttree.Tree(*(torch.from_numpy(np.array(x)) for x in jt))


def _logits(shape, seed=0, scale=3.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _same_warp(ours, want):
    ours, want = t2n(ours), np.asarray(want)
    np.testing.assert_array_equal(ours > -1e8, want > -1e8)  # identical keep sets
    keep = want > -1e8
    np.testing.assert_allclose(ours[keep], want[keep], rtol=0, atol=1e-6)


@pytest.mark.parametrize("temperature,top_p,top_k,penalty", [
    (0.8, 0.0, 0, 1.0), (1.0, 0.9, 0, 1.0), (0.7, 0.95, 40, 1.0), (1.0, 0.0, 5, 1.0),
    (0.7, 0.9, 0, 1.3), (1.0, 0.0, 500, 1.0),
])
def test_process_logits_matches_jax(temperature, top_p, top_k, penalty):
    logits = _logits((4, 200))
    seen = jsamp.seen_mask(200, np.random.default_rng(3).integers(0, 200, 40))
    want = jsamp.process_logits(jnp.asarray(logits), temperature, top_p, top_k, penalty,
                                jnp.asarray(seen))
    ours = tsamp.process_logits(torch.from_numpy(logits), temperature, top_p, top_k,
                                penalty, torch.from_numpy(seen))
    _same_warp(ours, want)


def test_top_p_tie_order_matches_jax():
    """Tied logits at the nucleus edge: JAX sorts ascending and reverses, so
    of two tied 0.25 tokens the higher index is the one kept."""
    logits = np.log(np.asarray([[0.25, 0.5, 0.25, 1e-9]], np.float32))
    want = np.asarray(jsamp.process_logits(jnp.asarray(logits), 1.0, 0.7, 0))
    ours = t2n(tsamp.process_logits(torch.from_numpy(logits), 1.0, 0.7, 0))
    np.testing.assert_array_equal(ours > -1e8, want > -1e8)
    assert (ours[0] > -1e8).tolist() == [False, True, True, False]


def test_top_k_warp_dyn_matches_jax():
    logits = _logits((3, 64), seed=5)
    for k in (0, 1, 2, 5, 8, 99):
        want = jsamp._top_k_warp_dyn(jnp.asarray(logits), jnp.float32(k), 8)
        ours = tsamp._top_k_warp_dyn(torch.from_numpy(logits), torch.tensor(float(k)), 8)
        np.testing.assert_array_equal(t2n(ours), np.asarray(want), err_msg=str(k))


def test_sample_probs_dyn_matches_jax_per_slot():
    """Four slots of [T, vocab] logits, each with its own knobs (greedy, T=1,
    top-p with a penalty, top-p with a per-request k), against JAX's
    function vmapped over the slots: within 1e-6, the greedy slot's one-hot
    exact, and a slot with no top-p bitwise the static path."""
    logits = _logits((4, 6, 300), seed=7, scale=4.0)
    temp = np.asarray([0.0, 1.0, 0.7, 0.9], np.float32)
    top_p = np.asarray([0.0, 0.0, 0.9, 0.8], np.float32)
    pen = np.asarray([1.0, 1.0, 1.3, 1.0], np.float32)
    k_dyn = np.asarray([0.0, 0.0, 0.0, 3.0], np.float32)
    seen = np.stack([jsamp.seen_mask(300, np.random.default_rng(i).integers(0, 300, 50))
                     for i in range(4)])
    want = jax.vmap(lambda x, t, p, r, s, k: jsamp.sample_probs_dyn(
        x, t, p, r, s, 8, top_k_dyn=k))(*map(jnp.asarray, (logits, temp, top_p, pen, seen,
                                                          k_dyn)))
    ours = tsamp.sample_probs_dyn(*map(torch.from_numpy, (logits, temp, top_p, pen, seen)),
                                  top_k=8, top_k_dyn=torch.from_numpy(k_dyn))
    np.testing.assert_allclose(t2n(ours), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t2n(ours[0]), np.asarray(want[0]))  # one-hot
    no_seen = tsamp.sample_probs_dyn(torch.from_numpy(logits[1]), torch.tensor(1.0),
                                     torch.tensor(0.0), torch.tensor(1.0))
    static = torch.softmax(tsamp.process_logits(torch.from_numpy(logits[1]), 1.0), -1)
    assert torch.equal(no_seen, static)


def test_seen_mask_and_update_seen_match_jax():
    ids = np.asarray([3, 3, 9, 250, -4, 17], np.int64)  # out of range -> trash row
    want = jsamp.seen_mask(200, ids)
    np.testing.assert_array_equal(tsamp.seen_mask(200, ids), want)
    assert not want[200]
    toks = np.asarray([[5, 9, 11, 42], [7, 7, 1, 199]], np.int32)
    valid = np.asarray([[True, True, False, False], [True, False, True, True]])
    seen = np.stack([want, jsamp.seen_mask(200, [0, 1])])
    want2 = jax.vmap(jsamp.update_seen)(jnp.asarray(seen), jnp.asarray(toks),
                                        jnp.asarray(valid))
    ours2 = tsamp.update_seen(torch.from_numpy(seen), torch.from_numpy(toks),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(t2n(ours2), np.asarray(want2))
    assert not ours2[:, :200].equal(torch.from_numpy(seen)[:, :200])


def _walk_case():
    """The six-node tree of tests/test_tree.py (token 9 on a child of the
    root and on a grandchild), random probabilities, and a one-hot copy."""
    jt = manual_tree(TOKENS, PARENT)
    p = np.random.default_rng(3).uniform(0.05, 1.0, (6, 12))
    p[:, 9] *= 4  # token 9's mass decides often
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    onehot = np.eye(12, dtype=np.float32)[np.argmax(p, -1)]
    return jt, p, onehot


@pytest.mark.parametrize("kind", ["probs", "onehot"])
def test_sampling_accept_given_jax_uniforms_matches_jax(kind):
    """200 JAX keys: the port's walk over JAX's own uniforms gives JAX's
    node and length exactly and its residual within 1e-6."""
    jt, p, onehot = _walk_case()
    probs = p if kind == "probs" else onehot
    keys = jax.random.split(jax.random.PRNGKey(11), 200)
    best, acc, resid = jax.vmap(lambda k: jtree.sampling_accept(
        jt, jnp.asarray(probs), k, 3))(keys)
    uni = jax.vmap(lambda k: jax.random.uniform(k, (3, 6)))(keys)
    tt = _ttree(jt)
    n = keys.shape[0]
    batched = ttree.Tree(*(x.expand(n, *x.shape) for x in tt))
    tb, ta, tr = ttree.sampling_accept(
        batched, torch.from_numpy(probs).expand(n, 6, 12), torch.from_numpy(
            np.asarray(uni)), 3)
    np.testing.assert_array_equal(t2n(tb), np.asarray(best))
    np.testing.assert_array_equal(t2n(ta), np.asarray(acc))
    np.testing.assert_allclose(t2n(tr), np.asarray(resid), rtol=0, atol=1e-6)
    assert len(set(np.asarray(best).tolist())) > 1 or kind == "onehot"
    # single request: the same walk without the slot dim
    b1, a1, r1 = ttree.sampling_accept(tt, torch.from_numpy(probs),
                                       torch.from_numpy(np.asarray(uni[0])), 3)
    assert int(b1) == int(best[0]) and int(a1) == int(acc[0])


def test_residual_keeps_a_child_token_mark_set_by_a_non_child():
    """At the root, token 9 sits on child node 2 and on the non-child node
    5: the residual removes token 9's mass whichever node writes last."""
    jt, p, _ = _walk_case()
    tt = _ttree(jt)
    is_child = torch.tensor([False, True, True, False, False, False])
    ours = ttree._residual(torch.from_numpy(p[0]), tt.tokens.to(torch.int64), is_child)
    want = jtree._residual(jnp.asarray(p[0]), jt.tokens, jnp.asarray(is_child.numpy()))
    np.testing.assert_allclose(t2n(ours), np.asarray(want), rtol=0, atol=1e-7)
    assert float(ours[9]) == 0.0 and float(ours[7]) == 0.0


def test_categorical_given_jax_noise_matches_jax():
    p = np.random.default_rng(2).dirichlet(np.full(50, 0.3), 300).astype(np.float32)
    p[:, 7] = 0.0  # zero mass is clamped to 1e-20 on both sides
    keys = jax.random.split(jax.random.PRNGKey(5), 300)
    want = jax.vmap(jsamp.sample_categorical)(keys, jnp.asarray(p))
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (50,)))(keys)
    ours = tsamp.categorical(torch.from_numpy(np.asarray(noise)), torch.from_numpy(p))
    np.testing.assert_array_equal(t2n(ours), np.asarray(want))
    assert ours.dtype == torch.int32 and 7 not in t2n(ours)


def _np_mix(z):
    """splitmix64 in numpy uint64 (an independent statement of the hash)."""
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def test_rng_stream_is_splitmix64_and_uniform():
    """Keys, splits and uniforms are the numpy splitmix64 chain bit for bit;
    the uniforms lie in [0, 1) on a 2^-24 grid with the right moments; the
    Gumbel noise has mean Euler's gamma; a slot-stacked key draws what each
    key draws alone."""
    k = rng.key(7, CPU)
    nk = _np_mix(np.uint64(7))
    assert int(k) == int(nk.astype(np.int64))
    subs = rng.split(k, 3)
    ctr = np.arange(1, 4, dtype=np.uint64)
    np.testing.assert_array_equal([int(s) for s in subs],
                                  _np_mix(nk ^ _np_mix(ctr)).astype(np.int64))
    u = rng.uniform(k, (4, 5000))
    np_bits = _np_mix(nk ^ _np_mix(np.arange(20000, dtype=np.uint64))).reshape(4, 5000)
    np.testing.assert_array_equal(t2n(u), (np_bits >> np.uint64(40)).astype(np.float32)
                                  * np.float32(2.0 ** -24))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01 and abs(float(u.var()) - 1 / 12) < 0.005
    g = rng.gumbel(k, (20000,))
    assert abs(float(g.mean()) - 0.5772) < 0.03 and bool(torch.isfinite(g).all())
    # the extreme 23-bit draws stay inside (0, 1), so the noise stays finite
    ends = rng.open_unit(torch.tensor([0, (1 << 23) - 1]))
    assert 0.0 < float(ends[0]) and float(ends[1]) < 1.0
    assert bool(torch.isfinite(-torch.log(-torch.log(ends))).all())
    ks = rng.keys([7, 8], CPU)
    assert torch.equal(rng.uniform(ks, (3, 6))[1], rng.uniform(rng.key(8, CPU), (3, 6)))
    assert torch.equal(torch.stack(rng.split(ks, 3), -1)[0], torch.stack(subs))


def test_sampling_accept_distribution_matches_sequential_reference():
    """4,000 slots, each with its own key of the port's stream: the
    best-node distribution within 4 sigma + 0.01 of the numpy sequential
    reject-and-renormalise walk (tests/test_tree.py's bound)."""
    jt, p, _ = _walk_case()
    trials = 4000
    tt = _ttree(jt)
    batched = ttree.Tree(*(x.expand(trials, *x.shape) for x in tt))
    keys = rng.keys(range(trials), CPU)
    bests, _, _ = ttree.sampling_accept(batched, torch.from_numpy(p).expand(trials, 6, 12),
                                        rng.uniform(keys, (3, 6)), 3)
    ours = np.bincount(t2n(bests), minlength=6) / trials
    ref = np.zeros(6)
    rs = np.random.default_rng(7)
    for _ in range(trials):
        ref[np_reference_accept(TOKENS, PARENT, np.asarray(jt.depth), p, rs, 3)[0]] += 1
    ref /= trials
    sigma = np.sqrt(np.maximum(ref * (1 - ref) / trials, 1e-9))
    assert np.all(np.abs(ours - ref) < 4 * sigma + 0.01), (ours, ref)


def test_sampled_outcome_reproduces_the_target_distribution():
    """Depth-1 tree (root with children of tokens 0 and 1): the accepted
    child or, on rejection, the bonus drawn from the residual is distributed
    as p (tests/test_tree.py's 0.035 bound), over 3,000 port keys."""
    p = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    tt = _ttree(manual_tree([9, 0, 1], [0, 0, 0]))
    trials = 3000
    batched = ttree.Tree(*(x.expand(trials, *x.shape) for x in tt))
    keys = rng.keys(range(100, 100 + trials), CPU)
    k_acc, k_bonus = rng.split(keys, 2)
    bests, accs, resid = ttree.sampling_accept(
        batched, torch.from_numpy(np.tile(p, (3, 1))).expand(trials, 3, 4),
        rng.uniform(k_acc, (1, 3)), 1)
    bonus = tsamp.sample_categorical(k_bonus, resid)
    toks = np.where(t2n(accs) > 0, np.asarray([9, 0, 1])[t2n(bests)], t2n(bonus))
    np.testing.assert_allclose(np.bincount(toks, minlength=4)[:4] / trials, p, atol=0.035)
    # the categorical draw alone: 3,000 draws from p
    draws = t2n(tsamp.sample_categorical(k_bonus, torch.from_numpy(p).expand(trials, 4)))
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / trials, p, atol=0.035)


# ---------------------------------------------------------------------------
# End to end: SpecModel, batches and the engine at T > 0
# ---------------------------------------------------------------------------

EOS = 999  # outside the vocab: generations run to their budget


@pytest.fixture(scope="module")
def models():
    """(JAX, port) SpecModel pair on the parity weights, float32."""
    from tests.torch_parity import (J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                    T_TCFG, make_models)
    from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
    from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

    jt, jd, tt, td = make_models(seed=1)
    return (JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, max_len=MAX_LEN,
                       dtype=jnp.float32, eos_token_id=EOS),
            TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, td, max_len=MAX_LEN,
                       dtype=torch.float32, eos_token_id=EOS, device=CPU))


PROMPTS = [list(range(50, 70)), list(range(20, 45)), list(range(5, 30)),
           list(range(100, 118))]


def _new(res, prompt, n):
    return res.sequences[len(prompt):len(prompt) + n].tolist()


def test_top_k_1_sampling_equals_greedy_and_jax(models):
    """top_k = 1 one-hots every warped distribution: at T = 0.7 and T = 1
    spec, AR, ``specgenerate_batch`` and the engine all give JAX's greedy
    tokens (and JAX's own sampled graph gives them too)."""
    jmodel, tmodel = models
    n = 20
    want = [_new(jmodel.specgenerate(p, max_new_tokens=n), p, n) for p in PROMPTS[:3]]
    assert _new(jmodel.specgenerate(PROMPTS[0], max_new_tokens=n, temperature=0.7,
                                    top_k=1, seed=3), PROMPTS[0], n) == want[0]
    for p, w in zip(PROMPTS, want):
        assert _new(tmodel.specgenerate(p, max_new_tokens=n, temperature=0.7, top_k=1,
                                        seed=3), p, n) == w
        assert _new(tmodel.ar_generate(p, max_new_tokens=n, temperature=0.7, top_k=1,
                                       seed=3), p, n) == w
    batch = tmodel.specgenerate_batch([{"input_ids": p} for p in PROMPTS[:3]],
                                      temperature=1.0, top_k=1, max_new_tokens=n, seed=9)
    assert [_new(r, p, n) for p, r in zip(PROMPTS, batch)] == want
    eng = tmodel.serving_engine(batch_size=2, max_new_tokens=n, temperature=1.0, top_k=1,
                                chunk_rounds=4, seed=2)
    assert [o.tolist() for o in eng.run_all(PROMPTS[:3])] == want


def test_per_request_engine_matches_jax_engine(models):
    """The per-request engine (top_k = 1, B = 2) over a greedy / T = 1 /
    penalty 1.3 / top-p 0.9 mix equals JAX's engine and the port's single
    runs with each request's own knobs (tests/test_serving.py's case); a
    per-request top_k above the engine's is refused as in JAX."""
    from vispec_tpu.spec.serving import ServingEngine as JServingEngine

    jmodel, tmodel = models
    cfgs = [dict(), dict(temperature=1.0), dict(temperature=1.0, repetition_penalty=1.3),
            dict(temperature=0.7, top_p=0.9)]
    reqs = [dict(input_ids=p, **c) for p, c in zip(PROMPTS, cfgs)]
    kw = dict(batch_size=2, max_new_tokens=16, top_k=1, chunk_rounds=4,
              per_request_sampling=True)
    want = [o.tolist() for o in JServingEngine(jmodel, **kw).run_all(reqs)]
    eng = tmodel.serving_engine(**kw)
    assert [o.tolist() for o in eng.run_all(reqs)] == want
    for p, c, w in zip(PROMPTS, cfgs, want):
        assert _new(tmodel.specgenerate(p, max_new_tokens=16, top_k=1, **c), p, 16) == w
    with pytest.raises(ValueError, match="exceeds the engine's static top_k"):
        eng.submit({"input_ids": PROMPTS[0], "top_k": 4})


def test_same_seed_same_tokens_and_batch_equals_per_request(models):
    """At T = 1 the same seed gives the same tokens and another seed other
    ones; request i of a batch equals ``specgenerate(seed=seed + i)``, and
    the engine's n-th admission equals ``specgenerate(seed=seed + n)``."""
    _, tmodel = models
    n = 16
    runs = [_new(tmodel.specgenerate(PROMPTS[0], temperature=1.0, max_new_tokens=n,
                                     seed=s), PROMPTS[0], n) for s in (4, 4, 5)]
    assert runs[0] == runs[1] != runs[2]
    singles = [_new(tmodel.specgenerate(p, temperature=1.0, top_p=0.9, max_new_tokens=n,
                                        seed=4 + i), p, n) for i, p in enumerate(PROMPTS)]
    batch = tmodel.specgenerate_batch([{"input_ids": p} for p in PROMPTS],
                                      temperature=1.0, top_p=0.9, max_new_tokens=n, seed=4)
    assert [_new(r, p, n) for p, r in zip(PROMPTS, batch)] == singles
    eng = tmodel.serving_engine(batch_size=4, max_new_tokens=n, temperature=1.0,
                                top_p=0.9, chunk_rounds=4, seed=3)
    assert [o.tolist() for o in eng.run_all(PROMPTS)] == singles
    ar = [_new(tmodel.ar_generate(PROMPTS[0], temperature=1.0, max_new_tokens=n, seed=s),
               PROMPTS[0], n) for s in (4, 4)]
    assert ar[0] == ar[1]


def test_repetition_penalty_suppresses_repeats_and_greedy_ignores_it(models):
    """tests/test_spec_model_api.py's property: at T = 0.8 a penalty of 1.8
    repeats the prompt's token no more often than no penalty; AR takes the
    penalty; greedy ignores it."""
    _, tmodel = models
    prompt = [7] * 12
    base = tmodel.specgenerate(prompt, temperature=0.8, seed=3, max_new_tokens=24)
    pen = tmodel.specgenerate(prompt, temperature=0.8, seed=3, max_new_tokens=24,
                              repetition_penalty=1.8)
    base_out, pen_out = base.sequences[12:], pen.sequences[12:]
    assert len(pen_out) > 0 and (pen_out == 7).sum() <= (base_out == 7).sum()
    assert tmodel.ar_generate(prompt, temperature=0.8, seed=3, max_new_tokens=24,
                              repetition_penalty=1.8).new_tokens > 0
    assert (tmodel.specgenerate(prompt, max_new_tokens=10).sequences.tolist()
            == tmodel.specgenerate(prompt, max_new_tokens=10,
                                   repetition_penalty=1.8).sequences.tolist())
    # the penalty mask marks the prompt, and the seen set grows as tokens commit
    from vispec_tpu_torch.spec import loop as tloop

    mask = tmodel._seen_mask(tloop.SamplingParams(0.8, repetition_penalty=1.8), prompt)
    assert mask.shape == (257,) and mask.sum() == 1 and bool(mask[7])
    assert tmodel._seen_mask(tloop.SamplingParams(0.8), prompt) is None


def test_tau_fixture_at_t_above_0_matches_jax_in_distribution():
    """tests/data/tau_fixture.npz with the lm_head sharpened x8 (as
    tests/test_e2e_tau.py): over 16 prompts and seeds, the port's mean tau
    at T = 0.5 and at T = 1 lies within 3 standard errors of JAX's, and
    T = 0.5 accepts more than T = 1; T = 1 with top_k = 1 equals greedy."""
    import os

    from tests.test_e2e_tau import D, T, _fixture_params
    from vispec_tpu.configs import SpecConfig
    from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
    from vispec_tpu_torch import configs as tconfigs
    from vispec_tpu_torch.convert.params import from_numpy, npz_side
    from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

    z = np.load(os.path.join(os.path.dirname(__file__), "data", "tau_fixture.npz"))
    jt, jd = _fixture_params(z, "t"), _fixture_params(z, "d")
    jt = dict(jt, lm_head=jt["lm_head"] * 8.0)
    tt, td = from_numpy(npz_side(z, "t"), CPU), from_numpy(npz_side(z, "d"), CPU)
    tt["lm_head"] = tt["lm_head"] * 8.0
    tcfg = tconfigs.LlamaConfig(**{f: getattr(T, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})
    dcfg = tconfigs.DraftConfig(**{f: getattr(D, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_attention_heads",
        "num_key_value_heads", "max_position_embeddings")})
    jmodel = JSpecModel(T, D, SpecConfig(total_tokens=16, depth=3, top_k=4), jt, jd,
                        max_len=512, dtype=jnp.float32, eos_token_id=999)
    tmodel = TSpecModel(tcfg, dcfg, tconfigs.SpecConfig(total_tokens=16, depth=3, top_k=4),
                        tt, td, max_len=512, dtype=torch.float32, eos_token_id=999,
                        device=CPU)
    prompt = np.random.default_rng(200).integers(1, 90, 16).tolist()
    assert (tmodel.specgenerate(prompt, max_new_tokens=24, temperature=1.0, top_k=1,
                                seed=3).sequences[:40].tolist()
            == tmodel.specgenerate(prompt, max_new_tokens=24).sequences[:40].tolist())

    def taus(model, temperature):
        out = []
        for s in range(16):
            p = np.random.default_rng(200 + s).integers(1, 90, 16).tolist()
            r = model.specgenerate(p, max_new_tokens=32, temperature=temperature, seed=s)
            out.extend(a + 1 for a in r.acceptance_lengths)
        return np.asarray(out, np.float64)

    means = {}
    for temperature in (0.5, 1.0):
        ours, want = taus(tmodel, temperature), taus(jmodel, temperature)
        se = np.sqrt(ours.var(ddof=1) / len(ours) + want.var(ddof=1) / len(want))
        assert abs(ours.mean() - want.mean()) <= 3 * se, (temperature, ours.mean(),
                                                           want.mean(), se)
        means[temperature] = ours.mean()
    assert means[0.5] > means[1.0] >= 1.0, means


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
