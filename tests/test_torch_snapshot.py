"""Multi-turn conversation snapshots (``specgenerate(keep_hiddens=True)``,
``continue_from=``) and ``autotune_total_token`` of the port's SpecModel
against the JAX package, on the tests/torch_parity.py geometry in float32
on the CPU (tests/test_conversation_snapshot.py's cases but the tp-mesh and
the eval-harness ones, tests/test_quant_kv.py's int8 snapshot case and
tests/test_spec_model_api.py's autotune case).  A continuation's tokens
must equal the port's full prefill of the whole conversation and the JAX
package's continuation, token for token.

Each test runs in this module's child pytest process
(``tests.torch_parity.in_fresh_interpreter``), so its JAX compiles stay
out of the process that runs the rest of the suite."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, T_DCFG, T_SPEC, T_TCFG,
                                in_fresh_interpreter, make_models, t2n)
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.spec import loop as jloop
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel
from vispec_tpu_torch.spec.spec_model import plan_prompt

MAX_LEN = 512  # the oracle's: the overflow case needs a 300-token prompt
EOS = 999  # outside the vocab: generations run to their budget


def _pair(quantize_kv=False):
    jt, jd, tt, td = make_models(seed=0)
    kw = dict(max_len=MAX_LEN, eos_token_id=EOS, quantize_kv=quantize_kv)
    return (JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, dtype=jnp.float32, **kw),
            TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, td, dtype=torch.float32, device=CPU,
                       **kw))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture
def continuations(monkeypatch):
    """Counts the port's continuation prefills (``loop.spec_prefill_continue``
    called from ``SpecModel``)."""
    from vispec_tpu_torch.spec import spec_model

    calls = []
    real = spec_model.spec_loop.spec_prefill_continue

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(spec_model.spec_loop, "spec_prefill_continue", counted)
    return calls


def _turn(models, prompt, **kw):
    """The same call on both models; returns (JAX, port) sequences."""
    return tuple(np.asarray(m.specgenerate(prompt, **kw).sequences) for m in models)


def _assert_draft_side(tm, jm, snap, jsnap, prompt):
    """What greedy tokens cannot see: the continuation prefill's draft cache
    rows (the boundary row at the cut among them) and first tree equal the
    full prefill's and JAX's continuation's."""
    plen = snap.cut_for(np.asarray(prompt))
    state = tm._prefill_from_snapshot(snap, prompt, plen, tloop.SamplingParams(), None, 64)
    jstate = jm._prefill_from_snapshot(jsnap, prompt, plen, jloop.SamplingParams(), 0, 64)
    np.testing.assert_array_equal(t2n(state.tree.tokens), np.asarray(jstate.tree.tokens))
    np.testing.assert_array_equal(t2n(state.tree.parent), np.asarray(jstate.tree.parent))
    jm.target_cache = jkv.reset(jstate.target_cache)  # JAX's prefill donated them
    jm.draft_cache = jkv.reset(jstate.draft_cache)
    padded = tm._padded_prompt(prompt, 128)
    plan, span = plan_prompt(T_DCFG, padded.shifted, padded.n_spans, len(prompt), 128, CPU)
    whole = tloop.spec_prefill(  # into caches of its own (the model's hold ``state``)
        tm.tparams, tm.dparams, T_TCFG, T_DCFG, T_SPEC, plan, tloop.SamplingParams(),
        padded.embeds, tkv.init_cache(3, 2, MAX_LEN, 16, torch.float32, CPU,
                                      quantized=tm.quantize_kv),
        tkv.init_cache(1, 2, MAX_LEN, 16, torch.float32, CPU), 64, span)
    np.testing.assert_array_equal(t2n(state.tree.tokens), t2n(whole.tree.tokens))
    rows = int(whole.draft_cache.length)
    assert int(state.draft_cache.length) == rows == int(jstate.draft_cache.length)
    for name in ("k", "v"):
        got = t2n(getattr(state.draft_cache, name)[:, :, :rows])
        np.testing.assert_allclose(got, t2n(getattr(whole.draft_cache, name)[:, :, :rows]),
                                   atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(getattr(jstate.draft_cache, name)
                                                   [:, :, :rows]), atol=1e-4)


@in_fresh_interpreter
@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32_cache", "int8_cache"])
def test_continuation_matches_full_prefill_and_jax(quantize_kv, continuations):
    models = _pair(quantize_kv)
    jm, tm = models
    prompt1 = list(range(20, 50))
    j1, t1 = _turn(models, prompt1, max_new_tokens=16, keep_hiddens=True)
    np.testing.assert_array_equal(t1, j1)
    snap, jsnap = tm.last_snapshot, jm.last_snapshot
    assert snap.prompt_len == len(prompt1)
    np.testing.assert_array_equal(snap.seq, t1)
    assert (snap.t_ks is not None) == quantize_kv
    n = len(t1) - len(prompt1)
    np.testing.assert_allclose(t2n(snap.hiddens[:n]), np.asarray(jsnap.hiddens[:n]),
                               atol=1e-4)

    prompt2 = list(t1) + list(range(60, 75))
    full = tm.specgenerate(prompt2, max_new_tokens=16)
    cont = tm.specgenerate(prompt2, max_new_tokens=16, continue_from=snap)
    assert len(continuations) == 1  # the suffix alone was prefilled
    jcont = jm.specgenerate(prompt2, max_new_tokens=16, continue_from=jsnap)
    np.testing.assert_array_equal(cont.sequences, full.sequences)
    np.testing.assert_array_equal(cont.sequences, jcont.sequences)
    assert cont.acceptance_lengths == jcont.acceptance_lengths
    assert len(cont.sequences) - len(prompt2) >= 8

    _assert_draft_side(tm, jm, snap, jsnap, prompt2)


@in_fresh_interpreter
def test_cut_lands_mid_output(pair):
    """A prompt that extends only part of the committed sequence reuses
    exactly the matching prefix."""
    jm, tm = pair
    prompt1 = list(range(30, 60))
    _, t1 = _turn(pair, prompt1, max_new_tokens=16, keep_hiddens=True)
    keep = len(prompt1) + 6
    prompt2 = list(t1[:keep]) + [99, 101, 103]
    assert tm.last_snapshot.cut_for(np.asarray(prompt2)) == keep
    full = tm.specgenerate(prompt2, max_new_tokens=12).sequences
    cont = tm.specgenerate(prompt2, max_new_tokens=12,
                           continue_from=tm.last_snapshot).sequences
    jcont = jm.specgenerate(prompt2, max_new_tokens=12,
                            continue_from=jm.last_snapshot).sequences
    np.testing.assert_array_equal(cont, full)
    np.testing.assert_array_equal(cont, jcont)
    _assert_draft_side(tm, jm, tm.last_snapshot, jm.last_snapshot, prompt2)


@in_fresh_interpreter
def test_cut_rejects_non_extension(pair):
    jm, tm = pair
    prompt1 = list(range(20, 40))
    _turn(pair, prompt1, max_new_tokens=8, keep_hiddens=True)
    snap, jsnap = tm.last_snapshot, jm.last_snapshot
    other = [1, 2, 3] + list(range(23, 40))
    assert snap.cut_for(np.asarray(other)) is None is jsnap.cut_for(np.asarray(other))
    assert snap.cut_for(snap.seq) == len(snap.seq) - 1 == jsnap.cut_for(jsnap.seq)
    res = tm.specgenerate(other, max_new_tokens=8, continue_from=snap).sequences
    ref = tm.specgenerate(other, max_new_tokens=8).sequences
    np.testing.assert_array_equal(res, ref)


@in_fresh_interpreter
def test_continuation_with_repetition_penalty(pair):
    """The penalty's mask is built from the whole conversation and rides
    into the continuation.  T 0.8 with top_k 1 draws the argmax of the
    penalised logits, so the port's tokens can equal JAX's."""
    jm, tm = pair
    kw = dict(max_new_tokens=12, temperature=0.8, top_k=1, repetition_penalty=1.4)
    prompt1 = list(range(20, 50))
    j1, t1 = _turn(pair, prompt1, keep_hiddens=True, seed=5, **kw)
    np.testing.assert_array_equal(t1, j1)
    prompt2 = list(t1) + list(range(60, 72))
    full = tm.specgenerate(prompt2, seed=7, **kw).sequences
    cont = tm.specgenerate(prompt2, seed=7, continue_from=tm.last_snapshot, **kw).sequences
    jcont = jm.specgenerate(prompt2, seed=7, continue_from=jm.last_snapshot, **kw).sequences
    np.testing.assert_array_equal(cont, full)
    np.testing.assert_array_equal(cont, jcont)
    plain = tm.specgenerate(prompt2, max_new_tokens=12).sequences
    assert cont.tolist() != plain.tolist()  # the penalty changed the tokens


@in_fresh_interpreter
def test_overflowing_suffix_falls_back_to_the_full_prefill(pair, continuations):
    """A suffix whose bucket and slack would pass max_len takes the full
    prefill (JAX's guard), with the same tokens."""
    jm, tm = pair
    prompt1 = list(range(20, 20 + 300))
    prompt1 = [t % 256 for t in prompt1]
    _, t1 = _turn(pair, prompt1, max_new_tokens=8, keep_hiddens=True)
    prompt2 = list(t1) + [5] * 170
    full = tm.specgenerate(prompt2, max_new_tokens=4).sequences
    cont = tm.specgenerate(prompt2, max_new_tokens=4, continue_from=tm.last_snapshot).sequences
    assert not continuations
    jcont = jm.specgenerate(prompt2, max_new_tokens=4,
                            continue_from=jm.last_snapshot).sequences
    np.testing.assert_array_equal(cont, full)
    np.testing.assert_array_equal(cont, jcont)


@in_fresh_interpreter
def test_snapshots_chain_across_turns(pair, continuations):
    """Turn 3 continues from turn 2's snapshot, itself a continuation."""
    jm, tm = pair
    p1 = list(range(10, 34))
    _, r1 = _turn(pair, p1, max_new_tokens=10, keep_hiddens=True)
    p2 = list(r1) + list(range(40, 52))
    r2 = tm.specgenerate(p2, max_new_tokens=10, keep_hiddens=True,
                         continue_from=tm.last_snapshot).sequences
    jr2 = jm.specgenerate(p2, max_new_tokens=10, keep_hiddens=True,
                          continue_from=jm.last_snapshot).sequences
    np.testing.assert_array_equal(r2, jr2)
    assert tm.last_snapshot.prompt_len == len(p2)
    p3 = list(r2) + list(range(70, 80))
    full = tm.specgenerate(p3, max_new_tokens=10).sequences
    cont = tm.specgenerate(p3, max_new_tokens=10, continue_from=tm.last_snapshot).sequences
    assert len(continuations) == 2
    jcont = jm.specgenerate(p3, max_new_tokens=10, continue_from=jm.last_snapshot).sequences
    np.testing.assert_array_equal(cont, full)
    np.testing.assert_array_equal(cont, jcont)


@in_fresh_interpreter
def test_no_snapshot_without_keep_hiddens_or_for_medusa(pair):
    """The default run records nothing (its state carries no hiddens); a
    Medusa model takes no snapshot, as in the JAX package."""
    _, tm = pair
    fresh = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tm.tparams, tm.dparams, max_len=MAX_LEN,
                       dtype=torch.float32, eos_token_id=EOS, device=CPU)
    fresh.specgenerate(list(range(20, 40)), max_new_tokens=8)
    assert fresh.last_snapshot is None
    from vispec_tpu_torch.models import medusa
    from vispec_tpu_torch.spec.spec_model import _stub_draft_config, _stub_draft_params

    med = TSpecModel(T_TCFG, _stub_draft_config(T_TCFG), T_SPEC, tm.tparams,
                     _stub_draft_params(tm.tparams, torch.float32), max_len=MAX_LEN,
                     dtype=torch.float32, eos_token_id=EOS,
                     mparams=medusa.init_params(T_TCFG.hidden_size, CPU, torch.float32),
                     device=CPU)
    med.specgenerate(list(range(20, 40)), max_new_tokens=8, keep_hiddens=True)
    assert med.last_snapshot is None


@in_fresh_interpreter
def test_autotune_total_token(pair):
    """tests/test_spec_model_api.py's case: the pick is a candidate and
    lands in ``spec``; a candidate's time is divided by its weight."""
    _, tm = pair
    model = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tm.tparams, tm.dparams, max_len=MAX_LEN,
                       dtype=torch.float32, eos_token_id=EOS, device=CPU)
    best = model.autotune_total_token(cans=(8, 12), weights=(1.0, 1.05), iters=2)
    assert best in (8, 12)
    assert model.spec.total_tokens == best
    times = model.last_autotune_s
    assert best == min(times, key=times.get)
    # a weight large enough decides the pick
    assert model.autotune_total_token(cans=(8, 12), weights=(1.0, 1e6), iters=2) == 12
    assert model.specgenerate(list(range(20, 40)), max_new_tokens=8).new_tokens >= 4
