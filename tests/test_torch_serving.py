"""The port's continuous-batching ServingEngine, float32 on the CPU: the
greedy-text cases of tests/test_serving.py, every output token-exact against
the port's own ``specgenerate`` (held against JAX in
tests/test_torch_spec.py) and, for the continuous-batching and per-request
cap runs, against the JAX package's ServingEngine on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, t2n, to_numpy_tree, in_fresh_interpreter_module
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.spec.serving import ServingEngine as JServingEngine
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel

# tests/test_serving.py's geometry
WIDTHS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
SPEC = dict(total_tokens=12, depth=3, top_k=4)
NO_EOS = 10**6


def _jax_params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jt = jllama.init_params(JLlamaConfig(num_hidden_layers=2, **WIDTHS), k1, jnp.float32)
    jd = jdraft.init_params(JDraftConfig(**WIDTHS), k2, jnp.float32)
    jd["embed"] = jt["embed"]
    return jt, jd


@pytest.fixture(scope="module")
def params():
    jt, jd = _jax_params()
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jt, jd, tt, td


def _model(params, eos=NO_EOS, **kw):
    _, _, tt, td = params
    return SpecModel(tconfigs.LlamaConfig(num_hidden_layers=2, **WIDTHS),
                     tconfigs.DraftConfig(**WIDTHS), tconfigs.SpecConfig(**SPEC),
                     tt, dict(td), max_len=512, dtype=torch.float32, eos_token_id=eos,
                     device=CPU, **kw)


def _single(model, prompt, n):
    """specgenerate's first n new tokens (its last round may overshoot n)."""
    out = model.specgenerate(prompt, max_new_tokens=n).sequences[len(prompt):]
    return out[:n].tolist()


def _prompts(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(5, 120, rng.integers(lo, hi)).tolist() for _ in range(n)]


CONT_PROMPTS = _prompts(3, 5, 8, 40)
CAPPED = [dict(input_ids=p, max_new_tokens=c)
          for p, c in zip(_prompts(11, 4, 8, 30), (6, 24, 13, 24))]


@pytest.fixture(scope="module")
def jax_engine_outputs(params):
    """The JAX package's engine on the same weights, once per module: the
    continuous-batching run and the per-request-cap run."""
    jt, jd, _, _ = params
    jmodel = JSpecModel(JLlamaConfig(num_hidden_layers=2, **WIDTHS), JDraftConfig(**WIDTHS),
                        JSpecConfig(**SPEC), jt, jd, max_len=512, dtype=jnp.float32,
                        eos_token_id=NO_EOS)
    eng = JServingEngine(jmodel, batch_size=2, max_new_tokens=24, chunk_rounds=4)
    cont = [np.asarray(o).tolist() for o in eng.run_all(CONT_PROMPTS)]
    capped = [np.asarray(o).tolist() for o in eng.run_all(CAPPED)]
    return cont, capped


def test_continuous_batching_matches_jax_engine_and_single(params, jax_engine_outputs):
    model = _model(params)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=24, chunk_rounds=4)
    outs = eng.run_all(CONT_PROMPTS)
    assert eng._n_prefills == 5  # more requests than slots: admissions happened
    assert eng.stats["admissions"] >= 3 and eng.stats["rounds"] > 0
    for p, o, j in zip(CONT_PROMPTS, outs, jax_engine_outputs[0]):
        assert o.tolist() == j
        assert o.tolist() == _single(model, p, 24)[:len(o)] and len(o) == 24


def test_per_request_max_new_tokens(params, jax_engine_outputs):
    """submit(max_new_tokens=...) caps that request only, through both
    surfaces (kwarg and dict key)."""
    model = _model(params)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=24, chunk_rounds=2)
    eng.start_session()
    rids = [eng.submit(r["input_ids"], max_new_tokens=r["max_new_tokens"]) if i % 2 == 0
            else eng.submit(r) for i, r in enumerate(CAPPED)]
    while eng.pending():
        eng.step()
    for r, rid, j in zip(CAPPED, rids, jax_engine_outputs[1]):
        o = eng.results[rid].tolist()
        assert len(o) == r["max_new_tokens"] and o == j
        assert o == _single(model, r["input_ids"], 24)[:len(o)]
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(CAPPED[0]["input_ids"], max_new_tokens=0)


def test_online_submit_mid_flight(params):
    model = _model(params)
    prompts = _prompts(7, 5, 8, 30)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=16, chunk_rounds=2)
    rids = [eng.submit(p) for p in prompts[:2]]
    for _ in range(2):
        eng.step()
    assert eng.pending()
    rids += [eng.submit(p) for p in prompts[2:]]  # arrive mid-flight
    while eng.pending():
        eng.step()
    assert sorted(eng.results) == sorted(rids)
    for p, rid in zip(prompts, rids):
        assert eng.results[rid].tolist() == _single(model, p, 16)
    assert eng.stats["admissions"] >= 3


def test_cancel_queued_and_active(params):
    """A queued cancel drops the request (empty result, reported through
    step()'s return); an active cancel is deferred to the next step and
    returns the tokens generated so far; other slots are untouched."""
    model = _model(params)
    prompts = _prompts(13, 4, 8, 30)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=32, chunk_rounds=2)
    eng.start_session()
    rids = [eng.submit(p) for p in prompts]
    assert eng.cancel(rids[3])
    assert not eng.cancel(rids[3])  # idempotent
    assert len(eng._queue) == 4  # deferred: the queue is not touched here
    finished = eng.step()  # drops rids[3], admits rids[0] and rids[1]
    assert rids[3] in finished
    assert eng.cancel(rids[0])
    assert eng._cancel_req == [rids[0]]  # applied by the next step
    while eng.pending():
        finished += eng.step()
    assert sorted(finished) == sorted(rids)
    assert len(eng.results[rids[3]]) == 0 and eng.was_canceled(rids[3])
    out0 = eng.results[rids[0]].tolist()
    assert 0 < len(out0) < 32 and out0 == _single(model, prompts[0], 32)[:len(out0)]
    for i in (1, 2):
        assert eng.results[rids[i]].tolist() == _single(model, prompts[i], 32)
    assert not eng.cancel(rids[1]) and not eng.cancel(99)
    eng.pop_result(rids[0])
    assert not eng.was_canceled(rids[0]) and rids[0] not in eng.results


def test_malformed_request_fails_per_request(params):
    model = _model(params)
    good = _prompts(19, 1, 12, 13)[0]
    eng = ServingEngine(model, batch_size=2, max_new_tokens=8, chunk_rounds=2)
    eng.start_session()
    r_bad = eng.submit({"not_input_ids": [1, 2, 3]})
    r_typ = eng.submit({"input_ids": object()})
    r_ok = eng.submit(good)
    while eng.pending():
        eng.step()
    assert len(eng.results[r_bad]) == 0 and r_bad in eng.errors
    assert len(eng.results[r_typ]) == 0 and r_typ in eng.errors
    assert eng.results[r_ok].tolist() == _single(model, good, 8)
    with pytest.raises(KeyError, match="unknown, unfinished"):
        eng.pop_result(12345)
    eng.pop_result(r_ok)
    with pytest.raises(KeyError, match="already popped"):
        eng.pop_result(r_ok)


def test_multi_bucket_admission(params):
    """Each admission pads to the smallest bucket that fits; an over-long
    prompt fails as a per-request error while a healthy one decodes."""
    model = _model(params)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(5, 120, n).tolist() for n in (20, 150, 40, 200)]
    eng = ServingEngine(model, batch_size=2, max_new_tokens=12, pad_bucket=(128, 256),
                        chunk_rounds=4)
    outs = eng.run_all(prompts)
    for p, o in zip(prompts, outs):
        assert o.tolist() == _single(model, p, 12)
    outs2 = eng.run_all([list(range(300)), prompts[0]])
    assert len(outs2[0]) == 0
    (err,) = eng.errors.values()
    assert "largest pad bucket" in err
    assert outs2[1].tolist() == _single(model, prompts[0], 12)
    with pytest.raises(ValueError, match="128-multiples"):
        ServingEngine(model, batch_size=2, pad_bucket=(100,))


def test_fewer_requests_than_slots_and_empty_engine(params):
    model = _model(params)
    prompts = [list(range(10, 22)), list(range(30, 45))]
    eng = ServingEngine(model, batch_size=4, max_new_tokens=12)
    outs = eng.run_all(prompts)
    for p, o in zip(prompts, outs):
        assert o.tolist() == _single(model, p, 12)
    assert ServingEngine(model, batch_size=2).run_all([]) == []


@pytest.mark.parametrize("quant", [dict(quantize_draft=True), dict(quantize_kv=True)])
def test_engine_with_int8_draft_or_int8_kv(params, quant):
    """The quantized modes through the engine: an int8 draft leaves the
    output equal to the target's own (AR), an int8 KV cache equals the
    quantized model's own specgenerate."""
    model = _model(params, **quant)
    prompts = _prompts(11, 3, 12, 13)
    outs = model.serving_engine(batch_size=2, max_new_tokens=16,
                                chunk_rounds=4).run_all(prompts)
    for p, o in zip(prompts, outs):
        if "quantize_draft" in quant:
            ref = _model(params).ar_generate(p, max_new_tokens=16).sequences[len(p):]
            assert o.tolist() == ref.tolist()[:16]
        assert o.tolist() == _single(model, p, 16)


def test_engine_prefix_caching(params):
    """A shared prefix prefilled once; admissions continue from the snapshot
    and equal a full-prompt specgenerate; a request without the prefix takes
    the full prefill."""
    model = _model(params)
    rng = np.random.default_rng(5)
    prefix = rng.integers(5, 120, 24).tolist()
    prompts = [prefix + rng.integers(5, 120, rng.integers(6, 30)).tolist()
               for _ in range(4)]
    eng = ServingEngine(model, batch_size=2, max_new_tokens=16, chunk_rounds=4,
                        pad_bucket=128, prefix_ids=prefix, suffix_bucket=64)
    outs = eng.run_all(prompts)
    assert eng._n_prefills == 4
    for p, o in zip(prompts, outs):
        assert o.tolist() == _single(model, p, 16)
    other = rng.integers(5, 120, 20).tolist()
    assert eng.run_all([other])[0].tolist() == _single(model, other, 16)
    with pytest.raises(ValueError, match="admission cache"):
        ServingEngine(model, batch_size=2, max_new_tokens=8,
                      prefix_ids=list(range(5, 50)) * 7 + [5] * 42)


def test_engine_streaming_callback(params):
    model = _model(params)
    prompts = _prompts(13, 3, 14, 15)
    streamed = {i: [] for i in range(3)}

    def on_tokens(rid, toks):
        assert len(toks) > 0
        streamed[rid].extend(int(t) for t in toks)

    eng = ServingEngine(model, batch_size=2, max_new_tokens=16, chunk_rounds=2)
    outs = eng.run_all(prompts, on_tokens=on_tokens)
    for i, o in enumerate(outs):
        assert streamed[i] == o.tolist() == _single(model, prompts[i], 16)


def test_chunk_ladder_trims_dead_rounds(params):
    """A slot expected to finish in r rounds gets a chunk <= r; a queued
    request caps the chunk at 2 only once EOS finishes are live."""
    model = _model(params)
    p0 = _prompts(31, 1, 14, 15)[0]
    single = _single(model, p0, 24)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=24, chunk_rounds=8)
    eng.start_session()
    rid = eng.submit(p0, max_new_tokens=4)
    while eng.pending():
        eng.step()
    assert eng._guard <= 5 and eng.results[rid].tolist() == single[:4]

    p1 = list(range(30, 40))
    eng2 = ServingEngine(model, batch_size=1, max_new_tokens=24, chunk_rounds=8)
    eng2.start_session()
    r0, r1 = eng2.submit(p0), eng2.submit(p1)
    eng2.step()  # no EOS seen: a full chunk although r1 waits
    assert eng2._guard == 8
    while eng2.pending():
        eng2.step()
    assert eng2.results[r0].tolist() == single
    assert eng2.results[r1].tolist() == _single(model, p1, 24)

    eng3 = ServingEngine(model, batch_size=1, max_new_tokens=24, chunk_rounds=8)
    eng3.start_session()
    eng3.submit(p0)
    eng3.submit(p1)
    eng3._eos_ewma = 0.1  # one EOS finish ago
    eng3.step()
    assert eng3._guard <= 2

    tok = single[5]  # a real EOS-before-budget finish arms the EWMA
    eng4 = ServingEngine(_model(params, eos=tok), batch_size=1, max_new_tokens=24,
                         chunk_rounds=8)
    eng4.start_session()
    r = eng4.submit(p0)
    while eng4.pending():
        eng4.step()
    assert eng4._eos_ewma > 0.02
    assert eng4.results[r].tolist() == single[:single.index(tok) + 1]


def test_unported_options_raise_not_implemented(params):
    model = _model(params)
    eng = ServingEngine(model, batch_size=2)
    # a video request needs a Qwen2.5-VL model
    with pytest.raises(ValueError, match="video requests need a Qwen2.5-VL model"):
        eng.submit({"input_ids": [1, 2, 3], "pixel_values_videos": np.zeros((2, 4, 4, 3))})
    # JAX's error for sampling keys on an engine without per-request sampling
    with pytest.raises(ValueError, match=r"need ServingEngine\(per_request_sampling=True\)"):
        eng.submit({"input_ids": [1, 2, 3], "temperature": 1.0})
    assert not eng.pending()


def test_admitted_slot_rows_land_in_place(params):
    """admit() writes the small admission caches into the slot's first rows
    of the full-length stacked buffers; the other slot's rows stay."""
    model = _model(params)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=8, chunk_rounds=2)
    eng.start_session()
    eng.submit(list(range(10, 30)))
    eng.step()
    k = eng._states.target_cache.k
    assert k.shape[:2] == (2, 2) and k.shape[-2] == 512  # [B, L, Hkv, max_len, D]
    other = t2n(k[1]).copy()
    eng.submit(list(range(40, 60)))
    eng.step()
    n = int(eng._states.target_cache.length[1])
    assert n >= 20 and np.abs(t2n(k[1])[..., :20, :] - other[..., :20, :]).max() > 0


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
