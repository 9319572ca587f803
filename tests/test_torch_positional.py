"""The port's public entry points take positional arguments in the JAX
package's order: ``SpecModel.__init__``, ``specgenerate``, ``ar_generate``,
``specgenerate_batch``, ``ServingEngine.__init__``, ``batch.batched_prefill``
and ``batch.generate_batch``, each called positionally as a caller of the
JAX package calls it and held against the JAX package's own call, on the
tests/torch_parity.py geometry in float32 on the CPU.

Sampled calls use top_k 1 where they are compared with JAX (the draw is
then the argmax, so the two random streams agree), and a sampled call
without top_k is compared with the port's own call by keyword, so that the
seed's place shows.

Each test runs in this module's child pytest process
(``tests.torch_parity.in_fresh_interpreter``), so its JAX compiles stay
out of the process that runs the rest of the suite."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                T_TCFG, in_fresh_interpreter, make_models, t2n)
from vispec_tpu.spec import batch as jbatch
from vispec_tpu.spec import loop as jloop
from vispec_tpu.spec import serving as jserving
from vispec_tpu.spec import spec_model as jspec_model
from vispec_tpu_torch.ops import rng
from vispec_tpu_torch.spec import batch as tbatch
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec import serving as tserving
from vispec_tpu_torch.spec import spec_model as tspec_model

EOS = 999
PROMPTS = [list(range(10, 30)), list(range(40, 51))]


@pytest.fixture(scope="module")
def models():
    jt, jd, tt, td = make_models(seed=3)
    kw = dict(max_len=MAX_LEN, eos_token_id=EOS)
    return (jspec_model.SpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, dtype=jnp.float32, **kw),
            tspec_model.SpecModel(T_TCFG, T_DCFG, T_SPEC, tt, td, dtype=torch.float32,
                                  device=CPU, **kw))


ENTRY_POINTS = {
    "SpecModel": ("spec_model", "SpecModel.__init__"),
    "specgenerate": ("spec_model", "SpecModel.specgenerate"),
    "ar_generate": ("spec_model", "SpecModel.ar_generate"),
    "specgenerate_batch": ("spec_model", "SpecModel.specgenerate_batch"),
    "from_pretrained": ("spec_model", "SpecModel.from_pretrained"),
    "ServingEngine": ("serving", "ServingEngine.__init__"),
    "batched_prefill": ("batch", "batched_prefill"),
    "generate_batch": ("batch", "generate_batch"),
}


def _parameters(package, module, path):
    obj = {"jax": {"spec_model": jspec_model, "serving": jserving, "batch": jbatch},
           "port": {"spec_model": tspec_model, "serving": tserving,
                    "batch": tbatch}}[package][module]
    for name in path.split("."):
        obj = getattr(obj, name)
    return list(inspect.signature(obj).parameters)


@in_fresh_interpreter
@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_signatures_list_jax_parameters_first_in_jax_order(entry):
    jax_names = _parameters("jax", *ENTRY_POINTS[entry])
    port_names = _parameters("port", *ENTRY_POINTS[entry])
    assert port_names[:len(jax_names)] == jax_names


@in_fresh_interpreter
def test_spec_model_positional_construction(models):
    """(tcfg, dcfg, spec, tparams, dparams, max_len, dtype, llava_cfg,
    vparams, eos_token_id), with an EOS the generation meets."""
    jm, tm = models
    full = jm.specgenerate(PROMPTS[0], max_new_tokens=12).sequences
    eos = int(full[len(PROMPTS[0]) + 3])
    jm = jspec_model.SpecModel(J_TCFG, J_DCFG, J_SPEC, jm.tparams, jm.dparams, MAX_LEN,
                               jnp.float32, None, None, eos)
    tm = tspec_model.SpecModel(T_TCFG, T_DCFG, T_SPEC, tm.tparams, tm.dparams, MAX_LEN,
                               torch.float32, None, None, eos, device=CPU)
    assert (tm.max_len, tm.dtype, tm.llava_cfg, tm.vparams, tm.eos_token_id) == \
        (MAX_LEN, torch.float32, None, None, eos)
    got = tm.specgenerate(PROMPTS[0], max_new_tokens=12).sequences
    np.testing.assert_array_equal(got, jm.specgenerate(PROMPTS[0], max_new_tokens=12).sequences)
    assert got[-1] == eos


@in_fresh_interpreter
def test_specgenerate_positional(models):
    """(input_ids, temperature, top_p, top_k, max_new_tokens, pixel_values,
    image_size, pixel_values_videos, second_per_grid_ts, seed, log,
    stop_token_id, repetition_penalty): a stop id met mid-output and the
    penalty at T 0.7 top_k 1."""
    jm, tm = models
    full = jm.specgenerate(PROMPTS[0], max_new_tokens=12).sequences
    stop = int(full[len(PROMPTS[0]) + 4])
    args = (PROMPTS[0], 0.7, 0.0, 1, 12, None, None, None, 1.0, 3, False, stop, 1.3)
    want = jm.specgenerate(*args).sequences
    got = tm.specgenerate(*args).sequences
    np.testing.assert_array_equal(got, want)
    assert got[-1] == stop


@in_fresh_interpreter
def test_ar_generate_positional(models):
    """(input_ids, temperature, top_p, top_k, max_new_tokens, pixel_values,
    image_size, pixel_values_videos, second_per_grid_ts, seed,
    repetition_penalty)."""
    jm, tm = models
    args = (PROMPTS[0], 0.7, 0.0, 1, 10, None, None, None, 1.0, 3, 1.3)
    np.testing.assert_array_equal(tm.ar_generate(*args).sequences,
                                  jm.ar_generate(*args).sequences)
    assert (tm.ar_generate(*args).sequences.tolist()
            != tm.ar_generate(PROMPTS[0], max_new_tokens=10).sequences.tolist())
    sampled = tm.ar_generate(PROMPTS[0], 0.7, 0.0, 0, 10, None, None, None, 1.0, 3, 1.3)
    by_name = tm.ar_generate(PROMPTS[0], temperature=0.7, max_new_tokens=10, seed=3,
                             repetition_penalty=1.3)
    np.testing.assert_array_equal(sampled.sequences, by_name.sequences)


@in_fresh_interpreter
def test_specgenerate_batch_positional(models):
    """(requests, temperature, max_new_tokens, seed, top_p, top_k)."""
    jm, tm = models
    reqs = [{"input_ids": p} for p in PROMPTS]
    want = [r.sequences for r in jm.specgenerate_batch(reqs, 0.7, 8, 3, 0.0, 1)]
    got = [r.sequences for r in tm.specgenerate_batch(reqs, 0.7, 8, 3, 0.0, 1)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    sampled = [r.sequences for r in tm.specgenerate_batch(reqs, 0.7, 8, 3)]
    by_name = [r.sequences for r in tm.specgenerate_batch(reqs, temperature=0.7,
                                                          max_new_tokens=8, seed=3)]
    for a, b in zip(sampled, by_name):
        np.testing.assert_array_equal(a, b)


@in_fresh_interpreter
def test_serving_engine_positional(models):
    """(model, batch_size, max_new_tokens, temperature, top_p, top_k,
    pad_bucket, chunk_rounds, seed)."""
    jm, tm = models
    want = jserving.ServingEngine(jm, 2, 8, 0.7, 0.0, 1, None, 4, 3).run_all(PROMPTS)
    got = tserving.ServingEngine(tm, 2, 8, 0.7, 0.0, 1, None, 4, 3).run_all(PROMPTS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    sampled = tserving.ServingEngine(tm, 2, 8, 0.7, 0.0, 0, None, 4, 3).run_all(PROMPTS)
    by_name = tserving.ServingEngine(tm, batch_size=2, max_new_tokens=8, temperature=0.7,
                                     chunk_rounds=4, seed=3).run_all(PROMPTS)
    for a, b in zip(sampled, by_name):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@in_fresh_interpreter
def test_batched_prefill_positional(models):
    """(tparams, dparams, tcfg, dcfg, spec, sampling, requests, max_len,
    max_out, dtype, seed, cache_pool, mparams, quantize_kv): request i's key
    is seed + i's, and the target caches are int8."""
    jm, tm = models
    sampling = (0.7, 0.0, 1)
    jreqs = jbatch.text_requests(jm.tparams, J_DCFG, PROMPTS, MAX_LEN, 40)
    jstates = jbatch.batched_prefill(jm.tparams, jm.dparams, J_TCFG, J_DCFG, J_SPEC,
                                     jloop.SamplingParams(*sampling), jreqs, MAX_LEN, 20,
                                     jnp.float32, 3, None, None, True)
    treqs = tbatch.prepare_requests(T_DCFG, PROMPTS, MAX_LEN, 40,
                                    tbatch.text_prompt(tm.tparams, CPU), CPU)
    tstates = tbatch.batched_prefill(tm.tparams, tm.dparams, T_TCFG, T_DCFG, T_SPEC,
                                     tloop.SamplingParams(*sampling), treqs, MAX_LEN, 20,
                                     torch.float32, 3, None, None, True, CPU)
    assert tstates.target_cache.k.dtype == torch.int8
    assert jstates.target_cache.k.dtype == jnp.int8
    np.testing.assert_array_equal(t2n(tstates.tree.tokens), np.asarray(jstates.tree.tokens))
    # each slot's key was split once at its prefill from the key of seed + i
    want_keys = torch.stack([rng.split(k, 2)[0] for k in rng.keys([3, 4], CPU).unbind(0)])
    assert torch.equal(tstates.key, want_keys)


@in_fresh_interpreter
def test_generate_batch_positional(models):
    """(tparams, dparams, tcfg, dcfg, spec, prompts, max_new_tokens, max_len,
    eos_id, temperature, top_p, top_k, dtype, seed, chunk_rounds, cache_pool,
    quantize_kv)."""
    jm, tm = models
    args = (PROMPTS, 8, MAX_LEN, EOS, 0.7, 0.0, 1)
    want = jbatch.generate_batch(jm.tparams, jm.dparams, J_TCFG, J_DCFG, J_SPEC, *args,
                                 jnp.float32, 3, 4, None, True)
    got = tbatch.generate_batch(tm.tparams, tm.dparams, T_TCFG, T_DCFG, T_SPEC, *args,
                                torch.float32, 3, 4, None, True, CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:8], np.asarray(w)[:8])
