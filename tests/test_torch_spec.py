"""The port's greedy decode loop and SpecModel against the JAX package, on
the tests/test_spec_loop.py geometry in float32 on the CPU.

Token ids, tree structure and lengths must match exactly; the target cache
rows to 1e-4 abs (a full forward in float32, other summation order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                T_TCFG, make_models, t2n)
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.spec import loop as jloop
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy, npz_side
from vispec_tpu_torch.models import draft as tdraft
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

PAD = 64
EOS = 999  # outside the vocab: generations run to their budget


def _assert_same_tree(jtree, ttree):
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(ttree, name)),
                                      np.asarray(getattr(jtree, name)), err_msg=name)


def test_prefill_and_four_rounds_match_jax():
    jt, jd, tt, td = make_models(seed=0)
    prompt = list(range(10, 30))
    max_new, max_out = 40, 40 + 2 * (J_SPEC.depth + 2)

    jplan, jspan = jdraft.make_prefill_plan(None, len(prompt), J_DCFG.num_q, PAD,
                                            max_images=2, max_span=8)
    jemb = jnp.pad(jllama.embed(jt, jnp.asarray(prompt, jnp.int32)),
                   ((0, PAD - len(prompt)), (0, 0)))
    jstate = jloop.spec_prefill(
        jt, jd, J_TCFG, J_DCFG, J_SPEC, jplan, jloop.SamplingParams(), jemb,
        jkv.init_cache(3, 2, MAX_LEN, 16, jnp.float32),
        jkv.init_cache(1, 2, MAX_LEN, 16, jnp.float32),
        jax.random.PRNGKey(0), max_out, jspan)

    tplan, tspan = tdraft.make_prefill_plan(None, len(prompt), T_DCFG.num_q, PAD,
                                            max_images=2, max_span=8, device=CPU)
    temb = tllama.embed(tt, torch.tensor(prompt))
    temb = torch.cat([temb, temb.new_zeros(PAD - len(prompt), temb.shape[1])])
    tstate = tloop.spec_prefill(
        tt, td, T_TCFG, T_DCFG, T_SPEC, tplan, tloop.SamplingParams(), temb,
        tkv.init_cache(3, 2, MAX_LEN, 16, torch.float32, CPU),
        tkv.init_cache(1, 2, MAX_LEN, 16, torch.float32, CPU), max_out, tspan)
    _assert_same_tree(jstate.tree, tstate.tree)

    for _ in range(4):
        jstate = jloop.decode_round(jt, jd, J_TCFG, J_DCFG, J_SPEC,
                                    jloop.SamplingParams(), jstate, np.int32(EOS),
                                    np.int32(max_new))
        tstate = tloop.decode_round(tt, td, T_TCFG, T_DCFG, T_SPEC,
                                    tloop.SamplingParams(), tstate, EOS, max_new)
        _assert_same_tree(jstate.tree, tstate.tree)
        for name in ("out_len", "new_token", "done"):
            assert t2n(getattr(tstate, name)) == np.asarray(getattr(jstate, name)), name
        for cache in ("target_cache", "draft_cache"):
            for name in ("length", "real_length"):
                assert (t2n(getattr(getattr(tstate, cache), name))
                        == np.asarray(getattr(getattr(jstate, cache), name))), (cache, name)
        n = int(jstate.out_len)
        np.testing.assert_array_equal(t2n(tstate.output)[:n], np.asarray(jstate.output)[:n])
    n = int(jstate.target_cache.length)
    np.testing.assert_allclose(t2n(tstate.target_cache.k)[:, :, :n],
                               np.asarray(jstate.target_cache.k)[:, :, :n], atol=1e-4)


def test_specgenerate_equals_ar_and_jax():
    jt, jd, tt, td = make_models(seed=1)
    prompt = list(range(50, 70))
    jmodel = JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, max_len=MAX_LEN,
                        dtype=jnp.float32, eos_token_id=EOS)
    tmodel = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, td, max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU)
    jres = jmodel.specgenerate(prompt, max_new_tokens=40)
    tres = tmodel.specgenerate(prompt, max_new_tokens=40)
    ares = tmodel.ar_generate(prompt, max_new_tokens=40)
    assert tres.new_tokens == jres.new_tokens >= 40
    assert tres.sequences.tolist() == jres.sequences.tolist()
    assert tres.acceptance_lengths == jres.acceptance_lengths
    assert tres.sequences[:len(prompt) + 40].tolist() == ares.sequences.tolist()


def test_non_greedy_sampling_is_refused():
    _, _, tt, td = make_models(seed=2)
    tmodel = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, td, max_len=MAX_LEN,
                        dtype=torch.float32, device=CPU)
    with pytest.raises(NotImplementedError):
        tmodel.specgenerate([1, 2, 3], temperature=0.7, max_new_tokens=4)


def test_tau_fixture():
    """tests/test_e2e_tau.py's stored trained toy checkpoint through the port:
    spec == AR on each of its six prompts, and tau >= recorded - 0.15."""
    path = os.path.join(os.path.dirname(__file__), "data", "tau_fixture.npz")
    z = np.load(path)
    tcfg = tconfigs.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=512)
    dcfg = tconfigs.DraftConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                num_attention_heads=4, num_key_value_heads=2,
                                max_position_embeddings=512)
    model = TSpecModel(tcfg, dcfg, tconfigs.SpecConfig(total_tokens=16, depth=3, top_k=4),
                       from_numpy(npz_side(z, "t"), CPU),
                       from_numpy(npz_side(z, "d"), CPU),
                       max_len=512, dtype=torch.float32, eos_token_id=999, device=CPU)
    taus = []
    for s in range(6):
        prompt = np.random.default_rng(100 + s).integers(1, 90, 16).tolist()
        r = model.specgenerate(prompt, max_new_tokens=40)
        taus.extend(a + 1 for a in r.acceptance_lengths)
        ar = model.ar_generate(prompt, max_new_tokens=40)
        n = min(r.new_tokens, ar.new_tokens, 40)
        assert r.sequences[: 16 + n].tolist() == ar.sequences[: 16 + n].tolist()
    assert np.mean(taus) >= float(z["__tau__"]) - 0.15, (np.mean(taus), float(z["__tau__"]))
