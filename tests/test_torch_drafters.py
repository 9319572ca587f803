"""The Medusa and EAGLE-2 drafters in the port against the JAX package, on
the tests/torch_parity.py geometry in float32 on the CPU, greedy.

Medusa's heads, its tree and the static-tree helpers must equal JAX's
(tokens, parents, depths, masks; hidden states within 1e-5); token ids and
acceptance lengths of whole generations must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                T_TCFG, llava_cfgs, make_models, t2n, to_numpy_tree,
                                vision_params, in_fresh_interpreter_module)
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import medusa as jmedusa
from vispec_tpu.ops import static_tree as jstatic
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import medusa as tmedusa
from vispec_tpu_torch.ops import static_tree as tstatic
from vispec_tpu_torch.spec import spec_model as tspec_model
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

EOS = 999  # outside the vocab: generations run to their budget
NEW = 24


def _same_tree(jtree, ttree):
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(ttree, name)),
                                      np.asarray(getattr(jtree, name)), err_msg=name)


@pytest.fixture(scope="module")
def weights():
    """The parity target and draft, and Medusa heads from JAX's initializer
    with 0.05 noise so that the trees are not trivial."""
    jt, jd, tt, td = make_models(seed=5)
    k = jax.random.PRNGKey(5)
    jm = jmedusa.init_params(J_TCFG.hidden_size, k, jnp.float32)
    jm = {name: x + 0.05 * jax.random.normal(jax.random.fold_in(k, i), x.shape, x.dtype)
          for i, (name, x) in enumerate(jm.items())}
    return jt, jd, tt, td, jm, from_numpy(to_numpy_tree(jm), CPU)


def _medusa_pair(weights, **kw):
    jt, jd, tt, td, jm, tm = weights
    jmodel = JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, max_len=MAX_LEN,
                        dtype=jnp.float32, eos_token_id=EOS, mparams=jm, **kw)
    tmodel = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, dict(td), max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU, mparams=tm, **kw)
    return jmodel, tmodel


def test_heads_and_medusa_tree_match_jax(weights):
    """heads_forward and expand_tree for one request and for a batch of
    three (JAX vmapped) against JAX: the same tree, heads within 1e-5."""
    jt, _, tt, _, jm, tm = weights
    hidden = np.random.default_rng(1).normal(0, 1, (3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        t2n(tmedusa.heads_forward(tm, torch.from_numpy(hidden))),
        np.asarray(jmedusa.heads_forward(jm, jnp.asarray(hidden))), rtol=0, atol=1e-5)
    roots = np.asarray([7, 100, 3], np.int32)
    jtree = jmedusa.expand_tree(jm, J_SPEC, jnp.asarray(hidden[0]), jnp.int32(7),
                                jt["lm_head"])
    _same_tree(jtree, tmedusa.expand_tree(tm, T_SPEC, torch.from_numpy(hidden[0]),
                                          torch.tensor(7, dtype=torch.int32),
                                          tt["lm_head"]))
    assert int(np.asarray(jtree.depth).max()) >= 2
    jb = jax.vmap(lambda h, r: jmedusa.expand_tree(jm, J_SPEC, h, r, jt["lm_head"]))(
        jnp.asarray(hidden), jnp.asarray(roots))
    _same_tree(jb, tmedusa.expand_tree(tm, T_SPEC, torch.from_numpy(hidden),
                                       torch.from_numpy(roots), tt["lm_head"]))


def test_static_tree_matches_jax():
    for choices in (jstatic.MC_SIM_7B_63, ((0,), (1,), (0, 0), (0, 1), (1, 0), (0, 0, 0))):
        jtr = jstatic.from_choices(choices)
        ttr = tstatic.from_choices(choices, device=CPU)
        _same_tree(jtr, ttr)
        topk = np.random.default_rng(2).integers(0, 500, (len(choices) + 1, 4)).astype(
            np.int32)
        _same_tree(jstatic.fill_tokens(jtr, jnp.asarray(topk), choices, 42),
                   tstatic.fill_tokens(ttr, torch.from_numpy(topk), choices, 42))
    assert tstatic.MC_SIM_7B_63 == jstatic.MC_SIM_7B_63


def test_convert_medusa_and_from_numpy_match_jax():
    """A fabricated HF state dict (torch's [out, in] layout) through both
    converters; the heads cross ``from_numpy`` in the model's dtype."""
    rng = np.random.default_rng(3)
    sd = {}
    for i in range(tmedusa.NUM_HEADS):
        sd[f"medusa_head.{i}.0.linear.weight"] = rng.normal(size=(16, 16)).astype(np.float32)
        sd[f"medusa_head.{i}.0.linear.bias"] = rng.normal(size=(16,)).astype(np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jmedusa.convert_medusa(sd, jdt)
        got = tmedusa.convert_medusa(sd, dtype, device=CPU)
        for name in ("heads_w", "heads_b"):
            assert got[name].dtype == dtype
            np.testing.assert_array_equal(t2n(got[name].float()),
                                          np.asarray(want[name].astype(jnp.float32)))
        bridged = from_numpy(to_numpy_tree(want), CPU, dtype=torch.bfloat16)
        assert bridged["heads_w"].dtype == bridged["heads_b"].dtype == torch.bfloat16
        assert bridged["heads_w"].shape == (5, 16, 16)
    assert tmedusa.init_params(16, CPU)["heads_w"].abs().sum() == 0


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["bf16_free", "int8_kv"])
def test_medusa_spec_matches_jax_and_ar(weights, quantize_kv):
    """Greedy Medusa: tokens and acceptance lengths equal JAX's, spec equals
    the port's AR (over the same int8 KV cache in the quantized case)."""
    jmodel, tmodel = _medusa_pair(weights, quantize_kv=quantize_kv)
    prompt = list(range(40, 70))
    jres = jmodel.specgenerate(prompt, max_new_tokens=NEW)
    tres = tmodel.specgenerate(prompt, max_new_tokens=NEW)
    assert tres.sequences.tolist() == jres.sequences.tolist()
    assert tres.acceptance_lengths == jres.acceptance_lengths
    assert max(tres.acceptance_lengths) >= 1
    ar = tmodel.ar_generate(prompt, max_new_tokens=NEW)
    assert tres.sequences[:len(prompt) + NEW].tolist() == ar.sequences.tolist()
    with pytest.raises(NotImplementedError, match="medusa"):
        tmodel.specgenerate(prompt, temperature=0.8, repetition_penalty=1.3,
                            max_new_tokens=4)


def test_medusa_batch_and_engine_match_single(weights):
    """specgenerate_batch and the engine (B = 2, three requests, so one
    admission lands mid-flight) equal single-request Medusa runs."""
    _, tmodel = _medusa_pair(weights)
    prompts = [list(range(40, 70)), list(range(15, 33)), list(range(100, 140))]
    singles = [tmodel.specgenerate(p, max_new_tokens=16).sequences[len(p):len(p) + 16]
               .tolist() for p in prompts]
    batch = tmodel.specgenerate_batch([{"input_ids": p} for p in prompts],
                                      max_new_tokens=16)
    assert [r.sequences[len(p):].tolist() for p, r in zip(prompts, batch)] == singles
    eng = tmodel.serving_engine(batch_size=2, max_new_tokens=16, chunk_rounds=4)
    assert [o.tolist() for o in eng.run_all(prompts)] == singles
    assert eng.stats["admissions"] >= 1
    with pytest.raises(NotImplementedError, match="prefix caching"):
        tmodel.serving_engine(batch_size=2, prefix_ids=list(range(10)))
    per = tmodel.serving_engine(batch_size=2, per_request_sampling=True)
    with pytest.raises(ValueError, match="repetition_penalty is not supported"):
        per.submit({"input_ids": prompts[0], "temperature": 1.0,
                    "repetition_penalty": 1.2})


def test_medusa_with_an_image_matches_jax(weights):
    """Medusa on a LLaVA-1.6 image prompt: the merged embeds reach
    medusa_prefill; tokens equal JAX's, and the engine's equal the single
    run's (tests/test_serving.py's Medusa-with-vision case)."""
    jt, jd, tt, td, jm, tm = weights
    jcfg, tcfg = llava_cfgs(True, 250)
    jv, tv = vision_params()
    jmodel = JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, max_len=512, dtype=jnp.float32,
                        eos_token_id=EOS, llava_cfg=jcfg, vparams=jv, image_token_index=250,
                        mparams=jm)
    tmodel = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, dict(td), max_len=512,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU, llava_cfg=tcfg,
                        vparams=tv, image_token_index=250, mparams=tm)
    img = np.random.default_rng(1).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    ids = list(range(10, 20)) + [250] * tmodel.count_image_tokens((40, 40)) + list(
        range(30, 40))
    jres = jmodel.specgenerate(ids, max_new_tokens=16, pixel_values=jnp.asarray(img),
                               image_size=(40, 40))
    tres = tmodel.specgenerate(ids, max_new_tokens=16, pixel_values=img,
                               image_size=(40, 40))
    assert tres.sequences.tolist() == jres.sequences.tolist()
    assert tres.acceptance_lengths == jres.acceptance_lengths
    eng = tmodel.serving_engine(batch_size=2, max_new_tokens=8, pad_bucket=256,
                                chunk_rounds=4, max_span=128)
    outs = eng.run_all([{"input_ids": ids, "pixel_values": img, "image_size": (40, 40)},
                        list(range(40, 70))])
    assert outs[0].tolist() == tres.sequences[len(ids):len(ids) + 8].tolist()


def _eagle_models(quantize_draft=False):
    """An EAGLE-2 draft (``vision=False``: no adaptor, no img_fc) on JAX's
    initializer, as tests/test_spec_model_api.py builds it."""
    jt, _, tt, _ = make_models(seed=9)
    jcfg = JDraftConfig(**{**J_DCFG.__dict__, "vision": False})
    tcfg = tconfigs.DraftConfig(**{**T_DCFG.__dict__, "vision": False})
    jd = jdraft.init_params(jcfg, jax.random.PRNGKey(19), jnp.float32)
    assert "img_fc_w" not in jd and "adaptor" not in jd
    jd["embed"] = jt["embed"]
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    jmodel = JSpecModel(J_TCFG, jcfg, J_SPEC, jt, jd, max_len=MAX_LEN, dtype=jnp.float32,
                        eos_token_id=EOS, quantize_draft=quantize_draft)
    tmodel = TSpecModel(T_TCFG, tcfg, T_SPEC, tt, td, max_len=MAX_LEN, dtype=torch.float32,
                        eos_token_id=EOS, device=CPU, quantize_draft=quantize_draft)
    return jmodel, tmodel


@pytest.mark.parametrize("quantize_draft", [False, "int8"], ids=["f32", "int8_draft"])
def test_eagle_spec_matches_jax_and_ar(quantize_draft):
    jmodel, tmodel = _eagle_models(quantize_draft)
    prompt = list(range(15, 45))
    jres = jmodel.specgenerate(prompt, max_new_tokens=NEW)
    tres = tmodel.specgenerate(prompt, max_new_tokens=NEW)
    assert tres.sequences.tolist() == jres.sequences.tolist()
    assert tres.acceptance_lengths == jres.acceptance_lengths
    ar = tmodel.ar_generate(prompt, max_new_tokens=NEW)
    assert tres.sequences[:len(prompt) + NEW].tolist() == ar.sequences.tolist()
    assert "img_fc_w" not in tmodel.dparams


def test_quantize_draft_leaves_a_layerless_draft_alone_like_jax(weights):
    """A draft without a layer (a target-only stub, or Medusa's) is left as
    it is by quantize_draft, as in JAX: no ranking head, no fuse matrices,
    ``quantize_draft`` stays False; a Medusa model so built still decodes
    as JAX's does."""
    jt, _, tt, _, jm, tm = weights
    jstub = {"embed": jt["embed"], "layer": {}, "fc_w": jnp.zeros((1,), jnp.float32)}
    tstub = tspec_model._stub_draft_params(tt, torch.float32)
    stub_cfg = tspec_model._stub_draft_config(T_TCFG)
    assert stub_cfg.num_key_value_heads == 1 and stub_cfg.intermediate_size == 128
    jmodel = JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jstub, max_len=MAX_LEN,
                        dtype=jnp.float32, eos_token_id=EOS, mparams=jm,
                        quantize_draft=True)
    tmodel = TSpecModel(T_TCFG, stub_cfg, T_SPEC, tt, tstub, max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU, mparams=tm,
                        quantize_draft=True)
    assert tmodel.quantize_draft is jmodel.quantize_draft is False
    assert sorted(tmodel.dparams) == sorted(jmodel.dparams) == ["embed", "fc_w", "layer"]
    tmodel.quantize_draft_inplace("int4")
    assert tmodel.quantize_draft is False and "rank_head" not in tmodel.dparams
    prompt = list(range(40, 70))
    assert (tmodel.specgenerate(prompt, max_new_tokens=12).sequences.tolist()
            == jmodel.specgenerate(prompt, max_new_tokens=12).sequences.tolist())


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
