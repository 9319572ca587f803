"""LLaVA image prompts through the port's SpecModel, batches and engine,
against the JAX package's SpecModel on the same numpy weights and pixels:
the tests/torch_parity.py target and draft under the tests/test_vision.py
CLIP geometry, float32, greedy, on the CPU.

Token ids must be equal; the merged prompt embeddings within 1e-5 abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                T_TCFG, llava_cfgs, make_models, t2n, vision_params,
                                in_fresh_interpreter_module)
from vispec_tpu.spec import loop as jloop
from vispec_tpu.spec.serving import ServingEngine as JServingEngine
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

EOS = 999  # outside the vocab: generations run to their budget
IMG = 250
NEW = 24


@pytest.fixture(scope="module")
def weights():
    return make_models(seed=0), vision_params()


def _models(weights, anyres=True, image_token_index=IMG, **kw):
    """(JAX, port) SpecModel pair on the module's weights."""
    (jt, jd, tt, td), (jv, tv) = weights
    jcfg, tcfg = llava_cfgs(anyres, image_token_index)
    jmodel = JSpecModel(J_TCFG, J_DCFG, J_SPEC, jt, jd, max_len=MAX_LEN,
                        dtype=jnp.float32, eos_token_id=EOS, llava_cfg=jcfg, vparams=jv,
                        image_token_index=image_token_index, **kw)
    tmodel = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, dict(td), max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU, llava_cfg=tcfg,
                        vparams=tv, image_token_index=image_token_index, **kw)
    return jmodel, tmodel


def _image(h, w, seed):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


def _prompt(model, sizes, image_token=IMG, head=(10, 20), tail=(30, 40)):
    """Text, then each image's placeholders with a few text ids between
    them, then text."""
    ids = list(range(*head))
    for i, size in enumerate(sizes):
        if i:
            ids += [5 + i, 6 + i]
        ids += [image_token] * model.count_image_tokens(size)
    return ids + list(range(*tail))


def _new(res, ids):
    return res.sequences[len(ids):].tolist()


@pytest.mark.parametrize("anyres", [True, False], ids=["llava16_anyres", "llava15"])
def test_specgenerate_with_one_image_matches_jax(weights, anyres):
    """Greedy tokens equal JAX's specgenerate and the port's own AR."""
    jmodel, tmodel = _models(weights, anyres)
    img = _image(100, 200, seed=1)
    ids = _prompt(tmodel, [(100, 200)])
    jres = jmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=jnp.asarray(img),
                               image_size=(100, 200))
    tres = tmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=img,
                               image_size=(100, 200))
    assert _new(tres, ids) == _new(jres, ids)
    assert tres.acceptance_lengths == jres.acceptance_lengths
    ar = tmodel.ar_generate(ids, max_new_tokens=NEW, pixel_values=img, image_size=(100, 200))
    assert tres.new_tokens >= NEW and _new(tres, ids)[:NEW] == _new(ar, ids)


def _first_tree_spy(monkeypatch):
    """Record the first tree and the last image token's adapted feature of
    each side's prefill (copies: later rounds reuse the buffers)."""
    seen = {}

    def spy(name, mod, attr):
        fn = getattr(mod, attr)

        def wrapped(*args, **kw):
            state = fn(*args, **kw)
            seen[name] = [np.array(x, np.float32) if name == "jax" else t2n(x).copy()
                          for x in (state.tree.tokens, state.tree.parent,
                                    state.tree.mask, state.last_img)]
            return state
        monkeypatch.setattr(mod, attr, wrapped)

    spy("jax", jloop, "spec_prefill_donated")
    spy("port", tloop, "spec_prefill")
    return seen


def test_specgenerate_with_two_images_matches_jax(weights, monkeypatch):
    """Two images of different sizes in one prompt: features concatenated
    in prompt order, two spans in the draft's plan (the first tree and the
    adaptor's last image feature equal JAX's)."""
    jmodel, tmodel = _models(weights)
    seen = _first_tree_spy(monkeypatch)
    sizes = [(100, 200), (80, 90)]
    imgs = [_image(*s, seed=i + 2) for i, s in enumerate(sizes)]
    ids = _prompt(tmodel, sizes)
    jres = jmodel.specgenerate(ids, max_new_tokens=NEW,
                               pixel_values=[jnp.asarray(i) for i in imgs], image_size=sizes)
    tres = tmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=imgs,
                               image_size=sizes)
    assert _new(tres, ids) == _new(jres, ids)
    for j, t in zip(seen["jax"][:3], seen["port"][:3]):
        np.testing.assert_array_equal(t, j)
    assert np.abs(seen["port"][3]).max() > 0  # the image spans were compressed
    np.testing.assert_allclose(seen["port"][3], seen["jax"][3], rtol=0, atol=1e-4)
    ar = tmodel.ar_generate(ids, max_new_tokens=NEW, pixel_values=imgs, image_size=sizes)
    assert tres.new_tokens >= NEW and _new(tres, ids)[:NEW] == _new(ar, ids)


def test_prompt_embeds_and_counts_match_jax(weights):
    """count_image_tokens, the merged embeddings, the image mask, the
    shifted mask and its span count, for a two-image prompt."""
    jmodel, tmodel = _models(weights)
    for anyres in (True, False):
        jm, tm = _models(weights, anyres)
        for size in ((40, 40), (100, 200), (80, 90), (120, 60), (480, 640)):
            assert tm.count_image_tokens(size) == jm.count_image_tokens(size)
    sizes = [(100, 200), (40, 40)]
    imgs = [_image(*s, seed=i) for i, s in enumerate(sizes)]
    ids = np.asarray(_prompt(tmodel, sizes))
    pad = 128
    jemb, jmask, jshift, jspans, _, _ = jmodel._padded_prompt(
        ids, pad, [jnp.asarray(i) for i in imgs], sizes)
    temb, tmask, tshift, tspans, trope = tmodel._padded_prompt(ids, pad, imgs, sizes)
    np.testing.assert_allclose(t2n(temb), np.asarray(jemb), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tshift, jshift)
    assert tspans == jspans == 2
    assert trope is None  # LLaVA positions are plain rotary
    with pytest.raises(ValueError, match="image token count"):
        jmodel._prompt_embeds(ids[:-45], [jnp.asarray(i) for i in imgs], sizes)
    with pytest.raises(ValueError, match="image token count"):
        tmodel._padded_prompt(ids[:-45], pad, imgs, sizes)


def test_image_token_index_outside_the_vocab_matches_jax(weights):
    """image_token_index == vocab_size: JAX's take fills those rows before
    the merge overwrites them; the port looks them up as id 0.  Same
    tokens."""
    jmodel, tmodel = _models(weights, image_token_index=T_TCFG.vocab_size)
    img = _image(80, 90, seed=4)
    ids = _prompt(tmodel, [(80, 90)], image_token=T_TCFG.vocab_size)
    jres = jmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=jnp.asarray(img))
    tres = tmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=img)
    assert tres.new_tokens >= NEW and _new(tres, ids) == _new(jres, ids)


def _requests(model):
    """A text request and two image requests of different sizes."""
    out = [{"input_ids": list(range(40, 70))}]
    for seed, size in ((5, (100, 200)), (6, (120, 60))):
        out.append({"input_ids": _prompt(model, [size], head=(10 + seed, 20)),
                    "pixel_values": _image(*size, seed), "image_size": size})
    return out


def _single(model, req, n=NEW):
    res = model.specgenerate(req["input_ids"], max_new_tokens=n,
                             pixel_values=req.get("pixel_values"),
                             image_size=req.get("image_size"))
    return _new(res, req["input_ids"])[:n]


def test_specgenerate_batch_with_images_matches_per_request_and_jax(weights):
    jmodel, tmodel = _models(weights)
    reqs = _requests(tmodel)
    refs = [_single(tmodel, r) for r in reqs]
    got = tmodel.specgenerate_batch(reqs, max_new_tokens=NEW)
    jreqs = [{**r, "pixel_values": jnp.asarray(r["pixel_values"])} if "pixel_values" in r
             else r for r in reqs]
    jgot = jmodel.specgenerate_batch(jreqs, max_new_tokens=NEW)
    for r, res, jres, ref in zip(reqs, got, jgot, refs):
        assert res.new_tokens == NEW and _new(res, r["input_ids"]) == ref
        assert _new(jres, r["input_ids"]) == ref


def test_engine_with_images_matches_per_request(weights):
    """Two slots, three requests: admissions mid-flight, a text request
    between image requests."""
    _, tmodel = _models(weights)
    reqs = _requests(tmodel)
    eng = ServingEngine(tmodel, batch_size=2, max_new_tokens=NEW, chunk_rounds=4,
                        max_span=128)
    outs = eng.run_all(reqs)
    assert not eng.errors
    for r, o in zip(reqs, outs):
        assert o.tolist() == _single(tmodel, r)


def test_engine_refuses_a_span_past_max_span_like_jax(weights):
    """An image span longer than the engine's max_span fails that request
    with JAX's ValueError; the other requests are served."""
    jmodel, tmodel = _models(weights)
    req = _requests(tmodel)[1]  # 52 image tokens
    jreq = {**req, "pixel_values": jnp.asarray(req["pixel_values"])}
    with pytest.raises(ValueError) as jerr:
        JServingEngine(jmodel, batch_size=2, max_span=32)._prefill_one(jreq)
    eng = ServingEngine(tmodel, batch_size=2, max_new_tokens=8, max_span=32)
    with pytest.raises(ValueError) as terr:
        eng._prefill_one(req)
    assert str(terr.value) == str(jerr.value) == (
        "image span 52 exceeds engine max_span=32; construct the engine with a "
        "larger bucket")
    outs = eng.run_all([req, {"input_ids": list(range(40, 70))}])
    assert outs[0].size == 0 and eng.errors[0] == f"ValueError: {terr.value}"
    assert len(outs[1]) == 8


def test_video_requests_and_images_without_a_tower_are_refused(weights):
    _, tmodel = _models(weights)
    video = np.zeros((2, 28, 28, 3), np.float32)
    # videos are Qwen2.5-VL prompts: a LLaVA model refuses them
    with pytest.raises(ValueError, match="without a Qwen2.5-VL vision tower"):
        tmodel.specgenerate([1, 2, 3], max_new_tokens=4, pixel_values_videos=video)
    with pytest.raises(ValueError, match="without a Qwen2.5-VL vision tower"):
        tmodel.specgenerate_batch([{"input_ids": [1, 2, 3], "pixel_values_videos": video}])
    with pytest.raises(ValueError, match="video requests need a Qwen2.5-VL model"):
        ServingEngine(tmodel, batch_size=2).submit(
            {"input_ids": [1, 2, 3], "pixel_values_videos": video})
    (_, _, tt, td), _ = weights
    text_only = TSpecModel(T_TCFG, T_DCFG, T_SPEC, tt, dict(td), max_len=MAX_LEN,
                           dtype=torch.float32, device=CPU)
    with pytest.raises(ValueError, match="without a vision tower"):
        text_only.specgenerate([1, 2, 3], max_new_tokens=4,
                               pixel_values=_image(40, 40, 0))


def test_quantized_spec_with_an_image_matches_jax(weights):
    """int8 KV cache and int8 target with an image (the tower unquantized
    on both sides): the port's spec equals JAX's spec and its own AR."""
    jmodel, tmodel = _models(weights, quantize_kv=True)
    jmodel.tparams, tmodel.tparams = dict(jmodel.tparams), dict(tmodel.tparams)
    for m in (jmodel, tmodel):
        m.tparams["layers"] = dict(m.tparams["layers"])
        m.quantize_target_inplace()
    img = _image(100, 200, seed=7)
    ids = _prompt(tmodel, [(100, 200)])
    jres = jmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=jnp.asarray(img))
    tres = tmodel.specgenerate(ids, max_new_tokens=NEW, pixel_values=img)
    assert _new(tres, ids) == _new(jres, ids)
    ar = tmodel.ar_generate(ids, max_new_tokens=NEW, pixel_values=img)
    assert tres.new_tokens >= NEW and _new(tres, ids)[:NEW] == _new(ar, ids)
    assert tmodel.vparams["vision"]["layers"]["wq"].dtype == torch.float32


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
