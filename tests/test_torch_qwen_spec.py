"""Qwen2.5-VL image and video prompts through the port's SpecModel, batches
and engine, against the JAX package's SpecModel on the same numpy weights
and pixels: the tests/torch_parity.py Qwen geometry (M-RoPE sections (2, 2,
2), qkv bias, a toy windowed ViT), float32, greedy, on the CPU.

Token ids must be equal; the merged prompt embeddings within 1e-5 abs;
M-RoPE position ids and rope_delta exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_SPEC, MAX_LEN, T_SPEC, qwen_models, t2n,
                                to_numpy_tree, in_fresh_interpreter_module)
from vispec_tpu.models import medusa as jmedusa
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.spec import loop as tloop
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

EOS = 999  # outside the vocab: generations run to their budget
IMG, VID, VSTART = 250, 251, 252
NEW = 20
# small pixel budgets keep the toy prompts short: images of 56x56 to 140x140
BUDGET = dict(min_pixels=56 * 56, max_pixels=28 * 28 * 25)
SIZES = [(100, 130), (150, 90)]  # resized up to 112x140 (20 tokens), down to 140x84 (15)
VIDEO = (3, 60, 90)  # 3 frames (the last repeated) -> 2 x 4 x 6 patches, 12 tokens


@pytest.fixture(scope="module")
def weights():
    return qwen_models(seed=0)


def _models(weights, mparams=(None, None), **kw):
    """(JAX, port) SpecModel pair on the module's weights; ``mparams`` is a
    (JAX, port) pair of Medusa heads."""
    jtc, jdc, jvc, ttc, tdc, tvc, jt, jd, jv, tt, td, tv = weights
    common = dict(image_token_index=IMG, video_token_index=VID,
                  vision_start_token_id=VSTART, eos_token_id=EOS, max_len=MAX_LEN,
                  **BUDGET, **kw)
    jmodel = JSpecModel(jtc, jdc, J_SPEC, jt, jd, dtype=jnp.float32, qwen_cfg=jvc,
                        vparams=jv, mparams=mparams[0], **common)
    tmodel = TSpecModel(ttc, tdc, T_SPEC, tt, dict(td), dtype=torch.float32, device=CPU,
                        qwen_cfg=tvc, vparams=tv, mparams=mparams[1], **common)
    return jmodel, tmodel


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _image_prompt(model, sizes, head=(10, 20), tail=(30, 40)):
    """Text, then each image as <vision_start> and its placeholders with a
    few text ids between images, then text."""
    ids = list(range(*head))
    for i, size in enumerate(sizes):
        if i:
            ids += [5 + i, 6 + i]
        ids += [VSTART] + [IMG] * model.count_image_tokens(size)
    return ids + list(range(*tail))


def _video_prompt(model, head=(10, 20), tail=(30, 44)):
    t, h, w = VIDEO
    return (list(range(*head)) + [VSTART] + [VID] * model.count_video_tokens(t, (h, w))
            + list(range(*tail)))


# (name, prompt builder, port kwargs); JAX gets the pixels as jnp arrays
def _cases(model):
    imgs = [_pixels((*s, 3), i + 1) for i, s in enumerate(SIZES)]
    video = _pixels((*VIDEO, 3), 9)
    return {
        "one_image": (_image_prompt(model, SIZES[:1]),
                      dict(pixel_values=imgs[0], image_size=SIZES[0])),
        "two_images": (_image_prompt(model, SIZES),
                       dict(pixel_values=imgs, image_size=SIZES)),
        "video": (_video_prompt(model),
                  dict(pixel_values_videos=video, second_per_grid_ts=0.7)),
    }


def _jax_kw(kw):
    out = dict(kw)
    if "pixel_values" in kw:
        pv = kw["pixel_values"]
        out["pixel_values"] = ([jnp.asarray(x) for x in pv] if isinstance(pv, list)
                               else jnp.asarray(pv))
    if "pixel_values_videos" in kw:
        out["pixel_values_videos"] = jnp.asarray(kw["pixel_values_videos"])
    return out


def _new(res, ids):
    return res.sequences[len(ids):].tolist()


def test_counts_embeds_positions_and_rope_delta_match_jax(weights):
    """count_image_tokens over the budgets' cases; for one image, two
    images, a video, and a video given with images (which are not used):
    the merged embeddings, the vision mask, the shifted mask and its span
    count, the M-RoPE ids continued over the padding and rope_delta."""
    jmodel, tmodel = _models(weights)
    for size in ((56, 56), (100, 130), (150, 90), (200, 260), (30, 40), (60, 300)):
        assert tmodel.count_image_tokens(size) == jmodel.count_image_tokens(size)
    pad = 128
    cases = _cases(tmodel)
    video_ids, video_kw = cases["video"]
    cases["video_and_images"] = (video_ids, {**cases["two_images"][1], **video_kw})
    for name, (ids, kw) in cases.items():
        ids = np.asarray(ids)
        jemb, jmask, jshift, jspans, jpos, jdelta = jmodel._padded_prompt(
            ids, pad, **_jax_kw(kw))
        got = tmodel._padded_prompt(ids, pad, **kw)
        np.testing.assert_allclose(t2n(got.embeds), np.asarray(jemb), rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(got.image_mask, jmask, err_msg=name)
        np.testing.assert_array_equal(got.shifted, jshift, err_msg=name)
        np.testing.assert_array_equal(t2n(got.rope.position_ids), np.asarray(jpos),
                                      err_msg=name)
        assert got.n_spans == jspans == (2 if name == "two_images" else 1)
        assert got.rope.delta == jdelta < 0, name
    # a text prompt on a Qwen model: plain positions, no offset
    assert tmodel._padded_prompt(list(range(10, 40)), pad).rope is None
    ids, kw = cases["one_image"]
    with pytest.raises(ValueError, match="image token count"):
        tmodel._padded_prompt(ids[:-12], pad, **kw)


@pytest.mark.parametrize("case", ["one_image", "two_images", "video"])
def test_specgenerate_matches_jax_and_ar(weights, case):
    """Greedy spec tokens equal JAX's spec; the port's AR equals its spec
    and JAX's AR (both through the M-RoPE prefill and rope_delta)."""
    jmodel, tmodel = _models(weights)
    ids, kw = _cases(tmodel)[case]
    jres = jmodel.specgenerate(ids, max_new_tokens=NEW, **_jax_kw(kw))
    tres = tmodel.specgenerate(ids, max_new_tokens=NEW, **kw)
    assert _new(tres, ids) == _new(jres, ids)
    assert tres.acceptance_lengths == jres.acceptance_lengths
    ar = tmodel.ar_generate(ids, max_new_tokens=NEW, **kw)
    assert tres.new_tokens >= NEW and _new(tres, ids)[:NEW] == _new(ar, ids)
    if case == "video":
        jar = jmodel.ar_generate(ids, max_new_tokens=NEW, **_jax_kw(kw))
        assert _new(ar, ids) == _new(jar, ids)


def test_prefill_state_carries_rope_delta(weights, monkeypatch):
    """The state's rope_delta is the prompt's (negative after an image) and
    stays through the rounds; a text prompt's is 0."""
    _, tmodel = _models(weights)
    states = []
    real = tloop.spec_prefill

    def spy(*a, **kw):
        states.append(real(*a, **kw))
        return states[-1]

    monkeypatch.setattr(tloop, "spec_prefill", spy)
    ids, kw = _cases(tmodel)["two_images"]
    delta = tmodel._padded_prompt(ids, 128, **kw).rope.delta
    tmodel.specgenerate(ids, max_new_tokens=4, **kw)
    tmodel.specgenerate(list(range(10, 40)), max_new_tokens=4)
    assert [int(s.rope_delta) for s in states] == [delta, 0]


def _requests(model):
    """An image request, a text request, a video request, two images."""
    c = _cases(model)
    return [{"input_ids": c["one_image"][0], **c["one_image"][1]},
            {"input_ids": list(range(40, 70))},
            {"input_ids": c["video"][0], **c["video"][1]},
            {"input_ids": c["two_images"][0], **c["two_images"][1]}]


def _single(model, req, n=NEW):
    kw = {k: v for k, v in req.items() if k != "input_ids"}
    return _new(model.specgenerate(req["input_ids"], max_new_tokens=n, **kw),
                req["input_ids"])[:n]


def test_batch_and_engine_match_per_request_and_jax(weights):
    """specgenerate_batch over image, text, video and two-image requests
    equals per-request decoding and JAX's batch; the engine (two slots,
    admissions mid-flight) equals per-request decoding."""
    jmodel, tmodel = _models(weights)
    reqs = _requests(tmodel)
    refs = [_single(tmodel, r) for r in reqs]
    got = tmodel.specgenerate_batch(reqs, max_new_tokens=NEW)
    jgot = jmodel.specgenerate_batch([_jax_kw(r) for r in reqs], max_new_tokens=NEW)
    for r, res, jres, ref in zip(reqs, got, jgot, refs):
        assert res.new_tokens == NEW and _new(res, r["input_ids"]) == ref
        assert _new(jres, r["input_ids"]) == ref
    eng = ServingEngine(tmodel, batch_size=2, max_new_tokens=NEW, chunk_rounds=4,
                        max_span=128)
    outs = eng.run_all(reqs)
    assert not eng.errors
    for o, ref in zip(outs, refs):
        assert o.tolist() == ref


def test_sampled_top_k_one_and_quantized_spec_equal_ar(weights):
    """T 0.7 with top_k 1 (the sampled path, one candidate) equals greedy
    with a video; int8 KV + int4 draft with an image: spec equals AR and
    JAX's spec."""
    _, tmodel = _models(weights)
    ids, kw = _cases(tmodel)["video"]
    greedy = tmodel.specgenerate(ids, max_new_tokens=NEW, **kw)
    sampled = tmodel.specgenerate(ids, max_new_tokens=NEW, temperature=0.7, top_k=1,
                                  seed=3, **kw)
    assert _new(sampled, ids)[:NEW] == _new(greedy, ids)[:NEW]
    jq, tq = _models(weights, quantize_kv=True, quantize_draft="int4")
    ids, kw = _cases(tq)["one_image"]
    spec = tq.specgenerate(ids, max_new_tokens=NEW, **kw)
    ar = tq.ar_generate(ids, max_new_tokens=NEW, **kw)
    assert _new(spec, ids)[:NEW] == _new(ar, ids)
    assert _new(spec, ids) == _new(jq.specgenerate(ids, max_new_tokens=NEW,
                                                   **_jax_kw(kw)), ids)


def test_medusa_on_vision_prompts_matches_jax(weights):
    """Medusa heads on the Qwen target: as in the JAX package, the prefill
    gives every prompt plain positions and no M-RoPE offset.  The port's
    tokens equal JAX's with two images and with a video; on a text prompt
    Medusa equals AR.  The fixture's positions count: on the vision prompts
    Medusa departs from AR, which takes the M-RoPE ids."""
    k = jax.random.PRNGKey(5)
    jm = jmedusa.init_params(weights[0].hidden_size, k, jnp.float32)
    jm = {name: x + 0.05 * jax.random.normal(jax.random.fold_in(k, i), x.shape, x.dtype)
          for i, (name, x) in enumerate(jm.items())}
    jmed, med = _models(weights, mparams=(jm, from_numpy(to_numpy_tree(jm), CPU)))
    departs = []
    for case in ("two_images", "video"):
        ids, kw = _cases(med)[case]
        spec = med.specgenerate(ids, max_new_tokens=NEW, **kw)
        jspec = jmed.specgenerate(ids, max_new_tokens=NEW, **_jax_kw(kw))
        assert _new(spec, ids) == _new(jspec, ids), case
        assert spec.acceptance_lengths == jspec.acceptance_lengths, case
        ar = med.ar_generate(ids, max_new_tokens=NEW, **kw)
        departs.append(_new(spec, ids)[:NEW] != _new(ar, ids))
    assert all(departs)
    text = list(range(40, 70))
    spec = med.specgenerate(text, max_new_tokens=NEW)
    assert _new(spec, text)[:NEW] == _new(med.ar_generate(text, max_new_tokens=NEW), text)
    assert _new(spec, text) == _new(jmed.specgenerate(text, max_new_tokens=NEW), text)


def test_a_qwen_tower_needs_an_mrope_target(weights):
    _, _, _, ttc, tdc, tvc, _, _, _, tt, td, tv = weights
    plain = dataclasses.replace(ttc, mrope_section=None)
    with pytest.raises(ValueError, match="mrope_section"):
        TSpecModel(plain, tdc, T_SPEC, tt, dict(td), dtype=torch.float32, device=CPU,
                   qwen_cfg=tvc, vparams=tv)


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
