"""Port vs JAX: the training half (ROADMAP Queue 1 item 20).

The same numpy inputs from a seed go through the JAX package and the port,
float32 on the CPU unless a test says otherwise:
  - ``draft.layer_forward_nocache`` / ``forward_train`` (text and image
    spans) <= 1e-5, and the gradients of the MTP loss wrt every draft leaf
    <= 1e-5 of the leaf's largest gradient;
  - ``draft_loss``, ``stage1_loss``, ``smooth_l1`` <= 1e-6, metrics equal;
  - three optimizer steps of ``train_step``, ``train_step_stage1`` and
    ``train_step_medusa`` from one handed-over state (warm-up 2): each
    step's gradients <= 1e-5 of each leaf's largest, the parameters within
    1% of the learning rate of JAX's after every step, the rate read at
    each step equal; with ``bf16=True`` the loss and metrics within 1e-2
    (relative), the first step's gradients within 1e-2 of each leaf's
    largest;
  - ``generate_sample`` / ``generate_vlm_sample``: token ids equal,
    hiddens <= 1e-5;
  - ``prepare_example`` / ``batch_examples`` bit-equal; ``getkacc`` equal;
  - ``train`` for 2 epochs with a resume: the losses <= 1e-4 of JAX's;
  - the CLIs end to end on fabricated checkpoints, and the refusals of a
    mesh and of the orbax backend.
Every test compiles JAX graphs, so the module runs in a child process
(``tests/torch_parity.in_fresh_interpreter``)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import CPU, in_fresh_interpreter, t2n, to_numpy_tree
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.train import data_gen as jdata_gen
from vispec_tpu.train import losses as jlosses
from vispec_tpu.train import step as jstep
from vispec_tpu.train import trainer as jtrainer
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import adam_state_from_numpy, from_numpy
from vispec_tpu_torch.models import draft as tdraft
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.train import data_gen as tdata_gen
from vispec_tpu_torch.train import losses as tlosses
from vispec_tpu_torch.train import step as tstep
from vispec_tpu_torch.train import trainer as ttrainer

# tests/test_training.py's geometry
TGEO = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
DGEO = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
J_TCFG, T_TCFG = JLlamaConfig(**TGEO), tconfigs.LlamaConfig(**TGEO)
J_DCFG, T_DCFG = JDraftConfig(**DGEO), tconfigs.DraftConfig(**DGEO)
LR = 2e-3


def _cfgs(**kw):
    base = dict(lr=LR, bs=1, num_epochs=1, max_len=64, mtp_steps=1, warmup_steps=2,
                total_steps=1000, max_images=2, max_span_bucket=16)
    base.update(kw)
    return jtrainer.TrainConfig(**base), ttrainer.TrainConfig(**base)


def _target(seed=0):
    jt = jllama.init_params(J_TCFG, jax.random.PRNGKey(seed), jnp.float32)
    return jt, from_numpy(to_numpy_tree(jt), CPU)


def _draft(seed=1, noisy=True):
    """(JAX, port) draft params; with ``noisy`` the biases, img_fc and the
    adaptor get random values, so that every leaf has a live gradient."""
    jd = jdraft.init_params(J_DCFG, jax.random.PRNGKey(seed), jnp.float32)
    if noisy:
        rng = np.random.default_rng(seed)
        for k in ("fc_b", "img_fc_b"):
            jd[k] = jnp.asarray(rng.normal(0, 0.1, jd[k].shape), jnp.float32)
        jd["img_fc_w"] = jd["img_fc_w"] + jnp.asarray(
            rng.normal(0, 0.05, jd["img_fc_w"].shape), jnp.float32)
    return jd, from_numpy(to_numpy_tree(jd), CPU)


def _sample(seed=0, s=40, span=None):
    """A fabricated training record; ``span`` = (start, stop) image rows."""
    rng = np.random.default_rng(seed)
    d = DGEO["hidden_size"]
    img = np.zeros(s, bool)
    if span is not None:
        img[span[0]:span[1]] = True
    mask = np.zeros(s, np.float32)
    mask[s // 3:] = 1.0
    return {"input_ids": rng.integers(0, 96, s).astype(np.int32),
            "hidden_state": rng.normal(0, 1, (s, d)).astype(np.float32),
            "inputs_embeds": rng.normal(0, 1, (s, d)).astype(np.float32),
            "loss_mask": mask, "image_mask": img}


def _batches(samples, jcfg, tcfg):
    """(JAX batch, port batch, max_span) of the same examples."""
    jex = [jtrainer.prepare_example(s, jcfg, J_DCFG, np.random.default_rng(5))
           for s in samples]
    tex = [ttrainer.prepare_example(s, tcfg, T_DCFG, np.random.default_rng(5))
           for s in samples]
    jb, ms = jtrainer.batch_examples(jex)
    tb, _ = ttrainer.batch_examples(tex, CPU)
    return jb, tb, ms


def _head(seed=4, scale=0.3):
    h = np.random.default_rng(seed).normal(0, scale, (32, 96)).astype(np.float32)
    return jnp.asarray(h), torch.from_numpy(h.copy())


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _port_grads(tparams, loss_fn):
    """Gradients of ``loss_fn(p)`` wrt every leaf of ``tparams``."""
    leaves = {p: _at(tparams, p).detach().clone().requires_grad_(True)
              for p in _leaf_paths(tparams)}

    def build(tree, prefix=""):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict) else leaves[f"{prefix}{k}"]
                for k, v in tree.items()}

    loss = loss_fn(build(tparams))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return dict(zip(leaves, grads))


def _assert_grads_close(jgrads, tgrads, tol):
    for path, tg in tgrads.items():
        jg = np.asarray(_at(jgrads, path), np.float32)
        tg = np.zeros_like(jg) if tg is None else t2n(tg).astype(np.float32)
        scale = max(float(np.abs(jg).max()), 1e-30)
        err = float(np.abs(tg - jg).max()) / scale
        assert err <= tol, (path, err)


# ---------------------------------------------------------------------------
# Forwards and gradients
# ---------------------------------------------------------------------------


@in_fresh_interpreter
@pytest.mark.parametrize("kind", ["text", "image"])
def test_forward_train_and_gradients_match_jax(kind):
    jcfg, tcfg = _cfgs()
    span = (6, 19) if kind == "image" else None
    jb, tb, _ = _batches([_sample(1, span=span)], jcfg, tcfg)
    jd, td = _draft()
    plan_j = jax.tree.map(lambda x: x[0], jb.plans)
    plan_t = tstep.plan_at(tb.plans, 0)

    # layer_forward_nocache over a causal mask and forward_train (<= 1e-5)
    x = np.random.default_rng(2).normal(0, 1, (64, 32)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    mask = np.tril(np.ones((64, 64), bool))
    want = jdraft.layer_forward_nocache(jd, J_DCFG, jnp.asarray(x), jnp.asarray(pos),
                                        jnp.asarray(mask))
    got = tdraft.layer_forward_nocache(td, T_DCFG, torch.from_numpy(x),
                                       torch.from_numpy(pos), torch.from_numpy(mask))
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5, rtol=0)
    want = jax.jit(jdraft.forward_train, static_argnums=(1, 5))(
        jd, J_DCFG, jb.hidden_states[0], jb.embeds[0], plan_j, 16)
    got = tdraft.forward_train(td, T_DCFG, tb.hidden_states[0], tb.embeds[0], plan_t, 16)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5, rtol=0)
    dropped = np.all(np.asarray(want) == 0, axis=-1)
    assert np.all(t2n(got)[dropped] == 0)  # the dropped rows stay zero on both sides
    if kind == "image":
        assert dropped[:40].sum() >= 10  # the span's rows but num_q - 1

    # gradients of the MTP loss (one feed-back step) wrt every draft leaf
    jh, th = _head()
    jgrads = jax.jit(jax.grad(lambda p: jstep.mtp_forward(p, J_DCFG, jh, jb, 1, 16)[0]))(jd)
    tgrads = _port_grads(td, lambda p: tstep.mtp_forward(p, T_DCFG, th, tb, 1, 16)[0])
    _assert_grads_close(jgrads, tgrads, 1e-5)
    live = ["fc_w", "layer/wq", "layer/w_down"]
    if kind == "image":
        live += ["adaptor/wk", "adaptor/q", "img_fc_w"]
    for path in live:
        assert tgrads[path] is not None and float(tgrads[path].abs().max()) > 0, path


@in_fresh_interpreter
def test_losses_match_jax():
    rng = np.random.default_rng(3)
    n, s, v = 2, 7, 24
    logits = rng.normal(0, 2, (n, s, v)).astype(np.float32)
    tp = rng.uniform(0, 1, (n, s, v)).astype(np.float32)
    tp[..., 5] = tp[..., 9] = tp.max(-1) + 0.5  # ties in the top-k: lower index first
    tp /= tp.sum(-1, keepdims=True)
    mask = (rng.uniform(0, 1, (n, s)) > 0.3).astype(np.float32)
    # JAX's losses run under value_and_grad, as its train steps run them
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda x: jlosses.draft_loss(x, jnp.asarray(tp), jnp.asarray(mask)),
        has_aux=True))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl, tm = tlosses.draft_loss(x, torch.from_numpy(tp), torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(t2n(torch.autograd.grad(tl, x)[0]), np.asarray(jg),
                               atol=1e-6, rtol=0)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6, rtol=1e-6)

    ph = rng.normal(0, 1, (s, 16)).astype(np.float32)
    th = (ph + rng.normal(0, 1.5, (s, 16))).astype(np.float32)  # both SmoothL1 branches
    np.testing.assert_allclose(t2n(tlosses.smooth_l1(torch.from_numpy(ph), torch.from_numpy(th))),
                               np.asarray(jlosses.smooth_l1(jnp.asarray(ph), jnp.asarray(th))),
                               atol=1e-6, rtol=0)
    args = (ph, th, logits[0], tp[0], mask[0])
    (jl, jm), _ = jax.jit(jax.value_and_grad(
        lambda x: jlosses.stage1_loss(*(jnp.asarray(a) for a in args[:2]), x,
                                      *(jnp.asarray(a) for a in args[3:])),
        has_aux=True))(jnp.asarray(args[2]))
    tl, tm = tlosses.stage1_loss(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-6, rtol=1e-6)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizer steps from one handed-over state
# ---------------------------------------------------------------------------


def _medusa_params(seed=6):
    from vispec_tpu.models.medusa import NUM_HEADS

    rng = np.random.default_rng(seed)
    return {"heads_w": rng.normal(0, 0.05, (NUM_HEADS, 32, 32)).astype(np.float32),
            "heads_b": rng.normal(0, 0.05, (NUM_HEADS, 32)).astype(np.float32)}


def _step_fns(kind, jh, th, ms):
    """(JAX step, port step) of one step kind, each ``(p, o, b, opt, bf16)``."""
    if kind == "mtp":
        return (lambda p, o, b, opt, bf16: jstep.train_step(p, o, J_DCFG, jh, b, opt, 2, ms,
                                                            bf16),
                lambda p, o, b, opt, bf16: tstep.train_step(p, o, T_DCFG, th, b, opt, 2, ms,
                                                            bf16))
    if kind == "stage1":
        return (lambda p, o, b, opt, bf16: jstep.train_step_stage1(
                    p, o, J_DCFG, jh, b, opt, max_span=ms, bf16=bf16),
                lambda p, o, b, opt, bf16: tstep.train_step_stage1(
                    p, o, T_DCFG, th, b, opt, max_span=ms, bf16=bf16))
    return (lambda p, o, b, opt, bf16: jstep.train_step_medusa(p, o, jh, b, opt, bf16=bf16),
            lambda p, o, b, opt, bf16: tstep.train_step_medusa(p, o, th, b, opt, bf16=bf16))


class _Capture:
    """A port optimizer that keeps the gradients a step hands it and moves
    nothing."""

    grads = None

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def _step_grads(kind, jp, tp, jb, tb, jh, th, bf16):
    """(JAX, port) gradients of one step: JAX's handed out of its compiled
    step by an optax transformation that records them (a host callback) and
    moves nothing, the port's from a ``_Capture``."""
    import optax

    seen = []

    def record(g, s, p=None):
        jax.debug.callback(seen.append, g)
        return jax.tree.map(jnp.zeros_like, g), s

    jcap = optax.GradientTransformation(lambda p: optax.EmptyState(), record)
    tcap = _Capture()
    jfn, tfn = _step_fns(kind, jh, th, 16)
    jax.block_until_ready(jfn(jax.tree.map(jnp.copy, jp), jcap.init(jp), jb, jcap, bf16))
    tfn(tp, None, tb, tcap, bf16)
    return seen[0], dict(tstep.leaves(tcap.grads))


@in_fresh_interpreter
@pytest.mark.parametrize("kind", ["mtp", "stage1", "medusa"])
def test_three_steps_match_jax_from_one_state(kind):
    import optax

    jcfg, tcfg = _cfgs(max_len=48)
    jb, tb, _ = _batches([_sample(7, s=40, span=(5, 14))], jcfg, tcfg)
    jh, th = _head()
    if kind == "medusa":
        jp = {k: jnp.asarray(v) for k, v in _medusa_params().items()}
        tp = from_numpy(_medusa_params(), CPU)
    else:
        jp, tp = _draft()
    jopt = jstep.make_optimizer(LR, warmup_steps=2, total_steps=1000)
    topt = tstep.make_optimizer(LR, warmup_steps=2, total_steps=1000)
    jo = jopt.init(jp)
    adam = jo[1]
    to = adam_state_from_numpy(np.asarray(adam.count), to_numpy_tree(adam.mu),
                               to_numpy_tree(adam.nu), CPU)
    # the step's gradients themselves (f32: <= 1e-5 of each leaf's largest)
    _assert_grads_close(*_step_grads(kind, jp, tp, jb, tb, jh, th, False), 1e-5)
    jfn, tfn = _step_fns(kind, jh, th, 16)
    schedule = optax.join_schedules(  # make_optimizer's schedule, transcribed
        [optax.linear_schedule(0.0, LR, 2), optax.linear_schedule(LR, 0.0, 998)], [2])
    for i in range(3):
        assert topt.learning_rate(to.count) == float(schedule(jo[2].count)), i
        jp, jo, jm = jfn(jp, jo, jb, jopt, False)
        tp, to, tm = tfn(tp, to, tb, topt, False)
        assert to.count == int(jo[1].count) == i + 1
        for path in _leaf_paths(tp):
            np.testing.assert_allclose(t2n(_at(tp, path)), np.asarray(_at(jp, path)),
                                       atol=0.01 * LR, rtol=0, err_msg=f"{path} step {i}")
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5)
    if kind != "medusa":  # the frozen embedding did not move
        np.testing.assert_array_equal(t2n(tp["embed"]), np.asarray(jp["embed"]))


@in_fresh_interpreter
@pytest.mark.parametrize("kind", ["mtp", "stage1", "medusa"])
def test_bf16_steps_match_jax(kind):
    jcfg, tcfg = _cfgs(max_len=48)
    jb, tb, _ = _batches([_sample(8, s=40, span=(5, 14))], jcfg, tcfg)
    jh, th = _head()
    if kind == "medusa":
        jp = {k: jnp.asarray(v) for k, v in _medusa_params().items()}
        tp = from_numpy(_medusa_params(), CPU)
    else:
        jp, tp = _draft()
    jopt = jstep.make_optimizer(LR, warmup_steps=2, total_steps=1000)
    topt = tstep.make_optimizer(LR, warmup_steps=2, total_steps=1000)
    # the first step's gradients, bf16 products
    _assert_grads_close(*_step_grads(kind, jp, tp, jb, tb, jh, th, True), 1e-2)
    jfn, tfn = _step_fns(kind, jh, th, 16)
    jo, to = jopt.init(jp), topt.init(tp)
    for i in range(3):
        jp, jo, jm = jfn(jp, jo, jb, jopt, True)
        tp, to, tm = tfn(tp, to, tb, topt, True)
        for path in _leaf_paths(tp):  # f32 master weights
            assert _at(tp, path).dtype == torch.float32
        for k in jm:
            ref = float(jm[k])
            assert abs(float(tm[k]) - ref) <= 1e-2 * max(abs(ref), 1.0), (k, i, tm[k], ref)


# ---------------------------------------------------------------------------
# Data generation, examples, getkacc, the training loop
# ---------------------------------------------------------------------------


def _prompt(jt, tt, seed=7, n=17, pad=64):
    ids = np.random.default_rng(seed).integers(1, 90, n)
    je = jnp.pad(jllama.embed(jt, jnp.asarray(ids)), ((0, pad - n), (0, 0)))
    te = tllama.embed(tt, torch.from_numpy(np.asarray(ids, np.int64)))
    return ids, je, torch.cat([te, torch.zeros(pad - n, 32)])


@in_fresh_interpreter
@pytest.mark.parametrize("pipelined", [True, False])
def test_generate_sample_matches_jax(pipelined):
    jt, tt = _target()
    ids, je, te = _prompt(jt, tt)
    jcache = jkv.init_cache(2, 2, 128, 8, jnp.float32)
    tcache = tkv.init_cache(2, 2, 128, 8, torch.float32, CPU)
    ref, _ = jdata_gen.generate_sample(jt, J_TCFG, je, len(ids), None, jcache,
                                       max_new_tokens=37, eos_token_id=999, pipelined=False)
    gen = ref["input_ids"][len(ids):]
    for eos in (999, int(gen[11])):  # no stop, and a stop inside a chunk
        want, jcache = jdata_gen.generate_sample(
            jt, J_TCFG, je, len(ids), None, jkv.reset(jcache), max_new_tokens=37,
            eos_token_id=eos, chunk=8, pipelined=pipelined)
        got, tcache = tdata_gen.generate_sample(
            tt, T_TCFG, te, len(ids), None, tkv.reset(tcache), max_new_tokens=37,
            eos_token_id=eos, chunk=8, pipelined=pipelined)
        assert set(got) == set(want)
        for k in ("input_ids", "loss_mask", "image_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} eos={eos}")
        for k in ("hidden_state", "inputs_embeds"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


@in_fresh_interpreter
def test_generate_vlm_sample_matches_jax(tmp_path):
    pytest.importorskip("safetensors.numpy")
    from tests.test_vlm_ingestion import _image, _vision_prompt
    from tests.vlm_fixtures import write_llava_ckpt
    from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
    from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

    tdir = str(tmp_path / "t")
    write_llava_ckpt(tdir, anyres=True)
    jm = JSpecModel.from_pretrained(tdir, None, max_len=512, dtype=jnp.float32)
    tm = TSpecModel.from_pretrained(tdir, None, max_len=512, dtype=torch.float32,
                                    device="cpu")
    img = np.asarray(_image(40, 40, seed=2))
    ids, n_img = _vision_prompt(jm, (40, 40))
    want = jdata_gen.generate_vlm_sample(jm, ids, pixel_values=jnp.asarray(img),
                                         image_size=(40, 40), max_new_tokens=12)
    got = tdata_gen.generate_vlm_sample(tm, ids, pixel_values=img, image_size=(40, 40),
                                        max_new_tokens=12)
    assert int(got["image_mask"].sum()) == n_img
    for k in ("input_ids", "loss_mask", "image_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("hidden_state", "inputs_embeds"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


@in_fresh_interpreter
def test_prepare_and_batch_examples_bit_equal():
    jcfg, tcfg = _cfgs(bs=2)
    samples = [_sample(11, s=70, span=(4, 30)), _sample(12, s=30)]
    jb, tb, ms = _batches(samples, jcfg, tcfg)
    assert ms == 26  # the 26-row span (shifted) raises the 16-row bucket
    for name in ("hidden_states", "embeds", "target", "loss_mask"):
        np.testing.assert_array_equal(t2n(getattr(tb, name)), np.asarray(getattr(jb, name)))
    for field in jb.plans._fields:
        np.testing.assert_array_equal(t2n(getattr(tb.plans, field)),
                                      np.asarray(getattr(jb.plans, field)), err_msg=field)


@in_fresh_interpreter
def test_getkacc_matches_jax_and_batched_equals_sequential():
    jd, td = _draft(3)
    jh, th = _head(4, scale=0.5)
    sample = _sample(13, s=60, span=(8, 20))
    want = jtrainer.getkacc(jd, J_DCFG, jh, sample, max_length=3, max_prefixes=6,
                            max_len=64, max_span=16)
    got = ttrainer.getkacc(td, T_DCFG, th, sample, max_length=3, max_prefixes=6,
                           max_len=64, max_span=16)
    assert got == want

    # the batched rollout == one rollout per prefix (tests/test_training.py:354)
    hidden = torch.from_numpy(sample["hidden_state"])
    embeds = torch.from_numpy(sample["inputs_embeds"])
    h_pads, e_pads, plans, seq = [], [], [], []
    for pre_len in (2, 9, 30):
        plan, ms = tdraft.make_prefill_plan(sample["image_mask"][1:pre_len], pre_len - 1,
                                            T_DCFG.num_q, 64, max_images=8, max_span=16,
                                            device=CPU)
        h, e = ttrainer._pad_rows(hidden[:pre_len - 1], 64), ttrainer._pad_rows(
            embeds[1:pre_len], 64)
        seq.append(ttrainer._kacc_rollout_one(td, T_DCFG, th, h, e, plan, 69, 3, ms))
        h_pads.append(h)
        e_pads.append(e)
        plans.append(plan)
    batched = ttrainer._kacc_rollout_batched(
        td, T_DCFG, th, torch.stack(h_pads), torch.stack(e_pads),
        tdraft.PrefillPlan(*(torch.stack(fs) for fs in zip(*plans))), 69, 3, 16)
    np.testing.assert_array_equal(t2n(batched), t2n(torch.stack(seq)))


def _write_dataset(tmp_path, jt, n=4):
    cache = jkv.init_cache(2, 2, 128, 8, jnp.float32)
    rng = np.random.default_rng(0)
    for i in range(n):
        ids = rng.integers(1, 90, 20)
        embeds = jnp.pad(jllama.embed(jt, jnp.asarray(ids)), ((0, 44), (0, 0)))
        sample, cache = jdata_gen.generate_sample(jt, J_TCFG, embeds, len(ids), None, cache,
                                                  max_new_tokens=24, eos_token_id=999)
        jdata_gen.save_sample(str(tmp_path), i, sample)


def _metrics(path):
    return [json.loads(line) for line in open(path) if line.strip()]


@in_fresh_interpreter
def test_train_two_epochs_with_resume_matches_jax(tmp_path):
    jt, _ = _target()
    _write_dataset(tmp_path / "data", jt)
    jh, th = _head()
    jd, td = _draft()
    results = {}
    for side, mod, params, head in (("jax", jtrainer, jd, jh), ("port", ttrainer, td, th)):
        cp = str(tmp_path / side)
        for epochs in (1, 2):  # the second call resumes from state_0.pkl
            cfg = mod.TrainConfig(lr=LR, bs=2, num_epochs=epochs, max_len=64, mtp_steps=1,
                                  warmup_steps=2, total_steps=1000, max_images=1,
                                  max_span_bucket=8)
            mod.train(str(tmp_path / "data"), cp, J_DCFG if side == "jax" else T_DCFG,
                      head, cfg, dparams=params, log_every=1)
        assert os.path.exists(os.path.join(cp, "state_1.pkl"))
        results[side] = _metrics(os.path.join(cp, "metrics.jsonl"))
    want, got = results["jax"], results["port"]
    assert len(got) == len(want) == 6  # 2 steps + getkacc, each epoch
    for w, g in zip(want, got):
        assert set(w) == set(g)
        if "getkacc" in w:
            assert g["getkacc"] == w["getkacc"]
        else:
            assert abs(g["loss"] - w["loss"]) <= 1e-4 * max(abs(w["loss"]), 1.0), (g, w)

    # the port's state round-trips (numpy only, the JAX file names)
    epoch, params, opt = ttrainer.load_state(str(tmp_path / "port" / "state_1.pkl"),
                                             device=CPU)
    assert epoch == 1 and opt.count == 4
    ttrainer.save_state(str(tmp_path / "again"), 1, params, opt)
    _, params2, opt2 = ttrainer.load_state(str(tmp_path / "again" / "state_1.pkl"),
                                           device=CPU)
    for path in _leaf_paths(params):
        assert torch.equal(_at(params, path), _at(params2, path))
        assert torch.equal(_at(opt.mu, path), _at(opt2.mu, path))
        assert torch.equal(_at(opt.nu, path), _at(opt2.nu, path))


@in_fresh_interpreter
def test_refusals_of_the_parallel_layer(tmp_path, monkeypatch):
    _, th = _head()
    with pytest.raises(NotImplementedError, match="item 21b"):
        ttrainer.train(str(tmp_path), str(tmp_path / "cp"), T_DCFG, th,
                       ttrainer.TrainConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="item 21b"):
        ttrainer.train(str(tmp_path), str(tmp_path / "cp"), T_DCFG, th,
                       ttrainer.TrainConfig(ckpt_backend="orbax"))
    from vispec_tpu_torch.train import ge_data, main, main_medusa, main_mtp

    # the training CLIs refuse a mesh (item 21b); ge_data's --tp runs under
    # torchrun (tests/test_torch_parallel.py) and is a usage error in one process
    for mod, flag in ((main_mtp, "--dp"), (main_mtp, "--tp"), (main, "--sp"),
                      (main_medusa, "--dp"), (ge_data, "--tp")):
        argv = ["x", "--basepath", "b", "--configpath", "c", flag, "2"]
        if mod is main_medusa:
            argv = ["x", "--basepath", "b", flag, "2"]
        if mod is ge_data:
            argv = ["x", "--basepath", "b", "--dataset", "sharegpt", "--data-file", "f",
                    "--outdir", "o", flag, "2"]
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(SystemExit):
            mod.main()
    monkeypatch.setattr(sys, "argv", ["x", "--basepath", "b", "--configpath", "c",
                                      "--ckpt-backend", "orbax"])
    with pytest.raises(SystemExit):
        main_mtp.main()


# ---------------------------------------------------------------------------
# The CLIs on fabricated checkpoints
# ---------------------------------------------------------------------------


@in_fresh_interpreter
def test_training_clis_write_states(tmp_path, monkeypatch):
    pytest.importorskip("safetensors.numpy")
    from tests.test_from_pretrained import H, V, write_llama_ckpt
    from vispec_tpu_torch.train import main, main_medusa, main_mtp

    tdir = str(tmp_path / "t")
    write_llama_ckpt(tdir)
    dcfg = dict(vocab_size=V, hidden_size=H, intermediate_size=64, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, bias=True)
    cfg_path = str(tmp_path / "draft.json")
    json.dump(dcfg, open(cfg_path, "w"))
    rng = np.random.default_rng(0)
    for i in range(2):
        s = 24
        mask = np.zeros(s, np.float32)
        mask[8:] = 1
        tdata_gen.save_sample(str(tmp_path / "data"), i, {
            "input_ids": rng.integers(0, V, s).astype(np.int32),
            "hidden_state": rng.normal(0, 1, (s, H)).astype(np.float32),
            "inputs_embeds": rng.normal(0, 1, (s, H)).astype(np.float32),
            "loss_mask": mask, "image_mask": np.zeros(s, bool)})
    common = ["--tmpdir", str(tmp_path / "data"), "--max-len", "32", "--num-epochs", "1",
              "--device", "cpu"]
    for mod, extra, cp in ((main, ["--configpath", cfg_path], "s1"),
                           (main_mtp, ["--configpath", cfg_path, "--mtp-steps", "1"], "s2"),
                           (main_medusa, [], "med")):
        monkeypatch.setattr(sys, "argv", ["x", "--basepath", tdir, "--cpdir",
                                          str(tmp_path / cp)] + extra + common)
        mod.main()
        epoch, params, opt = ttrainer.load_state(str(tmp_path / cp / "state_0.pkl"),
                                                 device=CPU)
        assert epoch == 0 and opt.count == 2
    # stage 2 warm-starts from stage 1's state
    monkeypatch.setattr(sys, "argv", ["x", "--basepath", tdir, "--cpdir",
                                      str(tmp_path / "warm"), "--configpath", cfg_path,
                                      "--loadpath", str(tmp_path / "s1" / "state_0.pkl"),
                                      "--mtp-steps", "1"] + common)
    main_mtp.main()
    assert os.path.exists(tmp_path / "warm" / "state_0.pkl")


@in_fresh_interpreter
def test_ge_data_cli_sharegpt_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("safetensors.numpy")
    from tests.test_from_pretrained import write_llama_ckpt
    from tests.test_gen_answer_cli import _write_tokenizer
    from vispec_tpu.train import ge_data as jge_data
    from vispec_tpu_torch.train import ge_data as tge_data

    tdir = str(tmp_path / "t")
    write_llama_ckpt(tdir)
    _write_tokenizer(tdir)
    conv = {"conversations": [
        {"from": "human", "value": "write a story about robots"},
        {"from": "gpt", "value": "the robots make a story"},
        {"from": "human", "value": "make it shorter"},
        {"from": "gpt", "value": "robots story"}]}
    data_file = str(tmp_path / "sharegpt.json")
    json.dump([conv, conv, conv], open(data_file, "w"))
    outs = {}
    for side, mod, extra in (("jax", jge_data, []), ("port", tge_data, ["--device", "cpu"])):
        outs[side] = str(tmp_path / side)
        monkeypatch.setattr(sys, "argv", [
            "ge_data", "--basepath", tdir, "--dataset", "sharegpt", "--data-file", data_file,
            "--outdir", outs[side], "--max-len", "64", "--max-new-tokens", "16",
            "--shard-id", "0", "--num-shards", "2"] + extra)
        mod.main()
    files = sorted(f for f in os.listdir(outs["port"]) if f.endswith(".npz"))
    assert files == sorted(f for f in os.listdir(outs["jax"]) if f.endswith(".npz"))
    assert len(files) == 2
    import ml_dtypes

    for f in files:
        a = np.load(os.path.join(outs["jax"], f))
        b = np.load(os.path.join(outs["port"], f))
        for k in ("input_ids", "loss_mask", "image_mask"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b["loss_mask"].sum() > 0
        # both targets run in bf16: JAX saves bf16 (npz keeps it as void),
        # the port float32 copies of the bf16 values
        ah = a["hidden_state"].view(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_allclose(b["hidden_state"], ah, atol=5e-2, rtol=5e-2)
