"""The port's target forward and draft model against the JAX package on the
same weights and numpy inputs (float32, CPU).

Hidden states and K/V rows agree to 1e-4 abs (a full forward in float32,
other summation order); token ids, lengths and tree structure exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG, T_SPEC,
                                T_TCFG, make_models, t2n)
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops.attention import causal_mask as j_causal_mask
from vispec_tpu.ops.attention import tree_verify_mask as j_tree_verify_mask
from vispec_tpu_torch.models import draft as tdraft
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops.attention import causal_mask as t_causal_mask

ATOL = 1e-4
PAD = 64


@pytest.fixture(scope="module")
def models():
    return make_models(seed=0)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t2n(t), np.asarray(j), atol=atol, rtol=0)


def test_forward_hidden_prefill_then_region_verify(models):
    jt, _, tt, _ = models
    rng = np.random.default_rng(0)
    n_prompt, t = 20, 12
    ids = rng.integers(0, 256, size=PAD).astype(np.int32)
    jc = jkv.init_cache(3, 2, MAX_LEN, 16, jnp.float32)
    tc = tkv.init_cache(3, 2, MAX_LEN, 16, torch.float32, CPU)

    jh, jc = jllama.forward_hidden(jt, J_TCFG, jllama.embed(jt, jnp.asarray(ids)),
                                   jnp.arange(PAD, dtype=jnp.int32), jc,
                                   j_causal_mask(PAD, MAX_LEN, 0), seq_len=n_prompt)
    th, tc = tllama.forward_hidden(tt, T_TCFG, tllama.embed(tt, torch.from_numpy(ids)),
                                   torch.arange(PAD, dtype=torch.int32), tc,
                                   t_causal_mask(PAD, MAX_LEN, 0), seq_len=n_prompt)
    _close(th[:n_prompt], jh[:n_prompt])
    jc, tc = jkv.advance(jc, n_prompt), tkv.advance(tc, n_prompt)

    # a tree block: random ancestor closure, verified over the committed prefix
    tm = np.tril(rng.uniform(size=(t, t)) < 0.4)
    np.fill_diagonal(tm, True)
    tm[:, 0] = True
    depth = tm.sum(1).astype(np.int32) - 1
    tree_ids = rng.integers(0, 256, size=t).astype(np.int32)
    start = jc.length
    jh, jc, jnew = jllama.forward_hidden(
        jt, J_TCFG, jllama.embed(jt, jnp.asarray(tree_ids)), start + jnp.asarray(depth),
        jc, j_tree_verify_mask(jnp.asarray(tm), start, MAX_LEN),
        region=(start, jnp.asarray(tm)), return_new_kv=True, seq_len=start + t)
    th, tc, tnew = tllama.forward_hidden(
        tt, T_TCFG, tllama.embed(tt, torch.from_numpy(tree_ids)),
        tc.length + torch.from_numpy(depth), tc, None,
        region=(tc.length, torch.from_numpy(tm)), return_new_kv=True,
        seq_len=tc.length + t)
    _close(th, jh)
    _close(tnew[0], jnew[0])
    _close(tnew[1], jnew[1])
    _close(tc.k[:, :, :n_prompt + t], jc.k[:, :, :n_prompt + t])
    _close(tc.v[:, :, :n_prompt + t], jc.v[:, :, :n_prompt + t])
    _close(tllama.lm_head(tt, th), jllama.lm_head(jt, jh))


def _draft_after_prefill(jd, td, rng):
    """Compressed draft prefill over a prompt with two synthetic image spans
    (random embeds and target hiddens), on both sides."""
    seq_len = 30
    mask = np.zeros(seq_len, bool)
    mask[4:11] = True
    mask[15:19] = True
    hid = rng.normal(size=(PAD, 64)).astype(np.float32)
    emb = rng.normal(size=(PAD, 64)).astype(np.float32)
    jplan, jspan = jdraft.make_prefill_plan(mask, seq_len, 2, PAD, max_images=2,
                                            max_span=8)
    tplan, tspan = tdraft.make_prefill_plan(mask, seq_len, 2, PAD, max_images=2,
                                            max_span=8, device=CPU)
    assert tspan == jspan
    for name in jplan._fields:
        np.testing.assert_array_equal(t2n(getattr(tplan, name)),
                                      np.asarray(getattr(jplan, name)), err_msg=name)
    jout = jdraft.prefill(jd, J_DCFG, jnp.asarray(hid), jnp.asarray(emb), jplan,
                          jdraft.init_draft_cache(J_DCFG, MAX_LEN, jnp.float32), jspan)
    tout = tdraft.prefill(td, T_DCFG, torch.from_numpy(hid), torch.from_numpy(emb),
                          tplan, tdraft.init_draft_cache(T_DCFG, MAX_LEN, torch.float32,
                                                         CPU), tspan)
    return jout, tout


def _assert_same_cache(tc, jc, rows):
    assert int(tc.length) == int(jc.length)
    assert int(tc.real_length) == int(jc.real_length)
    _close(tc.k[:, :, :rows], jc.k[:, :, :rows])
    _close(tc.v[:, :, :rows], jc.v[:, :, :rows])


def test_draft_prefill_append_and_expand(models):
    jt, jd, tt, td = models
    rng = np.random.default_rng(1)
    (jlast, jimg, jc), (tlast, timg, tc) = _draft_after_prefill(jd, td, rng)
    _close(tlast, jlast)
    _close(timg, jimg)
    assert np.abs(np.asarray(jimg)).sum() > 0  # the second span's adapted token
    _assert_same_cache(tc, jc, int(jc.length))

    # accepted-token append: 3 valid rows of a padded block of 5
    acc_h = rng.normal(size=(5, 64)).astype(np.float32)
    acc_tok = rng.integers(0, 256, size=5).astype(np.int32)
    jfw = jdraft.decode_fuse_weights(jd, J_DCFG, jimg)
    tfw = tdraft.decode_fuse_weights(td, T_DCFG, timg)
    jseed, jc = jdraft.append_accepted(jd, J_DCFG, jnp.asarray(acc_h), jnp.asarray(acc_tok),
                                       jnp.asarray(3), jimg, jc, fuse_w=jfw)
    tseed, tc = tdraft.append_accepted(td, T_DCFG, torch.from_numpy(acc_h),
                                       torch.from_numpy(acc_tok), torch.tensor(3), timg,
                                       tc, fuse_w=tfw)
    _close(tseed, jseed)
    _assert_same_cache(tc, jc, int(jc.length))

    jtree, jc = jdraft.expand_tree(jd, J_DCFG, J_SPEC, jseed, jnp.asarray(5, jnp.int32),
                                   jimg, jt["lm_head"], jc, fuse_w=jfw)
    ttree, tc = tdraft.expand_tree(td, T_DCFG, T_SPEC, tseed,
                                   torch.tensor(5, dtype=torch.int32), timg,
                                   tt["lm_head"], tc, fuse_w=tfw)
    for name in ("tokens", "parent", "mask", "depth"):
        np.testing.assert_array_equal(t2n(getattr(ttree, name)),
                                      np.asarray(getattr(jtree, name)), err_msg=name)
    # the beam scratch rows past the committed length, written in place
    rows = int(jc.length) + J_SPEC.depth * J_SPEC.top_k
    _assert_same_cache(tc, jc, rows)


def test_unfolded_fuse_matches_jax(models):
    """The unfolded fc(img_fc(.)) fuse and its folded decode weights both
    agree with the JAX package's fuse."""
    _, jd, _, td = models
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(5, 64)).astype(np.float32)
    hid = rng.normal(size=(5, 64)).astype(np.float32)
    img = rng.normal(size=(64,)).astype(np.float32)
    _close(tdraft.fuse(td, torch.from_numpy(emb), torch.from_numpy(hid),
                       torch.from_numpy(img)),
           jdraft.fuse(jd, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(img)))
    we, wh, b = tdraft.decode_fuse_weights(td, T_DCFG, torch.from_numpy(img))
    _close(tdraft.fused_input(we, wh, b, torch.from_numpy(emb), torch.from_numpy(hid)),
           jdraft.fuse(jd, jnp.asarray(emb), jnp.asarray(hid), jnp.asarray(img)))
