"""The port's target forward and draft model against the JAX package on the
same weights and numpy inputs (float32, CPU).

Hidden states and K/V rows agree to 1e-4 abs (a full forward in float32,
other summation order); token ids, lengths and tree structure exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, GEOMETRY, J_DCFG, J_SPEC, J_TCFG, MAX_LEN, T_DCFG,
                                T_SPEC, T_TCFG, make_models, t2n, to_numpy_tree,
                                in_fresh_interpreter_module)
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops.attention import causal_mask as j_causal_mask
from vispec_tpu.ops.attention import tree_verify_mask as j_tree_verify_mask
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
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


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched_b3"])
def test_forward_hidden_plain_ids_on_mrope_config_match_jax(batched):
    """A config with ``mrope_section`` (a Qwen2.5-VL target) takes plain
    rotary embeddings for ordinary position ids, as the JAX package does for
    1-D ids: one request, and three slots whose ``[3, S]`` ids have the shape
    of one request's M-RoPE ids.  True M-RoPE ids (``mrope_ids=True``:
    ``[3, S]`` for one request, ``[B, 3, S]`` for three slots) match JAX's
    3-row forward."""
    b, t, max_len = 3, 12, 256
    cfg = dict(GEOMETRY["target"], num_hidden_layers=2, mrope_section=(2, 3, 3))
    jcfg, tcfg = JLlamaConfig(**cfg), tconfigs.LlamaConfig(**cfg)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = from_numpy(to_numpy_tree(jp), CPU)
    rng = np.random.default_rng(7)
    starts = np.asarray([40, 17, 90], np.int32)
    k0 = rng.normal(0, 1, (b, 2, 2, max_len, 16)).astype(np.float32)
    v0 = rng.normal(0, 1, (b, 2, 2, max_len, 16)).astype(np.float32)
    tokens = rng.integers(0, 128, (b, t)).astype(np.int32)
    tm = np.tril(rng.uniform(size=(b, t, t)) < 0.4)
    tm[:, np.arange(t), np.arange(t)] = True
    tm[:, :, 0] = True
    depth = (tm.sum(-1) - 1).astype(np.int32)

    def one(tok, cache, st, m, dep):
        return jllama.forward_hidden(jp, jcfg, jllama.embed(jp, tok), st + dep, cache,
                                     j_tree_verify_mask(m, st, max_len), region=(st, m),
                                     seq_len=st + t)

    def pick(x):  # slot 0 alone, or all three slots
        return x if batched else x[0]

    jcache = jkv.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(starts),
                         real_length=jnp.asarray(starts))
    jargs = (jnp.asarray(tokens), jcache, jnp.asarray(starts), jnp.asarray(tm),
             jnp.asarray(depth))
    if batched:
        jh, _ = jax.vmap(one)(*jargs)
    else:
        jh, _ = one(*(jax.tree.map(lambda x: x[0], a) for a in jargs))

    st = torch.as_tensor(pick(starts))
    tcache = tkv.KVCache(k=torch.from_numpy(pick(k0).copy()),
                         v=torch.from_numpy(pick(v0).copy()), length=st,
                         real_length=st.clone())
    pos = st[..., None] + torch.from_numpy(pick(depth))
    args = (tp, tcfg, tllama.embed(tp, torch.from_numpy(pick(tokens))), pos, tcache, None)
    th, _ = tllama.forward_hidden(*args, region=(st, torch.from_numpy(pick(tm))),
                                  seq_len=st + t)
    _close(th, jh)

    # three streams apart: t at the tree position, h and w elsewhere
    mpos = np.stack([starts[:, None] + depth, rng.integers(0, 200, (b, t)),
                     rng.integers(0, 200, (b, t))], 1).astype(np.int32)
    jmpos = jnp.asarray(mpos)

    def one_m(tok, cache, st, m, p3):
        return jllama.forward_hidden(jp, jcfg, jllama.embed(jp, tok), p3, cache,
                                     j_tree_verify_mask(m, st, max_len), region=(st, m),
                                     seq_len=st + t)

    if batched:
        jh, _ = jax.vmap(one_m)(*jargs[:4], jmpos)
    else:
        jh, _ = one_m(*(jax.tree.map(lambda x: x[0], a) for a in jargs[:4]), jmpos[0])
    th, _ = tllama.forward_hidden(*args[:3], torch.from_numpy(pick(mpos)), tcache, None,
                                  region=(st, torch.from_numpy(pick(tm))), seq_len=st + t,
                                  mrope_ids=True)
    _close(th, jh)


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
