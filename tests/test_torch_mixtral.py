"""The port's Mixtral target (models/mixtral.py) against the JAX package on
the same weights and numpy inputs, float32 on the CPU unless a test says
otherwise: the expert block within 1e-5 of its largest output, the decoder
stack (prefill, region verify, the int8 cache, the slot-stacked layout) to
1e-4 abs, and speculative, autoregressive, batched and engine tokens
exactly (tests/test_mixtral.py's oracles, on the tests/torch_parity.py
Mixtral fixture).

Each test runs in this module's child pytest process
(``tests.torch_parity.in_fresh_interpreter``), so its JAX compiles stay
out of the process that runs the rest of the suite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_quant import _bf16_row_ulp
from tests.torch_parity import (CPU, J_DCFG, J_SPEC, MAX_LEN, MIXTRAL_TARGET, T_DCFG,
                                T_SPEC, in_fresh_interpreter, mixtral_models, t2n,
                                to_numpy_tree)
from vispec_tpu.models import llama as jllama
from vispec_tpu.models import mixtral as jmixtral
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops.attention import causal_mask as j_causal_mask
from vispec_tpu.ops.attention import tree_verify_mask as j_tree_verify_mask
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.models import mixtral as tmixtral
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops.attention import causal_mask as t_causal_mask
from vispec_tpu_torch.ops.quant import quantize_target_params
from vispec_tpu_torch.spec import batch as tbatch
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

EOS = 999  # outside the vocab: generations run to their budget
PROMPTS = [list(range(30, 60)), list(range(5, 25)), list(range(100, 140))]
NEW = 16


@pytest.fixture(scope="module")
def models():
    return mixtral_models(seed=0)


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


@in_fresh_interpreter
def test_moe_block_matches_jax(models):
    """Routing (softmax, top-2 with ties to the lowest index, renormalised)
    and the dense expert sum; rows of one request and a [B, S] block."""
    jcfg, tcfg, jt, _, tt, _ = models
    x = np.random.default_rng(1).normal(size=(6, 64)).astype(np.float32)
    want = np.asarray(jmixtral.moe_block(jnp.asarray(x),
                                         jax.tree.map(lambda a: a[0], jt["layers"]), jcfg))
    got = tmixtral.moe_block(torch.from_numpy(x), _layer(tt), tcfg)
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    scale = np.abs(want).max()
    np.testing.assert_allclose(t2n(got), want, atol=1e-5 * scale, rtol=0)
    got_b = tmixtral.moe_block(torch.from_numpy(x.reshape(2, 3, 64)), _layer(tt), tcfg)
    np.testing.assert_allclose(t2n(got_b).reshape(6, 64), want, atol=1e-5 * scale, rtol=0)
    # the routing mixes experts: no expert takes every token
    probs = torch.softmax(torch.from_numpy(x) @ _layer(tt)["router"], -1)
    assert len(set(torch.argmax(probs, -1).tolist())) > 1


def _jax_moe_block_bf16(x, lp, cfg):
    """JAX's ``moe_block`` on bf16 operands, step for step.  The CPU backend
    has no bf16 x bf16 -> f32 einsum, so each product takes its bf16
    operands upcast to float32 (exact) and accumulates in float32, as
    ``preferred_element_type=jnp.float32`` does; the casts to bf16 stand
    where JAX's do (``inter`` and the result)."""
    f32 = jnp.float32
    probs = jax.nn.softmax(jnp.dot(x.astype(f32), lp["router"].astype(f32)), axis=-1)
    top_w, top_i = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    top_w = top_w / jnp.sum(top_w, axis=-1, keepdims=True)
    weights = jnp.zeros_like(probs).at[jnp.arange(x.shape[0])[:, None], top_i].set(top_w)
    gate = jnp.einsum("sd,edi->sei", x.astype(f32), lp["we_gate"].astype(f32))
    up = jnp.einsum("sd,edi->sei", x.astype(f32), lp["we_up"].astype(f32))
    inter = (jax.nn.silu(gate) * up).astype(x.dtype)
    out = jnp.einsum("sei,eid->sed", inter.astype(f32), lp["we_down"].astype(f32))
    return jnp.einsum("sed,se->sd", out, weights).astype(x.dtype)


@in_fresh_interpreter
def test_bf16_moe_block_keeps_f32_products_like_jax():
    """bf16 weights and activations: gate, up and each expert's down product
    stay float32, the float32 routing weights apply before the one cast, as
    in JAX (within one bf16 step at the row's scale)."""
    rng = np.random.default_rng(2)
    e, d, i = 4, 256, 344
    cfg = dict(MIXTRAL_TARGET, hidden_size=d, intermediate_size=i)
    x = rng.normal(0, 1, (30, d)).astype(np.float32)
    lp = {"router": rng.normal(0, 0.3, (d, e)), "we_gate": rng.normal(0, 0.05, (e, d, i)),
          "we_up": rng.normal(0, 0.05, (e, d, i)), "we_down": rng.normal(0, 0.05, (e, i, d))}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    j = _jax_moe_block_bf16(jnp.asarray(x, jnp.bfloat16),
                            {k: jnp.asarray(v, jnp.bfloat16) for k, v in lp.items()},
                            jmixtral.MixtralConfig(**cfg))
    tlp = from_numpy({k: v[None] for k, v in lp.items()}, CPU, torch.bfloat16)
    t = tmixtral.moe_block(torch.from_numpy(x).bfloat16(), {k: v[0] for k, v in tlp.items()},
                           tmixtral.MixtralConfig(**cfg))
    assert t.dtype == torch.bfloat16
    t, j = t2n(t.float()), np.asarray(j).astype(np.float32)
    assert (t == j).mean() >= 0.99, (t == j).mean()
    assert (np.abs(t - j) <= _bf16_row_ulp(j)).all()


def _tree(rng, t):
    tm = np.tril(rng.uniform(size=(t, t)) < 0.4)
    np.fill_diagonal(tm, True)
    tm[:, 0] = True
    return tm, tm.sum(1).astype(np.int32) - 1


@in_fresh_interpreter
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16_free", "int8_kv"])
def test_forward_hidden_prefill_then_region_verify(models, quantized):
    """A prompt prefill, then a tree verify through the region (the verify
    kernel's plain version), over a float32 or an int8 cache."""
    jcfg, tcfg, jt, _, tt, _ = models
    rng = np.random.default_rng(3)
    pad, n_prompt, t = 64, 20, 12
    ids = rng.integers(0, 256, size=pad).astype(np.int32)
    jc = jkv.init_cache(2, 2, MAX_LEN, 16, jnp.float32, quantized=quantized)
    tc = tkv.init_cache(2, 2, MAX_LEN, 16, torch.float32, CPU, quantized=quantized)
    jh, jc = jmixtral.forward_hidden(jt, jcfg, jllama.embed(jt, jnp.asarray(ids)),
                                     jnp.arange(pad, dtype=jnp.int32), jc,
                                     j_causal_mask(pad, MAX_LEN, 0), seq_len=n_prompt)
    th, tc = tmixtral.forward_hidden(tt, tcfg, tllama.embed(tt, torch.from_numpy(ids)),
                                     torch.arange(pad, dtype=torch.int32), tc,
                                     t_causal_mask(pad, MAX_LEN, 0), seq_len=n_prompt)
    np.testing.assert_allclose(t2n(th[:n_prompt]), np.asarray(jh[:n_prompt]), atol=1e-4)
    jc, tc = jkv.advance(jc, n_prompt), tkv.advance(tc, n_prompt)

    tm, depth = _tree(rng, t)
    tree_ids = rng.integers(0, 256, size=t).astype(np.int32)
    start = jc.length
    jh, jc, jnew = jmixtral.forward_hidden(
        jt, jcfg, jllama.embed(jt, jnp.asarray(tree_ids)), start + jnp.asarray(depth), jc,
        j_tree_verify_mask(jnp.asarray(tm), start, MAX_LEN), region=(start, jnp.asarray(tm)),
        return_new_kv=True, seq_len=start + t)
    th, tc, tnew = tmixtral.forward_hidden(
        tt, tcfg, tllama.embed(tt, torch.from_numpy(tree_ids)),
        tc.length + torch.from_numpy(depth), tc, None, region=(tc.length, torch.from_numpy(tm)),
        return_new_kv=True, seq_len=tc.length + t)
    np.testing.assert_allclose(t2n(th), np.asarray(jh), atol=1e-4)
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(t2n(a), np.asarray(b), atol=1e-4)
    rows = n_prompt + t
    if quantized:  # the int8 rows may round one step apart: compare dequantized
        np.testing.assert_allclose(
            t2n(tkv.dequantize_rows(tc.k[:, :, :rows], tc.k_scale[:, :, :rows],
                                    torch.float32)),
            np.asarray(jkv.dequantize_rows(jc.k[:, :, :rows], jc.k_scale[:, :, :rows],
                                           jnp.float32)), atol=2e-2)
    else:
        np.testing.assert_allclose(t2n(tc.k[:, :, :rows]), np.asarray(jc.k[:, :, :rows]),
                                   atol=1e-4)


@in_fresh_interpreter
def test_forward_hidden_slot_stacked_matches_jax_vmap(models):
    """Three slots at their own starts through the batched region (the
    engine's layout: the MoE flattens [B, S] tokens) against jax.vmap."""
    jcfg, tcfg, jt, _, tt, _ = models
    rng = np.random.default_rng(4)
    b, t = 3, 12
    starts = np.asarray([40, 17, 90], np.int32)
    k0 = rng.normal(0, 1, (b, 2, 2, MAX_LEN, 16)).astype(np.float32)
    v0 = rng.normal(0, 1, (b, 2, 2, MAX_LEN, 16)).astype(np.float32)
    tokens = rng.integers(0, 256, (b, t)).astype(np.int32)
    trees = [_tree(rng, t) for _ in range(b)]
    tm = np.stack([m for m, _ in trees])
    depth = np.stack([d for _, d in trees])

    def one(tok, cache, st, m, dep):
        return jmixtral.forward_hidden(jt, jcfg, jllama.embed(jt, tok), st + dep, cache,
                                       j_tree_verify_mask(m, st, MAX_LEN), region=(st, m),
                                       seq_len=st + t)

    jcache = jkv.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.asarray(starts),
                         real_length=jnp.asarray(starts))
    jh, _ = jax.vmap(one)(jnp.asarray(tokens), jcache, jnp.asarray(starts), jnp.asarray(tm),
                          jnp.asarray(depth))
    st = torch.from_numpy(starts)
    tcache = tkv.KVCache(k=torch.from_numpy(k0), v=torch.from_numpy(v0), length=st,
                         real_length=st.clone())
    th, _ = tmixtral.forward_hidden(tt, tcfg, tllama.embed(tt, torch.from_numpy(tokens)),
                                    st[:, None] + torch.from_numpy(depth), tcache, None,
                                    region=(st, torch.from_numpy(tm)), seq_len=st + t)
    np.testing.assert_allclose(t2n(th), np.asarray(jh), atol=1e-4)


@in_fresh_interpreter
@pytest.mark.parametrize("mode", [{}, {"quantize_kv": True}, {"quantize_draft": "int4"},
                                  {"quantize_draft": "int8", "quantize_kv": True}],
                         ids=["f32", "int8_kv", "int4_draft", "int8_draft_int8_kv"])
def test_mixtral_spec_matches_jax_and_ar(models, mode):
    """Greedy spec == the JAX package's spec == the port's AR, token for
    token (tests/test_mixtral.py::test_mixtral_spec_losslessness), also over
    the int8 cache and with a quantized draft."""
    jcfg, tcfg, jt, jd, tt, td = models
    jmodel = JSpecModel(jcfg, J_DCFG, J_SPEC, jt, jd, max_len=MAX_LEN, dtype=jnp.float32,
                        eos_token_id=EOS, **mode)
    tmodel = TSpecModel(tcfg, T_DCFG, T_SPEC, tt, dict(td), max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU, **mode)
    prompt = PROMPTS[0]
    want = jmodel.specgenerate(prompt, max_new_tokens=NEW).sequences
    got = tmodel.specgenerate(prompt, max_new_tokens=NEW).sequences
    ar = tmodel.ar_generate(prompt, max_new_tokens=NEW).sequences
    np.testing.assert_array_equal(got, want)
    n = len(prompt) + NEW
    np.testing.assert_array_equal(got[:n], ar[:n])
    assert len(set(got[len(prompt):].tolist())) > 4  # not one repeated token


@in_fresh_interpreter
def test_mixtral_batch_and_engine_match_single(models):
    """specgenerate_batch, generate_batch and a B = 2 engine over three
    requests equal per-request specgenerate."""
    jcfg, tcfg, jt, jd, tt, td = models
    tmodel = TSpecModel(tcfg, T_DCFG, T_SPEC, tt, dict(td), max_len=MAX_LEN,
                        dtype=torch.float32, eos_token_id=EOS, device=CPU)
    single = [tmodel.specgenerate(p, max_new_tokens=NEW).sequences[len(p):len(p) + NEW]
              for p in PROMPTS]
    batch = tmodel.specgenerate_batch([{"input_ids": p} for p in PROMPTS],
                                      max_new_tokens=NEW)
    for r, p, s in zip(batch, PROMPTS, single):
        np.testing.assert_array_equal(r.sequences[len(p):], s)
    outs = tbatch.generate_batch(tt, tmodel.dparams, tcfg, T_DCFG, T_SPEC, PROMPTS,
                                 max_new_tokens=NEW, max_len=MAX_LEN, eos_id=EOS,
                                 dtype=torch.float32, device=CPU)
    for o, s in zip(outs, single):
        np.testing.assert_array_equal(o[:NEW], s)
    eng = ServingEngine(tmodel, batch_size=2, max_new_tokens=NEW, chunk_rounds=4)
    for o, s in zip(eng.run_all(PROMPTS), single):
        np.testing.assert_array_equal(np.asarray(o)[:NEW], s)


@in_fresh_interpreter
def test_int8_target_quantization_is_refused_like_jax(models):
    _, _, jt, _, tt, _ = models
    from vispec_tpu.ops.quant import quantize_target_params as jquantize

    with pytest.raises(NotImplementedError):
        jquantize(jax.tree.map(jnp.asarray, to_numpy_tree(jt)))
    with pytest.raises(NotImplementedError):
        quantize_target_params(tt)
