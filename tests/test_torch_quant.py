"""The port's quantized serving mode against the JAX package on the CPU: the
bf16 product repair, the int8/int4 quantizers (bit-identical), the int4
product, the int8 KV cache and its attention, and the whole quantized
decode loop (token-identical), on the tests/test_quant_kv.py geometry.

Tolerances: quantized bytes and scales exactly; float32 products and
attention to 2e-4 (other summation order, as tests/test_quant_kv.py holds
the Pallas kernel); the int4 plain version against the JAX Pallas kernel to
tests/test_quant.py's rtol 2e-2 / atol 5e-3 (2e-2 for several groups): the
kernel scales each group's output, the plain version the weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.torch_parity import CPU, t2n, to_numpy_tree
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops import pallas_attention
from vispec_tpu.ops import quant as jquant
from vispec_tpu.ops.attention import causal_mask as j_causal_mask
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops import quant as tquant
from vispec_tpu_torch.ops import verify_attention as tva
from vispec_tpu_torch.ops.attention import causal_mask as t_causal_mask
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

GEOMETRY = dict(
    target=dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512),
    draft=dict(vocab_size=128, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512),
    spec=dict(total_tokens=12, depth=3, top_k=4),
)
J_T, J_D, J_S = (JLlamaConfig(**GEOMETRY["target"]), JDraftConfig(**GEOMETRY["draft"]),
                 JSpecConfig(**GEOMETRY["spec"]))
T_T, T_D, T_S = (tconfigs.LlamaConfig(**GEOMETRY["target"]),
                 tconfigs.DraftConfig(**GEOMETRY["draft"]),
                 tconfigs.SpecConfig(**GEOMETRY["spec"]))
MAX_LEN = 512
EOS = 10**6  # outside the vocab: generations run to their budget
TOL = dict(rtol=2e-4, atol=2e-4)


def _weights(seed=0):
    """(JAX tparams, JAX dparams, port tparams, port dparams), float32, the
    draft sharing the target's embedding as tests/test_quant_kv.py does."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = jllama.init_params(J_T, k1, jnp.float32)
    jd = jdraft.init_params(J_D, k2, jnp.float32)
    jd["embed"] = jt["embed"]
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jt, jd, tt, td


def _same(t, j):
    np.testing.assert_array_equal(t2n(t), np.asarray(j))


def _same_quant(t, j):
    """A port container equals a JAX one field by field, bit for bit."""
    if isinstance(j, jquant.QTensor):
        assert isinstance(t, tquant.QTensor)
        _same(t.q, j.q)
        _same(t.s, j.s)
    elif isinstance(j, jquant.Q4Tensor):
        assert isinstance(t, tquant.Q4Tensor)
        _same(t.packed, j.packed)
        _same(t.s, j.s)
    else:
        assert isinstance(t, torch.Tensor), type(t)
        np.testing.assert_array_equal(t2n(t.float()), np.asarray(j, np.float32))


# ------------------------------------------------------ repair: f32 products

def _bf16_row_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each row's largest magnitude (8 significant bits)."""
    top = np.abs(a).max(axis=-1, keepdims=True)
    return 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)


def test_bf16_swiglu_mlp_keeps_f32_products_like_jax():
    """gate and up stay f32 into silu(gate) * up, cast to bf16 once, as JAX
    does; rounding gate and up to bf16 first differed in 61% of elements."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (30, 512)).astype(np.float32)
    wg, wu = (rng.normal(0, 0.05, (512, 1376)).astype(np.float32) for _ in range(2))
    wd = rng.normal(0, 0.05, (1376, 512)).astype(np.float32)
    j = jllama.swiglu_mlp(*(jnp.asarray(a, jnp.bfloat16) for a in (x, wg, wu, wd)))
    t = tllama.swiglu_mlp(*(torch.from_numpy(a).bfloat16() for a in (x, wg, wu, wd)))
    assert t.dtype == torch.bfloat16
    t, j = t2n(t.float()), np.asarray(j).astype(np.float32)
    # bit-identical but where one inter element rounded the other way (f32
    # silu differs in the last bit), and then within one ulp at the row's
    # scale (a sum near zero moves by several of its own ulps)
    assert (t == j).mean() >= 0.99, (t == j).mean()
    assert (np.abs(t - j) <= _bf16_row_ulp(j)).all()


def test_bf16_lm_head_returns_unrounded_f32_logits_like_jax():
    """bf16 hidden x bf16 head -> f32 logits with no bf16 round in between:
    rounded logits tie and move the argmax."""
    rng = np.random.default_rng(1)
    h = rng.normal(0, 1, (64, 1024)).astype(np.float32)
    w = rng.normal(0, 0.02, (1024, 32000)).astype(np.float32)
    j = np.asarray(jllama.lm_head({"lm_head": jnp.asarray(w, jnp.bfloat16)},
                                  jnp.asarray(h, jnp.bfloat16)))
    t = tllama.lm_head({"lm_head": torch.from_numpy(w).bfloat16()},
                       torch.from_numpy(h).bfloat16())
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t2n(t), j, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t2n(t.argmax(-1)), j.argmax(-1))


# ---------------------------------------------------------------- quantizers

@pytest.mark.parametrize("shape,chunk", [((64, 96), 8192), ((3, 32, 48), 8192),
                                         ((64, 200), 64)])
def test_quantize_q8_bit_identical(shape, chunk):
    w = np.random.default_rng(2).normal(0, 0.02, shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column takes scale 1
    _same_quant(tquant.quantize_q8(torch.from_numpy(w), chunk_cols=chunk),
                jquant.quantize_q8(jnp.asarray(w), chunk_cols=chunk))


@pytest.mark.parametrize("shape,group,chunk", [((512, 1024), 128, 8192),
                                               ((512, 1024), 128, 192),
                                               ((96, 256), 128, 8192),
                                               ((768, 512), 128, 8192)])
def test_quantize_q4_bit_identical(shape, group, chunk):
    """Including the column-chunked path and the group-size shrink for
    K/2 = 48 (tests/test_quant.py:94)."""
    w = np.random.default_rng(3).normal(0, 0.05, shape).astype(np.float32)
    t = tquant.quantize_q4(torch.from_numpy(w), group_size=group, chunk_cols=chunk)
    j = jquant.quantize_q4(jnp.asarray(w), group_size=group, chunk_cols=chunk)
    _same_quant(t, j)
    np.testing.assert_array_equal(t2n(tquant.dequantize(t, torch.float32)),
                                  np.asarray(jquant.dequantize(j, jnp.float32)))


def test_quantize_rows_bit_identical():
    x = np.random.default_rng(4).normal(0, 1, (3, 2, 17, 8)).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row stays zero
    tq, ts = tkv.quantize_rows(torch.from_numpy(x))
    jq, js = jkv.quantize_rows(jnp.asarray(x))
    _same(tq, jq)
    _same(ts, js)
    _same(tkv.dequantize_rows(tq, ts), jkv.dequantize_rows(jq, js))


def _draft_layer_and_head(seed):
    rng = np.random.default_rng(seed)
    layer = {k: rng.normal(0, 1, (64, 64)).astype(np.float32)
             for k in ("wq", "wk", "wv", "wo")}
    layer["w_gate"] = rng.normal(0, 1, (64, 128)).astype(np.float32)
    layer["w_up"] = rng.normal(0, 1, (64, 128)).astype(np.float32)
    layer["w_down"] = rng.normal(0, 1, (128, 64)).astype(np.float32)
    heads = {n: rng.normal(0, 1, (64, n)).astype(np.float32) for n in (256, 129)}
    return layer, heads


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_head", "mixed", "auto"])
@pytest.mark.parametrize("vocab", [256, 129])  # 129: "auto"/"mixed" keep a bf16 head
def test_quantize_draft_params_matches_jax(mode, vocab):
    layer, heads = _draft_layer_and_head(5)
    jd = {"layer": {k: jnp.asarray(v) for k, v in layer.items()}, "embed": jnp.zeros((8, 64))}
    td = {"layer": {k: torch.from_numpy(v) for k, v in layer.items()},
          "embed": torch.zeros((8, 64))}
    jout = jquant.quantize_draft_params(jd, jnp.asarray(heads[vocab]), mode=mode)
    jchoices = dict(jquant.last_auto_choices)
    tout = tquant.quantize_draft_params(td, torch.from_numpy(heads[vocab]), mode=mode)
    assert tquant.last_auto_choices == jchoices
    assert sorted(tout) == sorted(jout) and sorted(tout["layer"]) == sorted(jout["layer"])
    for k in jout["layer"]:
        _same_quant(tout["layer"][k], jout["layer"][k])
    if "rank_head" in jout:
        _same_quant(tout["rank_head"], jout["rank_head"])
    assert not isinstance(td["layer"]["wq"], (tquant.QTensor, tquant.Q4Tensor))
    with pytest.raises(ValueError):
        tquant.quantize_draft_params(td, torch.from_numpy(heads[vocab]), mode="int2")


def test_quantize_target_params_layout_and_idempotence():
    jt, _, tt, _ = _weights(seed=3)
    jq = jquant.quantize_target_params(jt)
    tq = tquant.quantize_target_params(tt)
    assert sorted(tq) == sorted(jq) and sorted(tq["layers"]) == sorted(jq["layers"])
    for k in jquant._LAYER_QUANT_KEYS:
        assert tq["layers"][k].q.dtype == torch.int8
        _same_quant(tq["layers"][k], jq["layers"][k])
    _same_quant(tq["lm_head"], jq["lm_head"])
    assert tq["embed"] is tt["embed"]
    assert tq["layers"]["input_norm"] is tt["layers"]["input_norm"]
    assert not isinstance(tt["layers"]["wq"], tquant.QTensor)  # not mutated
    # in place, twice: the second call keeps the same containers
    tquant.quantize_target_params(tt, inplace=True)
    first = dict(tt["layers"]), tt["lm_head"]
    tquant.quantize_target_params(tt, inplace=True)
    assert all(tt["layers"][k] is first[0][k] for k in jquant._LAYER_QUANT_KEYS)
    assert tt["lm_head"] is first[1]
    with pytest.raises(ValueError):
        tquant.quantize_target_params(tt, mode="int4")
    # a layer-stacked QTensor slices into each layer's 2-D QTensor
    one = tt["layers"]["w_up"][1]
    _same_quant(one, jquant.QTensor(jq["layers"]["w_up"].q[1], jq["layers"]["w_up"].s[1]))


# -------------------------------------------------------------------- qdot4

@pytest.mark.parametrize("k,n,m,scale,atol", [(512, 1024, 8, 0.02, 5e-3),
                                              (768, 512, 8, 0.05, 2e-2),
                                              (512, 1024, 1, 0.02, 5e-3)])
def test_qdot4_plain_matches_jax_kernel_and_fallback(k, n, m, scale, atol):
    """The plain version against JAX's Pallas kernel in interpret mode and
    JAX's dequant + dot, at tests/test_quant.py's single- and multi-group
    geometries, with that file's tolerances for the kernel."""
    rng = np.random.default_rng(k + n + m)
    w = rng.normal(0, 1, (k, n)).astype(np.float32) * scale
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    jw = jquant.quantize_q4(jnp.asarray(w))
    jx = jnp.asarray(x, jnp.bfloat16)
    tw = tquant.quantize_q4(torch.from_numpy(w))
    tx = torch.from_numpy(x).bfloat16()
    assert tquant._q4_supports_kernel(m, tw)  # the wrapper's CPU branch
    before = tquant.q4_matmul.launches
    out = t2n(tquant.qdot4(tx, tw))
    assert tquant.q4_matmul.launches == before
    np.testing.assert_array_equal(out, t2n(tquant.qdot4_ref(tx, tw)))
    fallback = jnp.dot(jx, jquant._q4_dequant(jw), preferred_element_type=jnp.float32)
    np.testing.assert_allclose(out, np.asarray(fallback), rtol=1e-5, atol=1e-5)
    kernel = jquant._q4_matmul(jx, jw.packed, jw.s, interpret=True)
    np.testing.assert_allclose(out, np.asarray(kernel), rtol=2e-2, atol=atol)


def test_qdot_shapes_and_dispatch():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(0, 0.05, (20, 256)).astype(np.float32))
    w4, w8 = tquant.quantize_q4(w), tquant.quantize_q8(w)
    # group size 10 (K/2 = 10) is not a multiple of 8: dequantize + GEMM
    assert tuple(w4.shape) == (20, 256) and not tquant._q4_supports_kernel(4, w4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 20)).astype(np.float32))
    for wq in (w, w8, w4):
        assert tquant.qdot(x, wq).shape == (2, 3, 256)
        assert tquant.qdot(x[0, 0], wq).shape == (256,)
        assert tquant.qdot(x, wq, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    jx = jnp.asarray(x.numpy())
    for tq, jq in ((w8, jquant.quantize_q8(jnp.asarray(w.numpy()))),
                   (w4, jquant.quantize_q4(jnp.asarray(w.numpy())))):
        np.testing.assert_allclose(t2n(tquant.qdot(x, tq)), np.asarray(jquant.qdot(jx, jq)),
                                   rtol=1e-5, atol=1e-5)
    big_m = tquant.quantize_q4(torch.from_numpy(
        rng.normal(0, 0.05, (64, 128)).astype(np.float32)))
    assert tquant._q4_supports_kernel(64, big_m) and not tquant._q4_supports_kernel(65, big_m)


# ------------------------------------------------------- int8 KV attention

def _jax_int8_kernel(q, k8, v8, ks, vs, tm, start, layer=None):
    with pltpu.force_tpu_interpret_mode():
        out = pallas_attention.verify_attention(
            jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
            jnp.asarray(start, jnp.int32), jnp.asarray(tm), block=256,
            layer_idx=None if layer is None else jnp.asarray(layer, jnp.int32),
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    return np.asarray(out)


@pytest.mark.parametrize("hkv,groups,s,start,layers", [(2, 1, 8, 100, None),
                                                       (2, 2, 8, 500, None),
                                                       (2, 2, 8, 300, 3)])
def test_int8_verify_attention_plain_matches_jax_kernel(hkv, groups, s, start, layers):
    """The plain version over int8 K/V and per-row scales against the JAX
    Pallas kernel's quantized branch (interpret mode), 3-D and stacked 4-D
    caches (tests/test_quant_kv.py:68-97)."""
    rng = np.random.default_rng(7 + start)
    h, d, max_len = hkv * groups, 128, 1024 if layers is None else 512
    shape = (hkv, max_len, d) if layers is None else (layers, hkv, max_len, d)
    q = rng.normal(0, 1, (h, s, d)).astype(np.float32)
    k8, ks = (t2n(a) for a in tkv.quantize_rows(torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32))))
    v8, vs = (t2n(a) for a in tkv.quantize_rows(torch.from_numpy(
        rng.normal(0, 1, shape).astype(np.float32))))
    tm = np.tril(rng.uniform(size=(s, s)) < 0.5)
    np.fill_diagonal(tm, True)
    tm[:, 0] = True
    layer = None if layers is None else layers - 1
    before = tva.verify_attention.launches_int8
    out = t2n(tva.verify_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8),
        torch.tensor(start, dtype=torch.int32), torch.from_numpy(tm),
        None if layer is None else torch.tensor(layer, dtype=torch.int32),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)))
    assert tva.verify_attention.launches_int8 == before
    np.testing.assert_allclose(out, _jax_int8_kernel(q, k8, v8, ks, vs, tm, start, layer),
                               **TOL)


def test_int8_cache_layout_and_commit_requantizes_like_jax():
    """init_cache(quantized=True), and commit_from_blocks re-quantizing the
    accepted rows bit-identically to JAX (tests/test_quant_kv.py:100)."""
    c = tkv.init_cache(2, 3, 64, 8, device=CPU, quantized=True)
    assert c.k.dtype == torch.int8 and c.v.dtype == torch.int8
    assert c.k_scale.shape == (2, 3, 64) and c.k_scale.dtype == torch.float32
    assert tkv.init_cache(2, 3, 64, 8, device=CPU).k_scale is None

    rng = np.random.default_rng(2)
    bk = rng.normal(0, 1, (2, 2, 6, 8)).astype(np.float32)
    bv = rng.normal(0, 1, (2, 2, 6, 8)).astype(np.float32)
    nodes = np.asarray([0, 2, 5, 5], np.int32)
    jc = jkv.init_cache(2, 2, 64, 8, quantized=True)
    jc = jc._replace(length=jnp.asarray(10, jnp.int32), real_length=jnp.asarray(10, jnp.int32))
    jc = jkv.commit_from_blocks(jc, jnp.asarray(10, jnp.int32), jnp.asarray(bk),
                                jnp.asarray(bv), jnp.asarray(nodes), jnp.asarray(3, jnp.int32))
    tc = tkv.init_cache(2, 2, 64, 8, device=CPU, quantized=True)
    tc = tkv.advance(tc, 10)
    tc = tkv.commit_from_blocks(tc, tc.length, torch.from_numpy(bk), torch.from_numpy(bv),
                                torch.from_numpy(nodes), torch.tensor(3))
    for name in ("k", "v", "k_scale", "v_scale", "length", "real_length"):
        _same(getattr(tc, name), getattr(jc, name))


def test_forward_hidden_int8_weights_and_cache_match_jax():
    """A prefill and a region verify through int8 target weights over an
    int8 cache: hiddens and new K/V to 2e-4, cache bytes within one int8
    step (a pre-quantization value at a rounding edge), scales to 2e-4."""
    jt, _, tt, _ = _weights(seed=4)
    jt = jquant.quantize_target_params(jt)
    tt = tquant.quantize_target_params(tt)
    rng = np.random.default_rng(8)
    pad, n_prompt, t = 32, 20, 8
    ids = rng.integers(0, 128, size=pad).astype(np.int32)
    jc = jkv.init_cache(2, 2, 256, 16, quantized=True)
    tc = tkv.init_cache(2, 2, 256, 16, device=CPU, quantized=True)
    jh, jc = jllama.forward_hidden(jt, J_T, jllama.embed(jt, jnp.asarray(ids)),
                                   jnp.arange(pad, dtype=jnp.int32), jc,
                                   j_causal_mask(pad, 256, 0), seq_len=n_prompt)
    th, tc = tllama.forward_hidden(tt, T_T, tllama.embed(tt, torch.from_numpy(ids)),
                                   torch.arange(pad, dtype=torch.int32), tc,
                                   t_causal_mask(pad, 256, 0), seq_len=n_prompt)
    np.testing.assert_allclose(t2n(th[:n_prompt]), np.asarray(jh[:n_prompt]), **TOL)
    jc, tc = jkv.advance(jc, n_prompt), tkv.advance(tc, n_prompt)

    tm = np.tril(rng.uniform(size=(t, t)) < 0.4)
    np.fill_diagonal(tm, True)
    tm[:, 0] = True
    depth = tm.sum(1).astype(np.int32) - 1
    tree_ids = rng.integers(0, 128, size=t).astype(np.int32)
    jmask = np.zeros((t, 256), bool)
    jmask[:, :n_prompt] = True
    jmask[:, n_prompt:n_prompt + t] = tm
    jh, jc, jnew = jllama.forward_hidden(
        jt, J_T, jllama.embed(jt, jnp.asarray(tree_ids)), n_prompt + jnp.asarray(depth),
        jc, jnp.asarray(jmask), region=(jc.length, jnp.asarray(tm)), return_new_kv=True,
        seq_len=n_prompt + t)
    th, tc, tnew = tllama.forward_hidden(
        tt, T_T, tllama.embed(tt, torch.from_numpy(tree_ids)),
        tc.length + torch.from_numpy(depth), tc, None,
        region=(tc.length, torch.from_numpy(tm)), return_new_kv=True,
        seq_len=tc.length + t)
    np.testing.assert_allclose(t2n(th), np.asarray(jh), **TOL)
    for a, b in zip(tnew, jnew):
        np.testing.assert_allclose(t2n(a), np.asarray(b), **TOL)
    rows = n_prompt + t
    for name in ("k", "v"):
        diff = np.abs(t2n(getattr(tc, name))[:, :, :rows].astype(np.int32)
                      - np.asarray(getattr(jc, name))[:, :, :rows].astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, (name, diff.max())
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(t2n(getattr(tc, name))[:, :, :rows],
                                   np.asarray(getattr(jc, name))[:, :, :rows], **TOL)
    np.testing.assert_allclose(t2n(tllama.lm_head(tt, th)),
                               np.asarray(jllama.lm_head(jt, jh)), **TOL)


# ------------------------------------------------------------ the whole slice

def _apply(model, steps):
    for step in steps:
        if step == "target":
            model.quantize_target_inplace()
        else:
            model.quantize_draft_inplace(step)


@pytest.mark.parametrize("kv,steps", [
    (True, ()),  # tests/test_quant_kv.py:121
    (True, ("target", "int8")),  # tests/test_quant_kv.py:147
    (True, ("target", "int4")),
    (False, ("target", "int8")),  # draft after the target: its int8 head ranks
    (False, ("int8", "target")),  # draft before: its own ranking copy
], ids=["kv", "kv_target_draft8", "kv_target_draft4", "draft8_after_target",
        "draft8_before_target"])
def test_quantized_spec_equals_ar_and_jax(kv, steps):
    jt, jd, tt, td = _weights(seed=0)
    jmodel = JSpecModel(J_T, J_D, J_S, jt, jd, max_len=MAX_LEN, dtype=jnp.float32,
                        eos_token_id=EOS, quantize_kv=kv)
    tmodel = TSpecModel(T_T, T_D, T_S, tt, td, max_len=MAX_LEN, dtype=torch.float32,
                        eos_token_id=EOS, device=CPU, quantize_kv=kv)
    _apply(jmodel, steps)
    _apply(tmodel, steps)
    assert (tmodel.target_cache.k.dtype == torch.int8) == kv
    if steps == ("target", "int8"):  # ranks with the target's own int8 head
        assert tmodel.dparams["rank_head"] is tmodel.tparams["lm_head"]
    if "int4" in steps:
        assert isinstance(tmodel.dparams["fuse_we"], tquant.Q4Tensor)
    prompt = list(range(20, 52))
    jres = jmodel.specgenerate(prompt, max_new_tokens=16)
    tres = tmodel.specgenerate(prompt, max_new_tokens=16)
    ares = tmodel.ar_generate(prompt, max_new_tokens=16)
    assert tres.new_tokens == jres.new_tokens >= 16
    assert tres.sequences.tolist() == jres.sequences.tolist()
    assert tres.acceptance_lengths == jres.acceptance_lengths
    n = len(prompt) + 16
    assert tres.sequences[:n].tolist() == ares.sequences[:n].tolist()


def test_jax_quantized_weights_cross_the_bridge():
    """JAX-quantized pytrees (QTensor / Q4Tensor NamedTuples of arrays) cross
    through from_numpy into the port's containers, equal to the port's own
    quantization of the same weights; a leaf it cannot carry is refused."""
    jt, jd, tt, td = _weights(seed=2)
    jq = jquant.quantize_target_params(jt)
    jdq = jquant.quantize_draft_params(jd, jt["lm_head"], mode="int4")
    bridged_t = from_numpy(to_numpy_tree(jq), CPU)
    bridged_d = from_numpy(to_numpy_tree(jdq), CPU)
    own_t = tquant.quantize_target_params(tt)
    own_d = tquant.quantize_draft_params(td, tt["lm_head"], mode="int4")
    for k in jquant._LAYER_QUANT_KEYS:
        _same_quant(bridged_t["layers"][k], jq["layers"][k])
        _same_quant(own_t["layers"][k], jq["layers"][k])
        _same_quant(bridged_d["layer"][k], jdq["layer"][k])
        _same_quant(own_d["layer"][k], jdq["layer"][k])
    _same_quant(bridged_d["rank_head"], jdq["rank_head"])
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (5, 64)).astype(np.float32))
    for a, b in ((bridged_t["lm_head"], own_t["lm_head"]),
                 (bridged_d["rank_head"], own_d["rank_head"])):
        np.testing.assert_array_equal(t2n(tquant.qdot(x, a)), t2n(tquant.qdot(x, b)))
    # bf16 leaves keep their dtype; an unknown NamedTuple or object leaf is refused
    bf = from_numpy({"w": np.asarray(jnp.ones((2, 2), jnp.bfloat16))}, CPU)
    assert bf["w"].dtype == torch.bfloat16 and bf["w"].float().sum().item() == 4.0
    with pytest.raises(TypeError, match="only quantized weights"):
        from_numpy({"w": jkv.init_cache(1, 1, 4, 2)}, CPU)
    with pytest.raises(TypeError, match="not a numeric array"):
        from_numpy({"w": "weights.bin"}, CPU)
