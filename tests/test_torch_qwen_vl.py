"""The port's Qwen2.5-VL modules against the JAX package on the same numpy
inputs and weights, float32, on the CPU: the host plans equal exactly, the
M-RoPE tables within 1e-6, the windowed ViT (the tiny tower of
tests/test_vision.py) and the M-RoPE decoder stack within 1e-5, the bicubic
resize at Qwen's sizes within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vision import QCFG as J_QCFG
from tests.torch_parity import (CPU, QWEN_TARGET, qwen_vision_tree, t2n,
                                to_numpy_tree, in_fresh_interpreter_module)
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.models import llama as jllama
from vispec_tpu.models import qwen2_5_vl as jqwen
from vispec_tpu.ops import kv_cache as jkv
from vispec_tpu.ops import rope as jrope
from vispec_tpu.ops.attention import causal_mask as j_causal_mask
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import llama as tllama
from vispec_tpu_torch.models import llava as tllava
from vispec_tpu_torch.models import qwen2_5_vl as tqwen
from vispec_tpu_torch.ops import kv_cache as tkv
from vispec_tpu_torch.ops import rope as trope
from vispec_tpu_torch.ops.attention import causal_mask as t_causal_mask

T_QCFG = tqwen.QwenVisionConfig(
    **{f: getattr(J_QCFG, f) for f in J_QCFG.__dataclass_fields__})
IMG, VID, VSTART = 9, 10, 8

# grids (t, h, w) in patches: one window, several windows with ragged
# edges, two temporal groups, and a list of three grids in one pass
GRIDS = [[(1, 4, 4)], [(1, 8, 12)], [(1, 10, 6)], [(2, 4, 6)],
         [(1, 8, 12), (1, 4, 6), (2, 6, 4)]]


@pytest.fixture(scope="module")
def tower():
    jv = qwen_vision_tree(J_QCFG, jax.random.PRNGKey(3))
    return jv, from_numpy(to_numpy_tree(jv), CPU)


def _pixels(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("grids", GRIDS, ids=lambda g: "+".join("x".join(map(str, x))
                                                               for x in g))
def test_plan_vision_equals_jax(grids):
    n = sum(t * h * w for t, h, w in grids)
    pad = -(-n // 64) * 64 + 64  # a padded tail as well
    jp, tp = jqwen.plan_vision(grids, J_QCFG, pad), tqwen.plan_vision(grids, T_QCFG, pad)
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)


def test_rope_index_and_smart_resize_equal_jax():
    """Images, a video with fractional seconds per grid (truncated to int,
    as JAX truncates), a text-only prompt; smart_resize over upscale,
    downscale, min- and max-budget cases."""
    ids = np.asarray([1, 2, 3, VSTART] + [IMG] * 6 + [4, 5, VSTART] + [IMG] * 6 + [6, 7])
    cases = [
        (ids, [(1, 4, 6), (1, 6, 4)], ()),
        (np.asarray([1, VSTART] + [VID] * 12 + [4, 5]), [(2, 4, 6)], [0.7]),
        (np.asarray([1, VSTART] + [VID] * 18 + [4]), [(3, 4, 6)], [1.5]),
        (np.arange(11, 30), [], ()),
    ]
    for tokens, grids, spg in cases:
        jpos, jdelta = jqwen.get_rope_index_host(tokens, grids, J_QCFG, IMG, VID, VSTART,
                                                 second_per_grid_ts=spg)
        tpos, tdelta = tqwen.get_rope_index_host(tokens, grids, T_QCFG, IMG, VID, VSTART,
                                                 second_per_grid_ts=spg)
        np.testing.assert_array_equal(tpos, jpos)
        assert tdelta == jdelta
    for h, w in ((100, 130), (150, 90), (200, 260), (1023, 767), (30, 40), (448, 448),
                 (896, 1120), (1080, 1920)):
        for budget in ((56 * 56, 28 * 28 * 25), (256 * 28 * 28, 1280 * 28 * 28)):
            assert tqwen.smart_resize(h, w, 28, *budget) == \
                jqwen.smart_resize(h, w, 28, *budget)
    with pytest.raises(ValueError, match="aspect ratio"):
        tqwen.smart_resize(10, 3000)


def test_patchify_image_and_video_equal_jax():
    img = _pixels((56, 84, 3), 0)
    np.testing.assert_array_equal(
        t2n(tqwen.patchify_image(torch.from_numpy(img), T_QCFG)),
        np.asarray(jqwen.patchify_image(jnp.asarray(img), J_QCFG)))
    for t in (4, 3):  # an odd count repeats the last frame
        frames = _pixels((t, 56, 84, 3), t)
        np.testing.assert_array_equal(
            t2n(tqwen.patchify_video(torch.from_numpy(frames), T_QCFG)),
            np.asarray(jqwen.patchify_video(jnp.asarray(frames), J_QCFG)))


def test_mrope_cos_sin_matches_jax():
    """(2, 2, 2) over head_dim 16 (two slots clip to the w stream) and
    Qwen2.5-VL-7B's (16, 24, 24) over 128; one request and a slot dim."""
    rng = np.random.default_rng(2)
    for head_dim, section in ((16, (2, 2, 2)), (128, (16, 24, 24))):
        pos = rng.integers(0, 3000, (3, 37)).astype(np.int32)
        jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), head_dim, section, 1e6)
        tc, ts = trope.mrope_cos_sin(torch.from_numpy(pos), head_dim, section, 1e6)
        np.testing.assert_allclose(t2n(tc), np.asarray(jc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t2n(ts), np.asarray(js), rtol=0, atol=1e-6)
        bc, bs = trope.mrope_cos_sin(torch.from_numpy(np.stack([pos, pos[:, ::-1]])),
                                     head_dim, section, 1e6)
        np.testing.assert_array_equal(t2n(bc[0]), t2n(tc))
        np.testing.assert_array_equal(t2n(bs[0]), t2n(ts))


@pytest.mark.parametrize("grids", GRIDS[1:], ids=["8x12", "10x6", "video_2x4x6", "three"])
def test_vision_forward_matches_jax(tower, grids):
    """The windowed ViT (windowed blocks 0 and 2, full attention at 1),
    merger and inverse permutation, over padded patches."""
    jv, tv = tower
    n = sum(t * h * w for t, h, w in grids)
    pad = -(-n // 64) * 64
    patches = np.random.default_rng(n).normal(0, 1, (pad, 3 * 2 * 14 * 14))
    patches = patches.astype(np.float32)
    plan = jqwen.plan_vision(grids, J_QCFG, pad)
    want = np.asarray(jqwen.forward(jv, J_QCFG, jnp.asarray(patches), plan))
    got = t2n(tqwen.forward(tv, T_QCFG, torch.from_numpy(patches),
                            tqwen.plan_vision(grids, T_QCFG, pad)))
    assert got.shape == want.shape == (pad // 4, J_QCFG.out_hidden_size)
    m = plan.n_merged
    np.testing.assert_allclose(got[:m], want[:m], rtol=0, atol=1e-5)


def test_vision_forward_keeps_jax_dtypes_in_bf16(tower):
    """bf16 weights: ``from_numpy`` keeps ``norm1`` / ``norm2`` / ``ln_q`` in
    float32, as the JAX tree holds them; the tower's output is bf16 and
    close to JAX's bf16 run."""
    jv, _ = tower
    tv16 = from_numpy(to_numpy_tree(jv), CPU, torch.bfloat16)
    assert tv16["blocks"]["norm1"].dtype == tv16["merger"]["ln_q"].dtype == torch.float32
    assert tv16["blocks"]["wqkv"].dtype == tv16["merger"]["b2"].dtype == torch.bfloat16
    jb = jax.tree_util.tree_map_with_path(
        lambda path, x: x.astype(jnp.float32 if path[-1].key in ("norm1", "norm2", "ln_q")
                                 else jnp.bfloat16), jv)
    grids = [(1, 8, 12)]
    patches = np.random.default_rng(0).normal(0, 1, (128, 3 * 2 * 14 * 14))
    patches = patches.astype(np.float32)
    want = jqwen.forward(jb, J_QCFG, jnp.asarray(patches),
                         jqwen.plan_vision(grids, J_QCFG, 128))
    got = tqwen.forward(tv16, T_QCFG, torch.from_numpy(patches),
                        tqwen.plan_vision(grids, T_QCFG, 128))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(t2n(got.float())[:24], np.asarray(want, np.float32)[:24],
                               rtol=0, atol=2e-2)


def test_forward_hidden_on_mrope_ids_matches_jax():
    """The Qwen2.5-VL text backbone (qkv bias, sections (2, 2, 2)) over a
    prefill of 3-row ids with the three streams apart: hidden states and
    the cache rows within 1e-5."""
    jcfg, tcfg = JLlamaConfig(**QWEN_TARGET), tconfigs.LlamaConfig(**QWEN_TARGET)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(6), jnp.float32)
    for i, b in enumerate(("bq", "bk", "bv")):
        jp["layers"][b] = 0.1 * jax.random.normal(jax.random.PRNGKey(10 + i),
                                                  jp["layers"][b].shape)
    tp = from_numpy(to_numpy_tree(jp), CPU)
    s, max_len = 64, 128
    ids = np.asarray([1, 2, VSTART] + [IMG] * 24 + list(range(30, 67)))
    pos, _ = jqwen.get_rope_index_host(ids, [(1, 8, 12)], J_QCFG, IMG, VID, VSTART)
    assert len(set(map(tuple, pos.T))) == s and not (pos[1] == pos[2]).all()
    emb = np.random.default_rng(5).normal(0, 1, (s, jcfg.hidden_size)).astype(np.float32)
    jcache = jkv.init_cache(jcfg.num_hidden_layers, jcfg.num_key_value_heads, max_len,
                            jcfg.head_dim, jnp.float32)
    jh, jc = jllama.forward_hidden(jp, jcfg, jnp.asarray(emb), jnp.asarray(pos, jnp.int32),
                                   jcache, j_causal_mask(s, max_len, 0))
    tcache = tkv.init_cache(tcfg.num_hidden_layers, tcfg.num_key_value_heads, max_len,
                            tcfg.head_dim, torch.float32, CPU)
    th, tc = tllama.forward_hidden(tp, tcfg, torch.from_numpy(emb),
                                   torch.from_numpy(pos.astype(np.int32)), tcache,
                                   t_causal_mask(s, max_len, 0), mrope_ids=True)
    np.testing.assert_allclose(t2n(th), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t2n(tc.k), np.asarray(jc.k), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="mrope_section"):
        tllama.forward_hidden(tp, tconfigs.LlamaConfig(**dict(QWEN_TARGET,
                                                              mrope_section=None)),
                              torch.from_numpy(emb), torch.from_numpy(pos), tcache,
                              t_causal_mask(s, max_len, 0), mrope_ids=True)


@pytest.mark.parametrize("src,dst", [((100, 130), (112, 140)), ((150, 90), (140, 84)),
                                     ((200, 260), (112, 140)), ((60, 90), (56, 84))],
                         ids=["up", "down", "down_budget", "mixed"])
def test_bicubic_resize_at_qwen_sizes_matches_jax(src, dst):
    """The port's resize against ``jax.image.resize(..., "bicubic")`` at
    non-square sizes, one image and a stack of video frames."""
    img = _pixels((*src, 3), sum(src))
    want = jax.image.resize(jnp.asarray(img), (*dst, 3), method="bicubic")
    got = tllava.resize_image(torch.from_numpy(img), *dst)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=1e-5)
    frames = _pixels((3, *src, 3), 7)
    want = jax.image.resize(jnp.asarray(frames), (3, *dst, 3), method="bicubic")
    got = tllava.resize_image(torch.from_numpy(frames), *dst)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=1e-5)


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
