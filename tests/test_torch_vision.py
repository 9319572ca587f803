"""The port's LLaVA vision modules (models/clip_vit.py, models/llava.py)
against the JAX package's, on the tests/test_vision.py toy geometry: the
same numpy weights and pixels on both sides, on the CPU.

Tolerances: float32 1e-5 abs; bfloat16 2^-6 of the output's largest
magnitude (two bf16 steps: XLA and torch sum in other orders).  Plans and
gather indices are integers and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import (CPU, J_TCFG, J_VCFG, T_VCFG, llava_cfgs, to_numpy_tree,
                                vision_params, in_fresh_interpreter_module)
from vispec_tpu.models import clip_vit as jclip
from vispec_tpu.models import llava as jllava
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import clip_vit as tclip
from vispec_tpu_torch.models import llava as tllava

F32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -6


def image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


def t2n(x):
    return x.detach().float().cpu().numpy()


@pytest.mark.parametrize("src,dst", [((40, 40), (56, 56)), ((100, 200), (56, 56)),
                                     ((100, 200), (28, 112)), ((33, 17), (56, 70))],
                         ids=["up", "down", "non_square", "up_non_square"])
def test_resize_image_matches_jax(src, dst):
    img = image(*src)
    want = np.asarray(jllava.resize_image(jnp.asarray(img), *dst))
    got = t2n(tllava.resize_image(torch.from_numpy(img), *dst))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


GOLDEN_PINPOINTS = ((28, 56), (56, 28), (56, 56))  # tests/test_vision_golden.py


@pytest.mark.parametrize("size", [(40, 40), (30, 55), (56, 28), (100, 33), (28, 90),
                                  (100, 200), (480, 640), (672, 672)])
def test_plan_anyres_matches_jax(size):
    """Gather indices bit-equal on the toy, the tests/test_vision_golden.py
    and the published LLaVA-1.6 configurations."""
    jdefault = jllava.LlavaConfig(text=None, vision=jclip.ClipVisionConfig())
    tdefault = tllava.LlavaConfig(text=None, vision=tclip.ClipVisionConfig())
    golden = [cfg.LlavaConfig(text=None, vision=clip.ClipVisionConfig(image_size=28),
                              image_grid_pinpoints=GOLDEN_PINPOINTS)
              for cfg, clip in ((jllava, jclip), (tllava, tclip))]
    for jcfg, tcfg in (llava_cfgs(), golden, (jdefault, tdefault)):
        want = jllava.plan_anyres(*size, jcfg)
        got = tllava.plan_anyres(*size, tcfg)
        assert tllava.select_best_resolution(*size, tcfg.image_grid_pinpoints) == \
            jllava.select_best_resolution(*size, jcfg.image_grid_pinpoints)
        for name in ("grid_h", "grid_w", "n_tokens", "target_h", "target_w"):
            assert getattr(got, name) == getattr(want, name), name
        assert got.gather_idx.dtype == want.gather_idx.dtype
        np.testing.assert_array_equal(got.gather_idx, want.gather_idx)
    if size == (480, 640):
        assert tllava.plan_anyres(*size, tdefault).n_tokens == 2340
    if size == (672, 672):
        assert tllava.plan_anyres(*size, tdefault).n_tokens == 2928


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_forward_matches_jax(dtype):
    """Three tiles through the tower in one call against the JAX forward,
    tile by tile."""
    jparams, tparams = vision_params(getattr(jnp, dtype))
    tiles = np.stack([image(56, 56, s) * 2 - 1 for s in range(3)])
    want = np.stack([np.asarray(jclip.forward(jparams["vision"], J_VCFG,
                                              jnp.asarray(t)).astype(jnp.float32))
                     for t in tiles])
    got_t = tclip.forward(tparams["vision"], T_VCFG, torch.from_numpy(tiles))
    assert got_t.dtype == getattr(torch, dtype)
    got = t2n(got_t)
    assert got.shape == (3, 1 + T_VCFG.num_patches, T_VCFG.hidden_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("anyres", [True, False], ids=["anyres", "llava15"])
def test_encode_image_matches_jax(anyres):
    """preprocess_anyres (or LLaVA-1.5's square resize) and encode_image."""
    jcfg, tcfg = llava_cfgs(anyres)
    jparams, tparams = vision_params()
    img = image(100, 200, seed=3)
    if anyres:
        jplan = jllava.plan_anyres(100, 200, jcfg)
        tplan = tllava.plan_anyres(100, 200, tcfg)
        jtiles = jllava.preprocess_anyres(jnp.asarray(img), jplan, jcfg)
        ttiles = tllava.preprocess_anyres(torch.from_numpy(img), tplan, tcfg)
        assert ttiles.shape[0] == 1 + tplan.grid_h * tplan.grid_w > 1
    else:
        jplan = tplan = None
        jtiles = jllava.normalize(jllava.resize_image(jnp.asarray(img), 56, 56))[None]
        ttiles = tllava.normalize(tllava.resize_image(torch.from_numpy(img), 56, 56))[None]
    np.testing.assert_allclose(t2n(ttiles), np.asarray(jtiles), rtol=0, atol=F32_TOL)
    want = np.asarray(jllava.encode_image(jparams, jcfg, jtiles, jplan))
    got = t2n(tllava.encode_image(tparams, tcfg, ttiles, tplan))
    assert got.shape == want.shape == (
        jplan.n_tokens if anyres else J_VCFG.num_patches, J_TCFG.hidden_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


def test_merge_image_embeds_matches_jax():
    rng = np.random.default_rng(5)
    text = rng.standard_normal((20, 8)).astype(np.float32)
    feats = rng.standard_normal((6, 8)).astype(np.float32)
    pos = np.array([2, 3, 4, 10, 11, 19], np.int32)
    want = np.asarray(jllava.merge_image_embeds(jnp.asarray(text), jnp.asarray(feats),
                                                jnp.asarray(pos)))
    got = t2n(tllava.merge_image_embeds(torch.from_numpy(text), torch.from_numpy(feats),
                                        torch.from_numpy(pos)))
    np.testing.assert_array_equal(got, want)


def test_from_numpy_keeps_clip_leaf_dtypes_like_jax():
    """A float32 CLIP + projector pytree cast to bfloat16 by ``from_numpy``
    has every leaf at the dtype JAX's initializers give it in bfloat16:
    the LayerNorm weights and biases (``ln1_*``, ``ln2_*``, ``pre_norm_*``)
    stay float32."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    f32 = {"vision": jclip.init_params(J_VCFG, k1, jnp.float32),
           **jllava.init_projector_params(k2, 32, 64, jnp.float32)}
    bf16 = {"vision": jclip.init_params(J_VCFG, k1, jnp.bfloat16),
            **jllava.init_projector_params(k2, 32, 64, jnp.bfloat16)}
    got = from_numpy(to_numpy_tree(f32), CPU, dtype=torch.bfloat16)
    want = jax.tree_util.tree_flatten_with_path(bf16)[0]
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in want:
        node = got
        for p in path:
            node = node[p.key]
        assert str(node.dtype) == f"torch.{leaf.dtype}", jax.tree_util.keystr(path)


# every test runs in the module's child pytest process (the JAX compiles
# stay out of the suite's worker): tests/torch_parity.in_fresh_interpreter_module
in_fresh_interpreter_module(globals())
