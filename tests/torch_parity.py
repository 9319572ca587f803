"""Shared set-up of the port-vs-JAX parity tests (tests/test_torch_*.py): the
tests/test_spec_loop.py geometry, seeded JAX weights handed to the port as
numpy, the tests/test_vision.py CLIP geometry over that target, a
Qwen2.5-VL variant of that target (M-RoPE, qkv bias) with a toy windowed
ViT, and the CPU device.  Both sides run in float32 on the CPU unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import clip_vit as jclip
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.models import llava as jllava
from vispec_tpu.models import qwen2_5_vl as jqwen
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import clip_vit as tclip
from vispec_tpu_torch.models import llava as tllava
from vispec_tpu_torch.models import qwen2_5_vl as tqwen

torch.set_num_threads(2)  # the suite runs several xdist workers

CPU = torch.device("cpu")

GEOMETRY = dict(
    target=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512),
    draft=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512, num_q=2),
    spec=dict(total_tokens=12, depth=3, top_k=4),
)
J_TCFG = JLlamaConfig(**GEOMETRY["target"])
J_DCFG = JDraftConfig(**GEOMETRY["draft"])
J_SPEC = JSpecConfig(**GEOMETRY["spec"])
T_TCFG = tconfigs.LlamaConfig(**GEOMETRY["target"])
T_DCFG = tconfigs.DraftConfig(**GEOMETRY["draft"])
T_SPEC = tconfigs.SpecConfig(**GEOMETRY["spec"])
MAX_LEN = 256

VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
              num_attention_heads=4, image_size=56, patch_size=14, feature_layer=-2)
PINPOINTS = ((56, 112), (112, 56), (112, 112))
J_VCFG = jclip.ClipVisionConfig(**VISION)
T_VCFG = tclip.ClipVisionConfig(**VISION)


def llava_cfgs(anyres=True, image_token_index=250):
    """(JAX, port) LlavaConfig over the target above."""
    kw = dict(image_token_index=image_token_index, anyres=anyres,
              image_grid_pinpoints=PINPOINTS)
    return (jllava.LlavaConfig(text=J_TCFG, vision=J_VCFG, **kw),
            tllava.LlavaConfig(text=T_TCFG, vision=T_VCFG, **kw))


def vision_params(dtype=jnp.float32, seed=0):
    """(JAX, port) vparams: the tower, projector and newline of the JAX
    initializers in ``dtype``, with random biases and LayerNorm affines and
    weights 5x wider than the initializer's, so the bias adds, the norms
    and the attention are not trivial."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"vision": jclip.init_params(J_VCFG, k1, dtype),
              **jllava.init_projector_params(k2, J_VCFG.hidden_size, J_TCFG.hidden_size,
                                             dtype)}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(k3, len(leaves))
    out = []
    for (path, x), k in zip(leaves, keys):
        name = path[-1].key
        noise = jax.random.normal(k, x.shape, jnp.float32)
        if name.startswith(("b", "ln", "pre_norm", "proj_b")):
            x = (x.astype(jnp.float32) + 0.1 * noise).astype(x.dtype)
        else:
            x = (x.astype(jnp.float32) * 5).astype(x.dtype)
        out.append(x)
    jparams = jax.tree_util.tree_unflatten(treedef, out)
    return jparams, from_numpy(to_numpy_tree(jparams), CPU)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_models(seed=0):
    """(JAX tparams, JAX dparams, port tparams, port dparams), float32, the
    draft sharing the target's embedding as tests/test_spec_loop.py does."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = jllama.init_params(J_TCFG, k1, jnp.float32)
    jd = jdraft.init_params(J_DCFG, k2, jnp.float32)
    jd["embed"] = jt["embed"]
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jt, jd, tt, td


def t2n(x):
    """Port tensor -> numpy."""
    return x.detach().cpu().numpy()


# Qwen2.5-VL: the target above with M-RoPE sections (2, 2, 2) (head_dim 16:
# slots 6 and 7 fall past the sections and clip to the w stream), qkv bias
# and rope_theta 100 (every slot turns by > 0.01 rad a position, so each
# stream shows), a draft with qkv bias, and the tests/test_vision.py tower
# widths with the target's hidden as its output (window 56 px: 2x2 merged
# units; full attention at block 1)
QWEN_TARGET = dict(GEOMETRY["target"], mrope_section=(2, 2, 2), qkv_bias=True,
                   rope_theta=100.0)
QWEN_DRAFT = dict(GEOMETRY["draft"], qkv_bias=True)
QWEN_VISION = dict(hidden_size=32, out_hidden_size=64, intermediate_size=64, depth=3,
                   num_heads=4, patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                   window_size=56, fullatt_block_indexes=(1,))


def qwen_vision_tree(cfg, key, dtype=jnp.float32):
    """A JAX Qwen2.5-VL tower tree (tests/test_vision.py's ``qwen_params``
    layout) with random biases and RMSNorm weights, so that every add and
    norm is live."""
    ks = iter(jax.random.split(key, 32))
    h, m, l = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    pin = 3 * cfg.temporal_patch_size * cfg.patch_size ** 2

    def w(shape, scale=0.05, dt=dtype):
        return (jax.random.normal(next(ks), shape, jnp.float32) * scale).astype(dt)

    def norm(shape):
        return 1.0 + w(shape, 0.1, jnp.float32)

    return {
        "patch_w": w((pin, h)),
        "blocks": {
            "norm1": norm((l, h)), "norm2": norm((l, h)),
            "wqkv": w((l, h, 3 * h)), "bqkv": w((l, 3 * h), 0.1),
            "wo": w((l, h, h)), "bo": w((l, h), 0.1),
            "w_gate": w((l, h, m)), "b_gate": w((l, m), 0.1),
            "w_up": w((l, h, m)), "b_up": w((l, m), 0.1),
            "w_down": w((l, m, h)), "b_down": w((l, h), 0.1),
        },
        "merger": {
            "ln_q": norm((h,)),
            "w1": w((4 * h, 4 * h)), "b1": w((4 * h,), 0.1),
            "w2": w((4 * h, cfg.out_hidden_size)), "b2": w((cfg.out_hidden_size,), 0.1),
        },
    }


def qwen_models(seed=0):
    """(JAX, port) configs and float32 weights of the Qwen2.5-VL geometry:
    returns (j_tcfg, j_dcfg, j_vcfg, t_tcfg, t_dcfg, t_vcfg, jt, jd, jv, tt,
    td, tv).  The qkv biases are random and the target's wq / wk are 10x
    the initializer's, so that its attention is sharp and every position
    counts; the draft shares the target's embedding."""
    jtc, jdc = JLlamaConfig(**QWEN_TARGET), JDraftConfig(**QWEN_DRAFT)
    jvc = jqwen.QwenVisionConfig(**QWEN_VISION)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    jt = jllama.init_params(jtc, k1, jnp.float32)
    jd = jdraft.init_params(jdc, k2, jnp.float32)
    for i, b in enumerate(("bq", "bk", "bv")):
        kb = jax.random.fold_in(k4, i)
        jt["layers"][b] = 0.1 * jax.random.normal(kb, jt["layers"][b].shape)
        jd["layer"][b] = 0.1 * jax.random.normal(jax.random.fold_in(kb, 7),
                                                 jd["layer"][b].shape)
    jt["layers"]["wq"] = jt["layers"]["wq"] * 10
    jt["layers"]["wk"] = jt["layers"]["wk"] * 10
    jd["embed"] = jt["embed"]
    jv = qwen_vision_tree(jvc, k3)
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return (jtc, jdc, jvc, tconfigs.LlamaConfig(**QWEN_TARGET),
            tconfigs.DraftConfig(**QWEN_DRAFT), tqwen.QwenVisionConfig(**QWEN_VISION),
            jt, jd, jv, tt, td, from_numpy(to_numpy_tree(jv), CPU))
