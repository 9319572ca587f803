"""Shared set-up of the port-vs-JAX parity tests (tests/test_torch_*.py): the
tests/test_spec_loop.py geometry, seeded JAX weights handed to the port as
numpy, the tests/test_vision.py CLIP geometry over that target, and the CPU
device.  Both sides run in float32 on the CPU unless a test says
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
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import clip_vit as tclip
from vispec_tpu_torch.models import llava as tllava

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
