"""Shared set-up of the port-vs-JAX parity tests (tests/test_torch_*.py): the
tests/test_spec_loop.py geometry, seeded JAX weights handed to the port as
numpy, and the CPU device.  Both sides run in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy

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
