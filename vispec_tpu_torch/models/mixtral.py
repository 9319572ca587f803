"""Mixtral MoE target backbone: the Llama stack with a top-2 routed expert
block in place of each layer's MLP.

As in the JAX package, the block is computed densely over the experts: the
router's float32 softmax picks each token's top-2 experts (ties to the
lowest index), their weights are renormalised and scattered into a dense
``[tokens, E]`` matrix, every expert runs on every token, and the expert
outputs are summed under those weights.  At speculative decoding's token
counts (a tree of ~30 rows) that streams each expert's weights once per
forward, with no gather of weight matrices.

Parameters are the Llama layout (``models/llama.py``) without the dense
MLP, plus per layer

  router:  [L, hidden, E]
  we_gate, we_up: [L, hidden, E * inter]  (expert e in columns e*inter:(e+1)*inter)
  we_down: [L, E, inter, hidden]

The JAX package holds gate and up as ``[L, E, hidden, inter]``;
``convert.params.from_numpy`` lays them out as above, so each is one
product over all experts with a float32 result.  The down product keeps a
float32 result per expert, and the float32 routing weights apply to it
before the one cast back to the activation dtype, in the JAX package's
order.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..configs import LlamaConfig
from ..ops.quant import qdot
from ..ops.topk import top_k
from ..parallel import sharding
from . import llama


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2


def moe_block(x: torch.Tensor, lp: dict, cfg: MixtralConfig, mesh=None) -> torch.Tensor:
    """Top-k routed expert MLP of one layer over ``x [..., hidden]`` (any
    leading dims, such as the batched layout's ``[B, S]``), computed densely
    over the experts; returns ``[..., hidden]`` in x's dtype.  Under a mesh
    the layer holds this rank's E / tp experts (``sharding.
    mixtral_param_specs``): the routing stays whole, each rank sums its own
    experts' weighted outputs in float32, and the sum over tp comes before
    the cast."""
    lead, d = x.shape[:-1], x.shape[-1]
    xs = x.reshape(-1, d)
    n = xs.shape[0]
    e_local = lp["we_down"].shape[0]
    first = (0 if mesh is None else mesh.coords["tp"]) * e_local
    probs = torch.softmax(qdot(xs, lp["router"]), dim=-1)  # [N, E] float32
    top_w, top_i = top_k(probs, cfg.num_experts_per_tok)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    weights = torch.zeros_like(probs).scatter_(1, top_i.to(torch.int64), top_w)
    gate = qdot(xs, lp["we_gate"]).reshape(n, e_local, -1)
    up = qdot(xs, lp["we_up"]).reshape(n, e_local, -1)
    inter = (F.silu(gate) * up).to(x.dtype)
    out = None
    for j in range(e_local):
        w = weights[:, first + j:first + j + 1]
        part = qdot(inter[:, j], lp["we_down"][j]) * w
        out = part if out is None else out + part
    return sharding.all_reduce(out, mesh, "tp").to(x.dtype).reshape(*lead, d)


def forward_hidden(params: dict, cfg: MixtralConfig, inputs_embeds, position_ids, cache,
                   attn_mask, region=None, return_new_kv: bool = False, seq_len=None,
                   mrope_ids: bool = False, mesh=None):
    """``llama.forward_hidden``'s contract (region, ``return_new_kv``,
    ``seq_len``, the int8 cache, the slot-stacked batched layout, a mesh)
    with the expert block as each layer's MLP."""
    return llama.forward_hidden(params, cfg, inputs_embeds, position_ids, cache,
                                attn_mask, region, return_new_kv, seq_len=seq_len,
                                mrope_ids=mrope_ids, mesh=mesh,
                                mlp=lambda normed, lp: moe_block(normed, lp, cfg, mesh))


def init_params(cfg: MixtralConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random parameters drawn on ``device`` from ``generator`` in ``dtype``
    (N(0, 0.02) matrices, unit norms), in the port's expert layout."""
    l, d, i, e = (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_local_experts)
    hq = cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim

    def w(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    layers = {
        "input_norm": torch.ones((l, d), dtype=torch.float32, device=device),
        "post_norm": torch.ones((l, d), dtype=torch.float32, device=device),
        "wq": w((l, d, hq)),
        "wk": w((l, d, hkv)),
        "wv": w((l, d, hkv)),
        "wo": w((l, hq, d)),
        "router": w((l, d, e)),
        "we_gate": w((l, d, e * i)),
        "we_up": w((l, d, e * i)),
        "we_down": w((l, e, i, d)),
    }
    return {
        "embed": w((cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "lm_head": w((d, cfg.vocab_size)),
    }


def convert_mixtral(sd, cfg: MixtralConfig, dtype=torch.bfloat16, prefix: str = "model.",
                    device="cuda") -> dict:
    """An HF Mixtral state dict (``block_sparse_moe.gate`` and
    ``block_sparse_moe.experts.{e}.w1 / w3 / w2``: gate, up, down) -> the
    parameters above on ``device``, read tensor by tensor
    (``convert.hf.load_state_dict``)."""
    from ..convert import hf

    params = hf.convert_llama(sd, cfg, dtype, prefix=prefix, device=device, mlp=False)
    l, e, i = cfg.num_hidden_layers, cfg.num_local_experts, cfg.intermediate_size
    layers = params["layers"]
    layers["router"] = hf.stack_layers(sd, prefix + "layers.{}.block_sparse_moe.gate.weight",
                                       l, dtype, device)
    experts = prefix + "layers.{}.block_sparse_moe.experts.{}.{}.weight"
    d = cfg.hidden_size
    for name, hf_name in (("we_gate", "w1"), ("we_up", "w3")):
        out = torch.empty((l, d, e * i), dtype=dtype, device=device)
        for li in range(l):
            for j in range(e):
                out[li, :, j * i:(j + 1) * i].copy_(
                    hf.to_device(sd[experts.format(li, j, hf_name)], device).T)
        layers[name] = out
    down = torch.empty((l, e, i, d), dtype=dtype, device=device)
    for li in range(l):
        for j in range(e):
            down[li, j].copy_(hf.to_device(sd[experts.format(li, j, "w2")], device).T)
    layers["we_down"] = down
    return params
