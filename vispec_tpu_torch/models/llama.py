"""LLaMA-family target backbone (Vicuna text models).

Parameters keep the JAX package's layout: a dict with per-layer weights
stacked over layers, ``[in, out]`` matrices, float32 norms.

  embed:      [vocab, hidden]
  layers:
    input_norm, post_norm: [L, hidden]  (float32)
    wq: [L, hidden, n_heads*head_dim]   wk/wv: [L, hidden, n_kv*head_dim]
    wo: [L, n_heads*head_dim, hidden]
    w_gate/w_up: [L, hidden, inter]     w_down: [L, inter, hidden]
  final_norm: [hidden] (float32)
  lm_head:    [hidden, vocab]

The seven layer matrices and ``lm_head`` may be int8 ``QTensor``s
(``ops.quant.quantize_target_params``): every product goes through
``ops.quant.qdot``, which returns float32 as the JAX package's
``qdot(..., preferred_element_type=jnp.float32)`` does, and is cast to the
activation dtype exactly where the JAX lines cast.

The JAX ``lax.scan`` over stacked layers is a Python loop over the layer
index here, and each layer writes its new K/V rows into the cache in place.

``forward_hidden`` also runs B requests at once (the batched round, which
the JAX package gets from ``jax.vmap``): embeds ``[B, S, hidden]`` over a
slot-stacked cache, each slot writing at its own length and attending
through its own region, with every weight product taking all ``B * S`` rows
so the weights stream once for the whole batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import LlamaConfig
from ..ops import kv_cache as kvc
from ..ops import rope as rope_ops
from ..ops.attention import attend
from ..ops.kv_cache import KVCache
from ..ops.quant import qdot
from ..ops.verify_attention import verify_attention, verify_attention_batched
from ..parallel import sharding


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (weight.float() * normed).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down, mesh=None) -> torch.Tensor:
    """SwiGLU over this rank's MLP columns; the down projection's float32
    partial is summed over tp before the cast (``sharding.row_dot``)."""
    x_in = sharding.tp_copy(x, mesh)
    gate = qdot(x_in, w_gate)
    up = qdot(x_in, w_up)
    inter = (F.silu(gate) * up).to(x.dtype)
    return sharding.row_dot(inter, w_down, mesh).to(x.dtype)


def append_kv(k_cache, v_cache, k_scale, v_scale, k_new, v_new, layer_idx: int,
              write_at) -> None:
    """Write this layer's new K/V rows [B?, Hkv, S, D] into the stacked cache
    buffers at row ``write_at`` (``[B]``: per slot), in place; an int8 cache
    (``k_scale`` not None) gets the rows quantized per row and their
    scales."""
    if k_scale is not None:
        k_new, ks = kvc.quantize_rows(k_new)
        v_new, vs = kvc.quantize_rows(v_new)
        kvc.write_rows(k_scale.select(-3, layer_idx), -1, write_at, ks)
        kvc.write_rows(v_scale.select(-3, layer_idx), -1, write_at, vs)
    kvc.write_rows(k_cache.select(-4, layer_idx), -2, write_at, k_new)
    kvc.write_rows(v_cache.select(-4, layer_idx), -2, write_at, v_new)


def cached_attend(q, k_cache, v_cache, k_scale, v_scale, layer_idx: int, layer_ids,
                  attn_mask, region):
    """Attention of one layer over the stacked cache: with a region, the
    length-aware kernel reads the stacked cache (int8 tiles and scales
    directly, when quantized) at the layer index held on the device
    (``layer_ids[layer_idx]``; the batched grid for slot-stacked ``q [B, H,
    S, D]``); without one, plain masked ``attend`` over the layer's slice,
    dequantized first when quantized."""
    if region is not None:
        attend_fn = verify_attention_batched if q.dim() == 4 else verify_attention
        return attend_fn(q, k_cache, v_cache, region[0], region[1],
                         layer_idx=layer_ids[layer_idx], k_scale=k_scale,
                         v_scale=v_scale)
    if q.dim() == 4:
        raise ValueError("a batched forward needs a region: prefill runs per request")
    if k_scale is not None:
        k_l = kvc.dequantize_rows(k_cache[layer_idx], k_scale[layer_idx], q.dtype)
        v_l = kvc.dequantize_rows(v_cache[layer_idx], v_scale[layer_idx], q.dtype)
        return attend(q, k_l, v_l, attn_mask)
    return attend(q, k_cache[layer_idx], v_cache[layer_idx], attn_mask)


def forward_hidden(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B?, S, hidden]
    position_ids: torch.Tensor,  # [B?, S] int32, or [B?, 3, S] with mrope_ids
    cache: KVCache,  # slot-stacked when the inputs carry a slot dim
    attn_mask: torch.Tensor,  # [S, max_len] bool (used when region is None)
    region=None,  # optional (start [B?], mask [B?, S, T_reg]) => verify_attention
    return_new_kv: bool = False,
    seq_len=None,  # real kv length [B?] (dynamic-NTK stretch; None => from positions)
    mrope_ids: bool = False,  # position_ids are 3-row M-RoPE ids (Qwen2.5-VL)
    mlp=None,  # (normed, layer params) -> the MLP's output; None: the SwiGLU MLP
    mesh=None,  # parallel.mesh.Mesh of sharded params and cache; None: one device
):
    """Run the decoder stack; returns (final-normed hidden [B?, S, hidden],
    cache with the new block written at cache.length — call
    ``kv_cache.advance`` afterwards).  With ``return_new_kv`` also returns
    the appended K/V blocks, each [B?, L, H_kv, S, D].

    Ordinary per-request ids take plain rotary embeddings, also on a config
    with ``mrope_section`` (a Qwen2.5-VL target's text and decode positions,
    as in the JAX package: three equal streams give the same cos/sin).
    ``mrope_ids`` says that the ids are 3-row M-RoPE ids, ``[3, S]`` per
    request (``[B, 3, S]`` for slot-stacked inputs), folded by
    ``mrope_section``.  The caller says which kind it passes: the shape
    cannot tell, since batched ids ``[B, S]`` at B = 3 look like one
    request's ``[3, S]`` M-RoPE ids.

    ``mlp`` replaces the dense SwiGLU MLP of each layer (Mixtral's expert
    block, ``models/mixtral.py``); the attention half is shared.

    Under a ``mesh`` (``parallel/sharding.py``) the parameters and the cache
    are this rank's shards: the head counts come from the weights' shapes,
    the float32 partials of ``wo`` and ``w_down`` are summed over tp before
    the cast, a prefill (no region) on a mesh with sp > 1 runs this rank's
    rows and gathers K/V over sp for the causal attention (the cache stays
    whole over sp), and parameters holding fewer layers than ``cfg`` are
    one pp stage: each stage runs its layers in turn and hands the hidden
    state on, and the last stage's reaches every rank.  The returned K/V
    blocks hold this rank's heads and layers."""
    if mrope_ids:
        if cfg.mrope_section is None:
            raise ValueError("mrope_ids given to a config without mrope_section")
        cos, sin = rope_ops.mrope_cos_sin(position_ids, cfg.head_dim, cfg.mrope_section,
                                          cfg.rope_theta)
    else:
        cos, sin = rope_ops.cos_sin(
            position_ids,
            cfg.head_dim,
            cfg.rope_theta,
            cfg.rope_scaling_factor if cfg.rope_scaling_type == "linear" else 1.0,
            dynamic_ntk=((cfg.rope_scaling_factor, cfg.max_position_embeddings)
                         if cfg.rope_scaling_type == "dynamic" else None),
            seq_len=seq_len,
        )
    sp = sharding.sp_active(mesh, region)
    if sp:  # this rank's rows of the prompt, their rotations and mask rows
        inputs_embeds, cos, sin, attn_mask = (sharding.sp_shard_prefill(mesh, x) for x in (
            inputs_embeds, cos, sin, attn_mask))
    cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)  # broadcast over heads
    write_at = cache.length
    lead, s = inputs_embeds.shape[:-2], inputs_embeds.shape[-2]
    d = cfg.head_dim
    lp_all = params["layers"]
    num_layers = lp_all["wq"].shape[0]
    h, hkv = lp_all["wq"].shape[-1] // d, lp_all["wk"].shape[-1] // d
    layer_ids = torch.arange(num_layers, dtype=torch.int32, device=cache.k.device)
    if lead:  # one layer index per slot for the batched kernel: [L, B]
        layer_ids = layer_ids[:, None].expand(num_layers, *lead).contiguous()
    new_k, new_v = [], []

    def layer(li, hidden):
        lp = {name: w[li] for name, w in lp_all.items()}
        residual = hidden
        normed = rms_norm(hidden, lp["input_norm"], cfg.rms_norm_eps)
        q = qdot(normed, lp["wq"]).to(normed.dtype)
        k = qdot(normed, lp["wk"]).to(normed.dtype)
        v = qdot(normed, lp["wv"]).to(normed.dtype)
        if cfg.qkv_bias:
            q = q + lp["bq"].to(q.dtype)
            k = k + lp["bk"].to(k.dtype)
            v = v + lp["bv"].to(v.dtype)
        q = q.reshape(*lead, s, h, d).transpose(-3, -2)
        k_new = k.reshape(*lead, s, hkv, d).transpose(-3, -2)
        v_new = v.reshape(*lead, s, hkv, d).transpose(-3, -2).contiguous()
        q, k_new = rope_ops.apply_rope(q, k_new, cos, sin)
        q = q.contiguous()
        if sp:  # the whole prompt's K/V rows for the causal attention
            k_new = sharding.gather_rows(k_new, mesh)
            v_new = sharding.gather_rows(v_new, mesh)

        append_kv(cache.k, cache.v, cache.k_scale, cache.v_scale, k_new, v_new, li,
                  write_at)
        out = cached_attend(q, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
                            layer_ids, attn_mask, region)
        out = out.transpose(-3, -2).reshape(*lead, s, h * d)
        hidden = residual + sharding.row_dot(out, lp["wo"], mesh).to(normed.dtype)
        normed = rms_norm(hidden, lp["post_norm"], cfg.rms_norm_eps)
        if mlp is None:
            hidden = hidden + swiglu_mlp(normed, lp["w_gate"], lp["w_up"], lp["w_down"],
                                         mesh)
        else:
            hidden = hidden + mlp(normed, lp)
        if return_new_kv:
            new_k.append(k_new)
            new_v.append(v_new)
        return hidden

    hidden = inputs_embeds
    if num_layers == cfg.num_hidden_layers:
        for li in range(num_layers):
            hidden = layer(li, hidden)
    else:  # one pp stage of the layers
        stage, stages = mesh.coords["pp"], mesh.shape["pp"]
        if num_layers * stages != cfg.num_hidden_layers:
            raise ValueError(f"{num_layers} layers on each of {stages} pp stages != "
                             f"{cfg.num_hidden_layers}")
        for turn in range(stages):
            if turn == stage:
                for li in range(num_layers):
                    hidden = layer(li, hidden)
            hidden = sharding.stage_handoff(hidden, mesh, turn)

    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    if sp:
        hidden = sharding.gather_rows(hidden, mesh)
    if return_new_kv:
        return hidden, cache, (torch.stack(new_k, dim=-4), torch.stack(new_v, dim=-4))
    return hidden, cache


def embed(params: dict, token_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embedding rows of ``token_ids`` (any shape); a vocab-sharded table
    under a mesh (``sharding.embed_rows``)."""
    return sharding.embed_rows(params["embed"], token_ids, mesh)


def lm_head(params: dict, hidden: torch.Tensor, mesh=None) -> torch.Tensor:
    """[..., hidden] -> [..., vocab] float32 logits (gathered over tp from a
    vocab-sharded head)."""
    return sharding.vocab_logits(hidden, params["lm_head"], mesh)


def init_params(cfg: LlamaConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random parameter dict drawn on ``device`` from ``generator`` (tests and
    benches; N(0, 0.02) matrices, unit norms).  Drawn directly in ``dtype`` so
    a 7B target is never built in float32 or on the host."""
    l, d, i = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
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
        "w_gate": w((l, d, i)),
        "w_up": w((l, d, i)),
        "w_down": w((l, i, d)),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((l, hq), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((l, hkv), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((l, hkv), dtype=dtype, device=device)
    return {
        "embed": w((cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "lm_head": w((d, cfg.vocab_size)),
    }
