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
from ..ops.verify_attention import verify_attention


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 RMSNorm."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (weight.float() * normed).to(x.dtype)


def swiglu_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    gate = qdot(x, w_gate)
    up = qdot(x, w_up)
    inter = (F.silu(gate) * up).to(x.dtype)
    return qdot(inter, w_down).to(x.dtype)


def append_kv(k_cache, v_cache, k_scale, v_scale, k_new, v_new, layer_idx: int,
              write_at) -> None:
    """Write this layer's new K/V rows [Hkv, S, D] into the stacked cache
    buffers at row ``write_at``, in place; an int8 cache (``k_scale`` not
    None) gets the rows quantized per row and their scales."""
    if k_scale is not None:
        k_new, ks = kvc.quantize_rows(k_new)
        v_new, vs = kvc.quantize_rows(v_new)
        kvc.write_rows(k_scale[layer_idx], 1, write_at, ks)
        kvc.write_rows(v_scale[layer_idx], 1, write_at, vs)
    kvc.write_rows(k_cache[layer_idx], 1, write_at, k_new)
    kvc.write_rows(v_cache[layer_idx], 1, write_at, v_new)


def cached_attend(q, k_cache, v_cache, k_scale, v_scale, layer_idx: int, layer_ids,
                  attn_mask, region):
    """Attention of one layer over the stacked cache: with a region, the
    length-aware ``verify_attention`` reads the stacked cache (int8 tiles
    and scales directly, when quantized) at the layer index held on the
    device (``layer_ids[layer_idx]``); without one, plain masked ``attend``
    over the layer's slice, dequantized first when quantized."""
    if region is not None:
        return verify_attention(q, k_cache, v_cache, region[0], region[1],
                                layer_idx=layer_ids[layer_idx], k_scale=k_scale,
                                v_scale=v_scale)
    if k_scale is not None:
        k_l = kvc.dequantize_rows(k_cache[layer_idx], k_scale[layer_idx], q.dtype)
        v_l = kvc.dequantize_rows(v_cache[layer_idx], v_scale[layer_idx], q.dtype)
        return attend(q, k_l, v_l, attn_mask)
    return attend(q, k_cache[layer_idx], v_cache[layer_idx], attn_mask)


def forward_hidden(
    params: dict,
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [S, hidden]
    position_ids: torch.Tensor,  # [S] int32
    cache: KVCache,
    attn_mask: torch.Tensor,  # [S, max_len] bool (used when region is None)
    region=None,  # optional (start, mask[S, T_reg]) => verify_attention
    return_new_kv: bool = False,
    seq_len=None,  # real kv length (dynamic-NTK stretch; None => from positions)
):
    """Run the decoder stack; returns (final-normed hidden [S, hidden],
    cache with the new block written at cache.length — call
    ``kv_cache.advance`` afterwards).  With ``return_new_kv`` also returns
    the appended K/V blocks, each [L, H_kv, S, D]."""
    if cfg.mrope_section is not None:
        raise NotImplementedError("M-RoPE (Qwen2.5-VL) targets are not ported yet")
    cos, sin = rope_ops.cos_sin(
        position_ids,
        cfg.head_dim,
        cfg.rope_theta,
        cfg.rope_scaling_factor if cfg.rope_scaling_type == "linear" else 1.0,
        dynamic_ntk=((cfg.rope_scaling_factor, cfg.max_position_embeddings)
                     if cfg.rope_scaling_type == "dynamic" else None),
        seq_len=seq_len,
    )
    write_at = cache.length
    s = inputs_embeds.shape[0]
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    lp_all = params["layers"]
    num_layers = lp_all["wq"].shape[0]
    layer_ids = torch.arange(num_layers, dtype=torch.int32, device=cache.k.device)
    new_k, new_v = [], []

    hidden = inputs_embeds
    for li in range(num_layers):
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
        q = q.reshape(s, h, d).transpose(0, 1)
        k_new = k.reshape(s, hkv, d).transpose(0, 1)
        v_new = v.reshape(s, hkv, d).transpose(0, 1).contiguous()
        q, k_new = rope_ops.apply_rope(q, k_new, cos, sin)
        q = q.contiguous()

        append_kv(cache.k, cache.v, cache.k_scale, cache.v_scale, k_new, v_new, li,
                  write_at)
        out = cached_attend(q, cache.k, cache.v, cache.k_scale, cache.v_scale, li,
                            layer_ids, attn_mask, region)
        out = out.transpose(0, 1).reshape(s, h * d)
        hidden = residual + qdot(out, lp["wo"]).to(normed.dtype)
        normed = rms_norm(hidden, lp["post_norm"], cfg.rms_norm_eps)
        hidden = hidden + swiglu_mlp(normed, lp["w_gate"], lp["w_up"], lp["w_down"])
        if return_new_kv:
            new_k.append(k_new)
            new_v.append(v_new)

    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    if return_new_kv:
        return hidden, cache, (torch.stack(new_k), torch.stack(new_v))
    return hidden, cache


def embed(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"].index_select(0, token_ids.reshape(-1).to(torch.int64)
                                        ).reshape(*token_ids.shape, -1)


def lm_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """[..., hidden] -> [..., vocab] float32 logits."""
    return qdot(hidden, params["lm_head"])


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
