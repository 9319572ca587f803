"""ViSpec draft model (inference half): one EAGLE-style decoder layer plus the
image adaptor, with the compressed prefill, the accepted-token append and the
depth-limited beam expansion that grows the next verify tree.

The prompt's image spans become a host-side integer plan (``PrefillPlan``,
built once per prompt with numpy), which drives static gathers on the device.
Weight names and layouts are the JAX package's:
  embed:      [vocab, hidden]
  layer:      one llama layer without input_norm (layer 0 skips it)
  fc_w:       [2*hidden, hidden], fc_b: [hidden]          (bias if cfg.fc_bias)
  img_fc_w:   [2*hidden, hidden], img_fc_b: [hidden]
  adaptor:    q: [num_q, heads, head_dim], wk/wv: [hidden, heads*head_dim]
              (+ bk/bv if qkv_bias), wo: [heads*head_dim, hidden]
The layer matrices (and a ``rank_head`` ranking copy of the target head)
may be int8 ``QTensor``s or int4 ``Q4Tensor``s
(``ops.quant.quantize_draft_params``); every product goes through
``ops.quant.qdot`` with a float32 result, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs import DraftConfig, SpecConfig
from ..ops import kv_cache as kvc
from ..ops import rope as rope_ops
from ..ops.attention import attend, attend_region
from ..ops.kv_cache import KVCache, advance, init_cache
from ..ops.quant import Q4Tensor, QTensor, qdot, quantize_q4, quantize_q8
from ..ops.topk import top_k
from ..ops.tree import Tree, build_tree
from .llama import rms_norm, swiglu_mlp


# ---------------------------------------------------------------------------
# Host-side prefill plan (per prompt, integers only)
# ---------------------------------------------------------------------------


class PrefillPlan(NamedTuple):
    """Restructure plan for the draft's compressed prefill (tensors on the
    model's device).

    gather_src: [pad_len] int64 — source index of text slots; 0 for adapted.
    pos_ids:    [pad_len] int32 — position id of every compressed slot.
    is_adapted: [pad_len] bool  — slot holds an adapted image token.
    adapt_src:  [pad_len] int64 — flat (image * (num_q-1) + q) index.
    seg_id:     [pad_len] int64 — which last-img vector text slots fuse with
        (0 = zeros before any image, s = image s-1's last adapted token).
    span_start, span_len: [max_images] int64 — image spans; 0-length = padding.
    num_images: [] int64; comp_len: [] int64 — compressed length;
    real_len:   [] int64 — logical sequence length.
    """

    gather_src: torch.Tensor
    pos_ids: torch.Tensor
    is_adapted: torch.Tensor
    adapt_src: torch.Tensor
    seg_id: torch.Tensor
    span_start: torch.Tensor
    span_len: torch.Tensor
    num_images: torch.Tensor
    comp_len: torch.Tensor
    real_len: torch.Tensor


def make_prefill_plan(
    image_mask: Optional[np.ndarray],  # [L] bool — SHIFTED image mask
    seq_len: int,
    num_q: int,
    pad_len: int,
    max_images: int = 4,
    max_span: int = 1,
    device="cuda",
) -> Tuple[PrefillPlan, int]:
    """Build the compressed-sequence layout from consecutive-True image spans
    (host numpy, once per prompt).  Each span contributes ``num_q - 1`` slots
    carrying the span's last ``num_q - 1`` position ids.  Returns (plan,
    max_span) with ``max_span`` raised to the longest span."""
    gather = np.zeros(pad_len, np.int64)
    pos = np.zeros(pad_len, np.int32)
    is_ad = np.zeros(pad_len, bool)
    ad_src = np.zeros(pad_len, np.int64)
    seg = np.zeros(pad_len, np.int64)
    spans = []

    if image_mask is None:
        image_mask = np.zeros(seq_len, bool)
    else:
        image_mask = np.asarray(image_mask, bool).reshape(-1)[:seq_len]
        if image_mask.shape[0] < seq_len:
            image_mask = np.pad(image_mask, (0, seq_len - image_mask.shape[0]))

    def check_room(out, i):
        if out >= pad_len:
            raise ValueError(
                f"pad_len {pad_len} too small for compressed sequence "
                f"(seq_len={seq_len}, still at original index {i})")

    out = 0
    cur_seg = 0
    i = 0
    while i < seq_len:
        if image_mask[i]:
            j = i
            while j + 1 < seq_len and image_mask[j + 1]:
                j += 1
            spans.append((i, j - i + 1))
            for q in range(num_q - 1):
                check_room(out, i)
                is_ad[out] = True
                ad_src[out] = (len(spans) - 1) * (num_q - 1) + q
                pos[out] = j - (num_q - 1) + 1 + q
                out += 1
            cur_seg = len(spans)
            i = j + 1
        else:
            check_room(out, i)
            gather[out] = i
            pos[out] = i
            seg[out] = cur_seg
            out += 1
            i += 1

    if len(spans) > max_images:
        raise ValueError(f"too many image spans ({len(spans)}) for max_images={max_images}")
    span_start = np.zeros(max_images, np.int64)
    span_len = np.zeros(max_images, np.int64)
    for s, (st, ln) in enumerate(spans):
        span_start[s] = st
        span_len[s] = ln
    max_span = max(max_span, int(span_len.max()) if spans else 1)

    def t(x):
        return torch.as_tensor(x, device=device)

    plan = PrefillPlan(
        gather_src=t(gather), pos_ids=t(pos), is_adapted=t(is_ad),
        adapt_src=t(ad_src), seg_id=t(seg), span_start=t(span_start),
        span_len=t(span_len), num_images=t(np.int64(len(spans))),
        comp_len=t(np.int64(out)), real_len=t(np.int64(seq_len)),
    )
    return plan, max_span


# ---------------------------------------------------------------------------
# Draft modules
# ---------------------------------------------------------------------------


def img_adaptor(params: dict, cfg: DraftConfig, span_embeds: torch.Tensor,
                span_mask: torch.Tensor) -> torch.Tensor:
    """num_q learned queries cross-attend over one image span.
    span_embeds [max_span, hidden] (padded), span_mask [max_span] bool;
    returns [num_q, hidden]."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    a = params["adaptor"]
    k = qdot(span_embeds, a["wk"]).to(span_embeds.dtype)
    v = qdot(span_embeds, a["wv"]).to(span_embeds.dtype)
    if cfg.qkv_bias:
        k = k + a["bk"].to(k.dtype)
        v = v + a["bv"].to(v.dtype)
    k = k.reshape(-1, h, d).transpose(0, 1)
    v = v.reshape(-1, h, d).transpose(0, 1)
    q = a["q"].to(k.dtype).transpose(0, 1)  # [h, num_q, d]
    mask = span_mask[None, :].expand(cfg.num_q, span_mask.shape[0])
    out = attend(q, k, v, mask)
    out = out.transpose(0, 1).reshape(cfg.num_q, h * d)
    return qdot(out, a["wo"]).to(span_embeds.dtype)


def fuse_weight_mats(params: dict, cfg: DraftConfig):
    """The request-independent decode fuse matrices W_e = F1 and
    W_h = G1 @ F2 (or F2 for EAGLE), see decode_fuse_weights; quantized as
    the layer is (int4 or int8) when the draft is quantized."""
    d = cfg.hidden_size
    f1 = params["fc_w"][:d]
    f2 = params["fc_w"][d:]
    if "img_fc_w" in params:
        g1 = params["img_fc_w"][:d]
        w_h = qdot(g1, f2).to(f1.dtype)
    else:
        w_h = f2
    wq = params["layer"].get("wq")
    if isinstance(wq, Q4Tensor):
        return quantize_q4(f1), quantize_q4(w_h.float())
    if isinstance(wq, QTensor):
        return quantize_q8(f1), quantize_q8(w_h.float())
    return f1, w_h


def ensure_fuse_mats(params: dict, cfg: DraftConfig):
    """Precomputed fuse matrices when present (SpecModel), derived otherwise."""
    if "fuse_we" in params and "fuse_wh" in params:
        return params["fuse_we"], params["fuse_wh"]
    return fuse_weight_mats(params, cfg)


def decode_fuse_bias(params: dict, cfg: DraftConfig, last_img: torch.Tensor) -> torch.Tensor:
    """b_eff = (L @ G2 + gb) @ F2 + fb, with L = last_img (fixed per generation)."""
    d = cfg.hidden_size
    f2 = params["fc_w"][d:]
    zeros = torch.zeros((d,), dtype=f2.dtype, device=f2.device)
    b = params.get("fc_b", zeros).float()
    if "img_fc_w" in params:
        g2 = params["img_fc_w"][d:]
        gb = params.get("img_fc_b", zeros).float()
        bias = torch.matmul(torch.matmul(last_img.float(), g2.float()) + gb,
                            f2.float()) + b
    else:
        bias = b
    return bias.float()


def decode_fuse_weights(params: dict, cfg: DraftConfig, last_img: torch.Tensor):
    """Fold the decode-path fc(img_fc(.)) composition into two D x D matmuls:
    fc([e; img_fc([h; L])]) = e @ F1 + h @ (G1 @ F2) + (L @ G2 + gb) @ F2 + fb.
    Returns (W_e, W_h, b_eff)."""
    w_e, w_h = ensure_fuse_mats(params, cfg)
    return w_e, w_h, decode_fuse_bias(params, cfg, last_img)


def fused_input(w_e, w_h, b_eff, embeds: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    out = qdot(embeds, w_e) + qdot(hidden, w_h) + b_eff
    return out.to(hidden.dtype)


def fuse(params: dict, embeds: torch.Tensor, hidden: torch.Tensor,
         last_img: torch.Tensor) -> torch.Tensor:
    """img_fc + fc input fusion for decode-path tokens (last_img broadcast
    to every token); without img_fc weights (EAGLE) only fc([embed; hidden])."""
    fused = _fuse_img_only(params, hidden, last_img[None].expand_as(hidden))
    return _fc(params, embeds, fused)


def _fuse_img_only(params: dict, hidden: torch.Tensor,
                   last_img_per_tok: torch.Tensor) -> torch.Tensor:
    if "img_fc_w" not in params:
        return hidden
    img_in = torch.cat([hidden, last_img_per_tok.to(hidden.dtype)], dim=-1)
    fused = qdot(img_in, params["img_fc_w"])
    if "img_fc_b" in params:
        fused = fused + params["img_fc_b"].float()
    return fused.to(hidden.dtype)


def _fc(params: dict, embeds: torch.Tensor, fused: torch.Tensor) -> torch.Tensor:
    fc_in = torch.cat([embeds.to(fused.dtype), fused], dim=-1)
    out = qdot(fc_in, params["fc_w"])
    if "fc_b" in params:
        out = out + params["fc_b"].float()
    return out.to(fused.dtype)


def layer_forward(
    params: dict,
    cfg: DraftConfig,
    x: torch.Tensor,  # [S, hidden] — already fc-fused
    position_ids: torch.Tensor,  # [S]
    cache: KVCache,
    write_at,
    attn_mask: Optional[torch.Tensor],  # [S, max_len] (used when region is None)
    region=None,  # optional (start, mask[S, T_reg]) => verify_attention
) -> Tuple[torch.Tensor, KVCache]:
    """One llama decoder layer with layer-0 semantics (no input norm); the
    new K/V rows are written into the cache in place at ``write_at``."""
    lp = params["layer"]
    cos, sin = rope_ops.cos_sin(position_ids, cfg.head_dim, cfg.rope_theta)
    s = x.shape[0]
    h, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    q = qdot(x, lp["wq"]).to(x.dtype)
    k = qdot(x, lp["wk"]).to(x.dtype)
    v = qdot(x, lp["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(q.dtype)
        k = k + lp["bk"].to(k.dtype)
        v = v + lp["bv"].to(v.dtype)
    q = q.reshape(s, h, d).transpose(0, 1)
    k = k.reshape(s, hkv, d).transpose(0, 1)
    v = v.reshape(s, hkv, d).transpose(0, 1)
    q, k = rope_ops.apply_rope(q, k, cos, sin)

    k_full, v_full = cache.k[0], cache.v[0]
    kvc.write_rows(k_full, 1, write_at, k)
    kvc.write_rows(v_full, 1, write_at, v)
    attn = attend_region(q.contiguous(), k_full, v_full, attn_mask, region)
    attn = attn.transpose(0, 1).reshape(s, h * d)
    hidden = x + qdot(attn, lp["wo"]).to(x.dtype)
    normed = rms_norm(hidden, lp["post_norm"], cfg.rms_norm_eps)
    hidden = hidden + swiglu_mlp(normed, lp["w_gate"], lp["w_up"], lp["w_down"])
    return hidden, cache


def compress_inputs(
    params: dict,
    cfg: DraftConfig,
    target_hidden: torch.Tensor,  # [pad_len, hidden]
    embeds: torch.Tensor,  # [pad_len, hidden] (vision-merged, shifted)
    plan: PrefillPlan,
    max_span: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed-sequence assembly: adaptor over image spans, img_fc/fc text
    fusion, adapted-slot substitution.  Returns (x [pad_len, hidden],
    last_img_table [max_images+1, hidden])."""
    pad_len = plan.gather_src.shape[0]
    max_images = plan.span_start.shape[0]
    dtype, device = target_hidden.dtype, target_hidden.device
    embeds = embeds.to(dtype)

    if "adaptor" in params:
        span_cols = torch.arange(max_span, device=device)
        idx = torch.clamp(plan.span_start[:, None] + span_cols[None, :], 0, pad_len - 1)
        adapted = torch.stack([
            img_adaptor(params, cfg, embeds.index_select(0, idx[m]),
                        span_cols < plan.span_len[m])
            for m in range(max_images)
        ])  # [M, num_q, D]
    else:
        adapted = torch.zeros((max_images, cfg.num_q, cfg.hidden_size),
                              dtype=dtype, device=device)

    # last-img lookup: slot 0 = zeros, slot s = image s-1's final adapted token
    last_img_table = torch.cat(
        [torch.zeros((1, cfg.hidden_size), dtype=dtype, device=device),
         adapted[:, -1, :].to(dtype)], dim=0)

    txt_hidden = target_hidden.index_select(0, plan.gather_src)
    txt_embeds = embeds.index_select(0, plan.gather_src)
    txt_img = last_img_table.index_select(0, torch.clamp(plan.seg_id, 0, max_images))
    text_out = _fc(params, txt_embeds, _fuse_img_only(params, txt_hidden, txt_img))

    if cfg.num_q > 1:
        adapted_flat = adapted[:, : cfg.num_q - 1, :].reshape(-1, cfg.hidden_size)
    else:  # no kept adapted tokens; a dummy row keeps shapes static
        adapted_flat = torch.zeros((1, cfg.hidden_size), dtype=dtype, device=device)
    ad_src = torch.clamp(plan.adapt_src, 0, adapted_flat.shape[0] - 1)
    x = torch.where(plan.is_adapted[:, None],
                    adapted_flat.index_select(0, ad_src).to(dtype), text_out)
    return x, last_img_table


# ---------------------------------------------------------------------------
# Prefill (compressed) and decode-append forwards
# ---------------------------------------------------------------------------


def prefill(
    params: dict,
    cfg: DraftConfig,
    target_hidden: torch.Tensor,  # [pad_len, hidden]
    embeds: torch.Tensor,  # [pad_len, hidden] — SHIFTED input embeds
    plan: PrefillPlan,
    cache: KVCache,
    max_span: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """Compressed draft prefill.  Returns (last_hidden [hidden],
    last_img [hidden], cache advanced to comp_len/real_len)."""
    pad_len = plan.gather_src.shape[0]
    max_images = plan.span_start.shape[0]
    device = target_hidden.device
    x, last_img_table = compress_inputs(params, cfg, target_hidden, embeds, plan,
                                        max_span)
    rows = torch.arange(pad_len, device=device)
    attn_mask = torch.zeros((pad_len, cache.max_len), dtype=torch.bool, device=device)
    attn_mask[:, :pad_len] = rows[None, :] <= rows[:, None]
    hidden, cache = layer_forward(params, cfg, x, plan.pos_ids, cache, 0, attn_mask)
    cache = advance(cache, plan.comp_len, plan.real_len)
    last_hidden = hidden.index_select(0, (plan.comp_len - 1).reshape(1))[0]
    last_img = last_img_table.index_select(
        0, torch.clamp(plan.num_images, 0, max_images).reshape(1))[0]
    return last_hidden, last_img, cache


def append_accepted(
    params: dict,
    cfg: DraftConfig,
    accept_hidden: torch.Tensor,  # [max_path, hidden] — padded accepted hiddens
    accept_tokens: torch.Tensor,  # [max_path] int32 — paired (shifted) tokens
    num_valid: torch.Tensor,  # scalar — acc+1 real rows
    last_img: torch.Tensor,
    cache: KVCache,
    fuse_w=None,  # optional (w_e, w_h, b_eff) from decode_fuse_weights
) -> Tuple[torch.Tensor, KVCache]:
    """Draft forward over newly accepted tokens, appended to the committed
    draft KV.  Returns (seed_hidden [hidden], cache)."""
    s = accept_tokens.shape[0]
    device = accept_hidden.device
    embeds = params["embed"].index_select(0, accept_tokens.to(torch.int64))
    if fuse_w is not None:
        x = fused_input(fuse_w[0], fuse_w[1], fuse_w[2], embeds.to(accept_hidden.dtype),
                        accept_hidden)
    else:
        x = fuse(params, embeds.to(accept_hidden.dtype), accept_hidden, last_img)

    rows = torch.arange(s, dtype=torch.int32, device=device)
    pos_ids = cache.real_length + rows
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))
    hidden, cache = layer_forward(params, cfg, x, pos_ids, cache, cache.length, None,
                                  region=(cache.length, tri))
    cache = advance(cache, num_valid, num_valid)
    seed_row = torch.clamp(num_valid - 1, 0, s - 1).reshape(1).to(torch.int64)
    return hidden.index_select(0, seed_row)[0], cache


# ---------------------------------------------------------------------------
# Beam tree expansion
# ---------------------------------------------------------------------------


def expand_tree(
    params: dict,
    cfg: DraftConfig,
    spec: SpecConfig,
    seed_hidden: torch.Tensor,  # [hidden] — draft output at the frontier token
    sample_token: torch.Tensor,  # [] int32 — committed root token
    last_img: torch.Tensor,  # [hidden]
    head_w,  # [hidden, vocab] ranking head: rank_head or the target's lm_head
    cache: KVCache,
    fuse_w=None,  # optional (w_e, w_h, b_eff) from decode_fuse_weights
) -> Tuple[Tree, KVCache]:
    """Depth-limited beam growth + global re-rank.

    The draft KV scratch region [cache.length, cache.length + depth*top_k)
    holds the beam tokens; it is not committed (lengths unchanged), so the
    next round's append overwrites it."""
    k_beam = spec.top_k
    depth = spec.depth
    num_cand = spec.num_candidates
    vdtype = seed_hidden.dtype
    device = seed_hidden.device

    logp0 = torch.log_softmax(qdot(seed_hidden, head_w), dim=-1)
    top_p0, top_i0 = top_k(logp0, k_beam)

    tokens_flat = torch.zeros((num_cand,), dtype=torch.int32, device=device)
    scores_flat = torch.full((num_cand,), -float("inf"), dtype=torch.float32, device=device)
    parent1_flat = torch.zeros((num_cand,), dtype=torch.int32, device=device)
    tokens_flat[:k_beam] = top_i0
    scores_flat[:k_beam] = top_p0

    stable_len = cache.length
    real_len = cache.real_length
    scratch_cols = depth * k_beam

    beam_scores = top_p0  # [K]
    beam_tokens = top_i0
    beam_hidden = seed_hidden[None].expand(k_beam, cfg.hidden_size).to(vdtype)
    beam_src = torch.arange(k_beam, dtype=torch.int32, device=device)
    beam_mask = torch.zeros((k_beam, scratch_cols), dtype=torch.bool, device=device)
    sc = torch.arange(scratch_cols, device=device)
    beam_rows = torch.arange(k_beam, device=device)

    for i in range(depth):
        embeds = params["embed"].index_select(0, beam_tokens.to(torch.int64)).to(vdtype)
        if fuse_w is not None:
            x = fused_input(fuse_w[0], fuse_w[1], fuse_w[2], embeds, beam_hidden)
        else:
            x = fuse(params, embeds, beam_hidden, last_img)
        pos_ids = (real_len + i).expand(k_beam)
        write_at = stable_len + i * k_beam

        # visibility over the scratch window: ancestors + self
        reg_prior = (sc[None, :] < i * k_beam) & beam_mask
        reg_self = (sc[None, :] - i * k_beam) == beam_rows[:, None]
        reg_mask = (reg_prior | reg_self).contiguous()  # [K, scratch_cols]
        hidden, cache = layer_forward(params, cfg, x, pos_ids, cache, write_at, None,
                                      region=(stable_len, reg_mask))

        logp = torch.log_softmax(qdot(hidden, head_w), dim=-1)
        top_p, top_i = top_k(logp, k_beam)  # [K, K]
        cu = top_p + beam_scores[:, None]

        block = k_beam + i * k_beam * k_beam
        flat_tokens = top_i.reshape(-1)
        flat_scores = cu.reshape(-1)
        flat_parent = (beam_src + 1)[:, None].expand(k_beam, k_beam).reshape(-1)
        tokens_flat[block:block + k_beam * k_beam] = flat_tokens
        scores_flat[block:block + k_beam * k_beam] = flat_scores
        parent1_flat[block:block + k_beam * k_beam] = flat_parent

        new_scores, cs_idx = top_k(flat_scores, k_beam)
        cs_idx = cs_idx.to(torch.int64)
        out_ids = cs_idx // k_beam
        beam_tokens = flat_tokens[cs_idx]
        beam_hidden = hidden[out_ids]
        beam_src = (block + cs_idx).to(torch.int32)
        # each new beam inherits its parent's ancestry plus the parent's slot
        own_col = i * k_beam + out_ids
        beam_mask = beam_mask[out_ids] | (sc[None, :] == own_col[:, None])
        beam_scores = new_scores

    tree = build_tree(sample_token, tokens_flat, scores_flat, parent1_flat,
                      spec.total_tokens, max_depth=depth + 1)
    return tree, cache


def init_params(cfg: DraftConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random draft parameters drawn on ``device`` from ``generator``;
    img_fc starts identity-on-hidden / zero-on-image, as in the reference."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    hq = cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim

    def w(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    layer = {
        "post_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "wq": w((d, hq)),
        "wk": w((d, hkv)),
        "wv": w((d, hkv)),
        "wo": w((hq, d)),
        "w_gate": w((d, i)),
        "w_up": w((d, i)),
        "w_down": w((i, d)),
    }
    if cfg.qkv_bias:
        layer.update(bq=zeros((hq,)), bk=zeros((hkv,)), bv=zeros((hkv,)))
    params = {"embed": w((cfg.vocab_size, d)), "layer": layer, "fc_w": w((2 * d, d))}
    if cfg.fc_bias:
        params["fc_b"] = zeros((d,))
    if cfg.vision:
        q = torch.randn((cfg.num_q, cfg.num_attention_heads, cfg.head_dim),
                        generator=generator, device=device, dtype=torch.float32)
        adaptor = {
            "q": (q * cfg.head_dim ** -0.5).to(dtype),
            "wk": w((d, hq)),
            "wv": w((d, hq)),
            "wo": w((hq, d)),
        }
        if cfg.qkv_bias:
            adaptor.update(bk=zeros((hq,)), bv=zeros((hq,)))
        params["adaptor"] = adaptor
        img_fc = zeros((2 * d, d))
        img_fc[:d].fill_diagonal_(1.0)
        params["img_fc_w"] = img_fc
        if cfg.fc_bias:
            params["img_fc_b"] = zeros((d,))
    return params


def init_draft_cache(cfg: DraftConfig, max_len: int, dtype=torch.bfloat16,
                     device="cuda") -> KVCache:
    return init_cache(1, cfg.num_key_value_heads, max_len, cfg.head_dim, dtype, device)
