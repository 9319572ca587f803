"""Plain PyTorch pieces of the references: the decoder stack (rotary or
M-RoPE, grouped-query attention, SwiGLU or a top-k expert block), the
Qwen2.5-VL vision tower, and the weight maker.

Written from the published architectures (HF ``modeling_qwen2_5_vl`` and
``modeling_mixtral``), in float32 with TF32 off, one request and one layer
at a time, with no cache, kernel or batching.  Nothing here imports the
program: the references take the benchmark's weights and inputs and work
everything else out again.

``precision="fp8"`` is the control: every product's weight is rounded to
float8 e4m3 per output column and its input per row, as an fp8 path would
feed the tensor cores; the rest stays float32.  Two witnesses of what
bfloat16 alone does to the answers: ``precision="bf16"`` rounds every
product's input to bfloat16 (the weights are bfloat16 already), as a
bfloat16 program feeds its products; ``"bf16act"`` also keeps what a
bfloat16 program keeps in bfloat16: every product's output, the rotated
queries and keys, the attention weights and the residual stream.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3


@contextmanager
def exact_float32():
    """float32 products in float32 (TF32 off) for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def draw(shapes: Dict[str, Tuple[int, ...]], gen: torch.Generator, device, dtype,
         std: float) -> Dict[str, torch.Tensor]:
    """N(0, std) tensors of the given shapes, drawn in one call into one
    buffer on ``device`` and handed out as views."""
    total = sum(math.prod(s) for s in shapes.values())
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, std, generator=gen)
    out, at = {}, 0
    for name, s in shapes.items():
        n = math.prod(s)
        out[name] = buf[at:at + n].view(s)
        at += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a.b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def decoder_shapes(cfg: dict, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """Shapes of a decoder stack in the program's layout (``[in, out]``
    matrices stacked over layers; experts' gate and up side by side)."""
    l, h, i = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    d = h // cfg["num_attention_heads"]
    hq, hkv = cfg["num_attention_heads"] * d, cfg["num_key_value_heads"] * d
    s = {"wq": (l, h, hq), "wk": (l, h, hkv), "wv": (l, h, hkv), "wo": (l, hq, h)}
    if cfg.get("qkv_bias"):
        s.update(bq=(l, hq), bk=(l, hkv), bv=(l, hkv))
    e = cfg.get("num_local_experts", 0)
    if e:
        s.update(router=(l, h, e), we_gate=(l, h, e * i), we_up=(l, h, e * i),
                 we_down=(l, e, i, h))
    else:
        s.update(w_gate=(l, h, i), w_up=(l, h, i), w_down=(l, i, h))
    return {prefix + k: v for k, v in s.items()}


def make_decoder(cfg: dict, gen, device, dtype, std) -> dict:
    """Target weights: embed, layers, final_norm, lm_head (norms are ones,
    float32, as the published initialisation leaves them)."""
    l, h, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    shapes = {"embed": (v, h), **decoder_shapes(cfg, "layers."), "lm_head": (h, v)}
    w = nest(draw(shapes, gen, device, dtype, std))
    ones = torch.ones((2, l, h), dtype=torch.float32, device=device)
    w["layers"]["input_norm"], w["layers"]["post_norm"] = ones[0], ones[1]
    w["final_norm"] = torch.ones((h,), dtype=torch.float32, device=device)
    return w


def make_draft(dcfg: dict, embed: torch.Tensor, gen, device, dtype, std) -> dict:
    """A one-layer ViSpec / EAGLE draft in the program's layout; it shares
    the target's embedding."""
    h, i = dcfg["hidden_size"], dcfg["intermediate_size"]
    d = h // dcfg["num_attention_heads"]
    hq, hkv = dcfg["num_attention_heads"] * d, dcfg["num_key_value_heads"] * d
    s = {"layer.wq": (h, hq), "layer.wk": (h, hkv), "layer.wv": (h, hkv),
         "layer.wo": (hq, h), "layer.w_gate": (h, i), "layer.w_up": (h, i),
         "layer.w_down": (i, h), "fc_w": (2 * h, h)}
    if dcfg.get("qkv_bias"):
        s.update({"layer.bq": (hq,), "layer.bk": (hkv,), "layer.bv": (hkv,)})
    if dcfg.get("fc_bias", True):
        s["fc_b"] = (h,)
    if dcfg.get("vision", True):
        s.update({"adaptor.q": (dcfg["num_q"], dcfg["num_attention_heads"], d),
                  "adaptor.wk": (h, hq), "adaptor.wv": (h, hq), "adaptor.wo": (hq, h),
                  "img_fc_w": (2 * h, h)})
        if dcfg.get("qkv_bias"):
            s.update({"adaptor.bk": (hq,), "adaptor.bv": (hq,)})
        if dcfg.get("fc_bias", True):
            s["img_fc_b"] = (h,)
    w = nest(draw(s, gen, device, dtype, std))
    w["layer"]["post_norm"] = torch.ones((h,), dtype=torch.float32, device=device)
    w["embed"] = embed
    return w


def make_tower(vc: dict, gen, device, dtype, std) -> dict:
    """The Qwen2.5-VL vision tower in the program's layout."""
    h, m, l = vc["hidden_size"], vc["intermediate_size"], vc["depth"]
    pin = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    u = vc["spatial_merge_size"] ** 2 * h
    s = {"patch_w": (pin, h), "blocks.wqkv": (l, h, 3 * h), "blocks.bqkv": (l, 3 * h),
         "blocks.wo": (l, h, h), "blocks.bo": (l, h), "blocks.w_gate": (l, h, m),
         "blocks.b_gate": (l, m), "blocks.w_up": (l, h, m), "blocks.b_up": (l, m),
         "blocks.w_down": (l, m, h), "blocks.b_down": (l, h), "merger.w1": (u, u),
         "merger.b1": (u,), "merger.w2": (u, vc["out_hidden_size"]),
         "merger.b2": (vc["out_hidden_size"],)}
    w = nest(draw(s, gen, device, dtype, std))
    ones = torch.ones((2, l, h), dtype=torch.float32, device=device)
    w["blocks"]["norm1"], w["blocks"]["norm2"] = ones[0], ones[1]
    w["merger"]["ln_q"] = torch.ones((h,), dtype=torch.float32, device=device)
    return w


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Linear:
    """``x @ w (+ b)`` in float32, or with its operands rounded to float8
    (the control) or bfloat16 (the witness)."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor], precision: str):
        self.precision = precision
        w = w.to(torch.float32)
        if precision == "fp8":
            w = fp8_round(w, 0)
        elif precision in ("bf16", "bf16act"):
            w = bf16_round(w)
        self.w = w
        self.b = None if b is None else b.to(torch.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = fp8_round(x, -1)
        elif self.precision in ("bf16", "bf16act"):
            x = bf16_round(x)
        y = x @ self.w
        return act(y if self.b is None else y + self.b, self.precision)


def act(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An activation as the precision keeps it (bfloat16 under "bf16act")."""
    return bf16_round(x) if precision == "bf16act" else x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(torch.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def text_cos_sin(pos: torch.Tensor, d: int, theta: float,
                 mrope_section: Optional[List[int]] = None):
    """cos, sin [N, d] of positions ``[N]``, or of M-RoPE positions ``[3, N]``
    (HF ``apply_multimodal_rotary_pos_emb``: the doubled section list cuts
    the rotary dims into chunks, chunk i taking stream i % 3)."""
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=pos.device) / d)
    freqs = pos.to(torch.float64)[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    if mrope_section is not None:
        chunks = emb.split(list(mrope_section) * 2, dim=-1)
        emb = torch.cat([c[i % 3] for i, c in enumerate(chunks)], dim=-1)
    return emb.cos().to(torch.float32), emb.sin().to(torch.float32)


def attend(q, k, v, mask: Optional[torch.Tensor], precision: str = "float32") -> torch.Tensor:
    """Softmax attention of q [H, N, d] over k, v [Hkv, M, d] (query heads
    grouped over the KV heads); ``mask`` [N, M] True where allowed."""
    h, hkv = q.shape[0], k.shape[0]
    rep = h // hkv
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return act(act(torch.softmax(s, dim=-1), precision) @ v, precision)


def experts(x: torch.Tensor, lw: dict, l: int, cfg: dict, precision: str) -> torch.Tensor:
    """Mixtral's sparse block: router softmax in float32, the top-k experts
    per token, their weights renormalised, each expert run on its tokens."""
    e, k, i = cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["intermediate_size"]
    probs = torch.softmax(Linear(lw["router"][l], None, precision)(x), dim=-1)
    top_w, top_i = probs.topk(k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for j in range(e):
        rows, slot = (top_i == j).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        cols = slice(j * i, (j + 1) * i)
        xs = x[rows]
        g = Linear(lw["we_gate"][l][:, cols], None, precision)(xs)
        u = Linear(lw["we_up"][l][:, cols], None, precision)(xs)
        y = Linear(lw["we_down"][l][j], None, precision)(F.silu(g) * u)
        out.index_add_(0, rows, y * top_w[rows, slot][:, None])
    return out


def decoder_logits(w: dict, cfg: dict, embeds: torch.Tensor, pos: torch.Tensor,
                   rows: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Logits [len(rows), vocab] of a causal decoder over ``embeds`` [N, h]
    at positions ``pos`` ([N], or [3, N] under M-RoPE)."""
    h, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = h // nh
    n = embeds.shape[0]
    section = (cfg.get("rope_scaling") or {}).get("mrope_section")
    cos, sin = text_cos_sin(pos, d, cfg["rope_theta"], section)
    causal = torch.ones((n, n), dtype=torch.bool, device=embeds.device).tril()
    lw = w["layers"]
    x = embeds.to(torch.float32)
    bias = cfg.get("qkv_bias")
    for l in range(cfg["num_hidden_layers"]):
        a = rms_norm(x, lw["input_norm"][l], eps)
        q = Linear(lw["wq"][l], lw["bq"][l] if bias else None, precision)(a)
        k = Linear(lw["wk"][l], lw["bk"][l] if bias else None, precision)(a)
        v = Linear(lw["wv"][l], lw["bv"][l] if bias else None, precision)(a)
        q, k, v = (t.view(n, -1, d).transpose(0, 1) for t in (q, k, v))
        q = act(q * cos + rotate_half(q) * sin, precision)
        k = act(k * cos + rotate_half(k) * sin, precision)
        o = attend(q, k, v, causal, precision).transpose(0, 1).reshape(n, nh * d)
        x = act(x + Linear(lw["wo"][l], None, precision)(o), precision)
        a = rms_norm(x, lw["post_norm"][l], eps)
        if cfg.get("num_local_experts"):
            x = act(x + experts(a, lw, l, cfg, precision), precision)
        else:
            g = Linear(lw["w_gate"][l], None, precision)(a)
            u = Linear(lw["w_up"][l], None, precision)(a)
            x = act(x + Linear(lw["w_down"][l], None, precision)(F.silu(g) * u), precision)
        del a, q, k, v, o
    x = rms_norm(x[rows], w["final_norm"], eps)
    return Linear(w["lm_head"], None, precision)(x)


# ---------------------------------------------------------------------------
# Qwen2.5-VL vision tower
# ---------------------------------------------------------------------------

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)  # the Qwen2-VL processor's
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def image_patches(pixels: torch.Tensor, vc: dict):
    """One image [H, W, 3] in [0, 1] (sides multiples of patch * merge) ->
    (patches [N, C * tp * p * p], (row, col) of each patch, merged-unit id
    (row-major) of each patch) in the processor's token order: merged
    units row-major, the 2 x 2 patches of a unit inside it; each patch's
    features in (channel, frame, row, col) order with the still image
    repeated over the temporal patch."""
    p, m, tp = vc["patch_size"], vc["spatial_merge_size"], vc["temporal_patch_size"]
    hh, ww = pixels.shape[0] // p, pixels.shape[1] // p
    mean = torch.tensor(IMAGE_MEAN, device=pixels.device)
    std = torch.tensor(IMAGE_STD, device=pixels.device)
    x = ((pixels - mean) / std).permute(2, 0, 1)  # [C, H, W]
    rows, cols, feats = [], [], []
    for ui in range(hh // m):
        for uj in range(ww // m):
            for a in range(m):
                for b in range(m):
                    r, c = ui * m + a, uj * m + b
                    rows.append(r)
                    cols.append(c)
    rows_t = torch.tensor(rows, device=pixels.device)
    cols_t = torch.tensor(cols, device=pixels.device)
    tiles = x.unfold(1, p, p).unfold(2, p, p)  # [C, hh, ww, p, p]
    tiles = tiles[:, rows_t, cols_t]  # [C, N, p, p]
    patches = tiles.permute(1, 0, 2, 3).unsqueeze(2).expand(-1, -1, tp, -1, -1)
    unit = (rows_t // m) * (ww // m) + cols_t // m
    return patches.reshape(len(rows), -1), rows_t, cols_t, unit


def vision_features(w: dict, vc: dict, pixels: torch.Tensor,
                    precision: str = "float32") -> torch.Tensor:
    """The tower over one image: [merged units, out_hidden], units row-major
    (the order of the prompt's image placeholders)."""
    h, heads = vc["hidden_size"], vc["num_heads"]
    d = h // heads
    m = vc["spatial_merge_size"]
    patches, rows, cols, unit = image_patches(pixels, vc)
    n = patches.shape[0]
    x = Linear(w["patch_w"], None, precision)(patches)
    # 2-D rotary: half of each head's rotary frequencies from the row, half
    # from the column (HF ``rot_pos_emb`` with dim = head_dim / 2)
    quarter = d // 4
    inv = 1.0 / 10000.0 ** (torch.arange(0, d // 2, 2, dtype=torch.float64,
                                         device=x.device) / (d // 2))
    freqs = torch.cat([rows[:, None] * inv, cols[:, None] * inv], dim=-1)
    assert freqs.shape[-1] == 2 * quarter
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos().to(torch.float32), emb.sin().to(torch.float32)
    # windows of window_size pixels over the merged grid
    ws = vc["window_size"] // m // vc["patch_size"]
    units_w = pixels.shape[1] // vc["patch_size"] // m
    urow, ucol = unit // units_w, unit % units_w
    win = (urow // ws) * 100000 + ucol // ws
    groups = [torch.nonzero(win == g).squeeze(1) for g in torch.unique(win)]
    full = set(vc["fullatt_block_indexes"])
    bw = w["blocks"]
    for l in range(vc["depth"]):
        a = rms_norm(x, bw["norm1"][l], 1e-6)
        qkv = Linear(bw["wqkv"][l], bw["bqkv"][l], precision)(a)
        q, k, v = (t.reshape(n, heads, d).transpose(0, 1) for t in qkv.chunk(3, dim=-1))
        q = q * cos + rotate_half(q) * sin
        k = k * cos + rotate_half(k) * sin
        if l in full:
            o = attend(q, k, v, None)
        else:
            o = torch.empty_like(q)
            for idx in groups:
                o[:, idx] = attend(q[:, idx], k[:, idx], v[:, idx], None)
        o = o.transpose(0, 1).reshape(n, h)
        x = x + Linear(bw["wo"][l], bw["bo"][l], precision)(o)
        a = rms_norm(x, bw["norm2"][l], 1e-6)
        g = Linear(bw["w_gate"][l], bw["b_gate"][l], precision)(a)
        u = Linear(bw["w_up"][l], bw["b_up"][l], precision)(a)
        x = x + Linear(bw["w_down"][l], bw["b_down"][l], precision)(F.silu(g) * u)
    mw = w["merger"]
    a = rms_norm(x, mw["ln_q"], 1e-6).reshape(n // (m * m), m * m * h)
    z = F.gelu(Linear(mw["w1"], mw["b1"], precision)(a))
    return Linear(mw["w2"], mw["b2"], precision)(z)


def mrope_positions(ids: np.ndarray, grids: List[Tuple[int, int, int]], cfg: dict,
                    tokens_per_second: int = 2) -> Tuple[np.ndarray, int]:
    """HF ``get_rope_index`` for image prompts: text advances the three
    streams together; an image span (after <vision_start>) takes (t, h, w)
    positions over its merged grid from the running start; text after it
    resumes at the span's largest position + 1.  Returns ([3, N], delta)
    where delta = max + 1 - N continues every later position."""
    m = cfg["vision_config"]["spatial_merge_size"]
    img = cfg["image_token_id"]
    out, st, start, gi = [], 0, 0, 0
    n = len(ids)
    while st < n:
        hits = np.nonzero(ids[st:] == img)[0]
        if hits.size == 0:
            out.append(np.tile(np.arange(n - st) + start, (3, 1)))
            break
        j = st + int(hits[0])
        if j > st:
            out.append(np.tile(np.arange(j - st) + start, (3, 1)))
            start += j - st
        t, gh, gw = grids[gi]
        gi += 1
        gh, gw = gh // m, gw // m
        tt = np.repeat(np.arange(t), gh * gw) * 0  # a still image: t stays 0
        hh = np.tile(np.repeat(np.arange(gh), gw), t)
        wwi = np.tile(np.arange(gw), t * gh)
        span = np.stack([tt, hh, wwi]) + start
        out.append(span)
        start = int(span.max()) + 1
        st = j + t * gh * gw
    pos = np.concatenate(out, axis=1)
    return pos, int(pos.max()) + 1 - n


def served_gaps(logits: torch.Tensor, served: torch.Tensor,
                control: Optional[torch.Tensor] = None) -> np.ndarray:
    """Per served position: how far the reference's logit of the served
    token (or of the control's first choice) lies below its best logit."""
    best = logits.max(dim=-1).values
    pick = served if control is None else control.argmax(dim=-1)
    got = logits.gather(-1, pick[:, None].to(torch.int64)).squeeze(-1)
    return (best - got).double().cpu().numpy()
