"""Qwen2.5-VL vision transformer and M-RoPE planning.

Port of the JAX package's ``models/qwen2_5_vl.py``: the windowed ViT
(2-D vision rotary, windowed attention with full attention on
``fullatt_block_indexes``, the 2x2 patch merger) and the 3-D M-RoPE
position ids of a prompt (``get_rope_index_host``).

The host plans in numpy, as the JAX package does (own copies here): the
window shuffle order, window and image segment ids, 2-D positions and the
merger's inverse permutation (``plan_vision``), bucketed by the caller to
a padded length.  The pixel work runs on the tensors' device: patchify,
the patch embed as one product over flattened patches, and every block's
dense attention masked by segment id (tokens attend within their window,
or within their image on the full-attention blocks).  The scores are
``[heads, S, S]`` float32 and live for one block at a time.

Each step keeps the JAX dtypes: every product goes through
``ops.quant.qdot`` (float32 result) and is rounded where the JAX lines
round; the RMSNorms compute in float32; the rotary is applied in float32
and rounded; the attention scores and softmax are float32 and the
probabilities are cast to v's dtype before P.V.

Weights (as the JAX pytree, HF ``visual.*``):
  patch_w: [in_ch*t_patch*p*p, hidden]
  blocks: norm1/norm2: [L, hidden] (float32 RMSNorm), wqkv: [L, hidden, 3*hidden],
          bqkv: [L, 3*hidden], wo: [L, hidden, hidden], bo: [L, hidden],
          w_gate/w_up: [L, hidden, inter], b_gate/b_up: [L, inter],
          w_down: [L, inter, hidden], b_down: [L, hidden]
  merger: ln_q: [hidden] (float32), w1: [4*hidden, 4*hidden], b1,
          w2: [4*hidden, out], b2
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from ..ops.quant import qdot
from ..ops.rope import rotate_half
from .llama import rms_norm

QWEN_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
QWEN_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class QwenVisionConfig:
    """The defaults are Qwen/Qwen2.5-VL-7B-Instruct's published vision widths."""

    hidden_size: int = 1280
    out_hidden_size: int = 3584  # text hidden
    intermediate_size: int = 3420
    depth: int = 32
    num_heads: int = 16
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    in_channels: int = 3
    tokens_per_second: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


class VisionPlan(NamedTuple):
    """Host plan for one ViT pass over one or several images (or a video).

    Every index array is in window-shuffled order of length pad_len (the
    padding gets index 0 / segment -1):

    perm:       [pad_len] — window-shuffled source index into the natural-order
                patch sequence (including the merge-unit interleave).
    inv_perm:   [n_merged] — maps merger outputs back to natural order.
    win_seg:    [pad_len] — window id per token (mask of the windowed blocks).
    img_seg:    [pad_len] — image id per token (mask of the full-attention blocks).
    pos_hw:     [pad_len, 2] — (h, w) rotary position per token (shuffled order).
    n_tokens:   true patch count (before the merge); n_merged = n_tokens // merge_unit.
    """

    perm: np.ndarray
    inv_perm: np.ndarray
    win_seg: np.ndarray
    img_seg: np.ndarray
    pos_hw: np.ndarray
    n_tokens: int
    n_merged: int


def plan_vision(grid_thw: Sequence[Tuple[int, int, int]], cfg: QwenVisionConfig,
                pad_len: int) -> VisionPlan:
    """Window shuffle, segment ids and 2-D positions (HF ``get_window_index``
    and ``rot_pos_emb``), all in numpy."""
    sms = cfg.spatial_merge_size
    unit = cfg.merge_unit
    vit_ws = cfg.window_size // sms // cfg.patch_size  # window size on the merged grid

    perm_units: List[np.ndarray] = []  # merged-unit indices in window order
    win_seg_units: List[np.ndarray] = []
    img_seg_units: List[np.ndarray] = []
    pos_list: List[np.ndarray] = []  # natural patch order (h, w)
    unit_base = 0
    win_id = 0
    for img_i, (t, h, w) in enumerate(grid_thw):
        gh, gw = h // sms, w // sms
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h = (-gh) % vit_ws
        pad_w = (-gw) % vit_ws
        padded = np.full((t, gh + pad_h, gw + pad_w), -100, np.int64)
        padded[:, :gh, :gw] = idx
        nwh, nww = (gh + pad_h) // vit_ws, (gw + pad_w) // vit_ws
        padded = padded.reshape(t, nwh, vit_ws, nww, vit_ws)
        padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nwh * nww, vit_ws, vit_ws)
        for ti in range(t):
            for wi in range(nwh * nww):
                vals = padded[ti, wi].reshape(-1)
                vals = vals[vals != -100]
                if vals.size == 0:
                    continue
                perm_units.append(vals + unit_base)
                win_seg_units.append(np.full(vals.size, win_id))
                img_seg_units.append(np.full(vals.size, img_i))
                win_id += 1
        unit_base += t * gh * gw

        # natural-order (h, w) positions with the merge-unit interleave
        hpos = np.arange(h)[:, None].repeat(w, 1)
        hpos = hpos.reshape(gh, sms, gw, sms).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, 0)
        wpos = wpos.reshape(gh, sms, gw, sms).transpose(0, 2, 1, 3).reshape(-1)
        hw = np.stack([hpos, wpos], -1)  # [h*w, 2]
        pos_list.append(np.tile(hw, (t, 1)))

    perm_u = np.concatenate(perm_units)  # [n_merged] window-order unit ids
    n_merged = perm_u.shape[0]
    n_tokens = n_merged * unit
    if n_tokens > pad_len:
        raise ValueError(f"pad_len {pad_len} < {n_tokens} vision tokens")

    # token-level permutation: unit u -> tokens [u*unit, (u+1)*unit)
    perm = (perm_u[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    win_seg = np.repeat(np.concatenate(win_seg_units), unit)
    img_seg = np.repeat(np.concatenate(img_seg_units), unit)
    pos_nat = np.concatenate(pos_list, 0)  # natural order
    pos_hw = pos_nat[perm]

    inv_perm = np.argsort(perm_u)

    pad = pad_len - n_tokens
    return VisionPlan(
        perm=np.concatenate([perm, np.full(pad, 0)]).astype(np.int32),
        inv_perm=inv_perm.astype(np.int32),
        win_seg=np.concatenate([win_seg, np.full(pad, -1)]).astype(np.int32),
        img_seg=np.concatenate([img_seg, np.full(pad, -1)]).astype(np.int32),
        pos_hw=np.concatenate([pos_hw, np.zeros((pad, 2))]).astype(np.int32),
        n_tokens=n_tokens,
        n_merged=n_merged,
    )


def vision_rope(pos_hw: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """2-D rotary: half the (half-)frequencies from h, half from w."""
    quarter = head_dim // 4
    inv = 1.0 / (theta ** (np.arange(quarter, dtype=np.float32) * 2 / (head_dim // 2)))
    inv = torch.as_tensor(inv, dtype=torch.float32, device=pos_hw.device)
    freqs = pos_hw.to(torch.float32)[:, :, None] * inv[None, None, :]  # [S, 2, quarter]
    half = freqs.reshape(pos_hw.shape[0], -1)  # [S, head_dim//2] (h-freqs, then w)
    emb = torch.cat([half, half], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _segment_mask(seg: torch.Tensor) -> torch.Tensor:
    """[S, S] bool: same segment id, and the row is not padding."""
    return (seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)


def forward(params: dict, cfg: QwenVisionConfig, patches: torch.Tensor,
            plan: VisionPlan) -> torch.Tensor:
    """patches: [pad_len, in_ch*t_patch*p*p] in natural order, padded.
    Returns the merged features [pad_len // merge_unit, out_hidden] in
    natural order (rows past ``plan.n_merged`` are garbage)."""
    dtype = params["patch_w"].dtype
    dev = patches.device
    x = qdot(patches.to(dtype), params["patch_w"]).to(dtype)
    x = x.index_select(0, torch.as_tensor(plan.perm, dtype=torch.int64, device=dev))

    cos, sin = vision_rope(torch.as_tensor(plan.pos_hw, device=dev), cfg.head_dim)
    win_mask = _segment_mask(torch.as_tensor(plan.win_seg, device=dev))
    img_mask = _segment_mask(torch.as_tensor(plan.img_seg, device=dev))

    s = x.shape[0]
    h, d = cfg.num_heads, cfg.head_dim
    full = set(cfg.fullatt_block_indexes)
    blocks = params["blocks"]
    for i in range(cfg.depth):
        lp = {k: v[i] for k, v in blocks.items()}
        residual = x
        normed = rms_norm(x, lp["norm1"], 1e-6)
        qkv = (qdot(normed, lp["wqkv"]) + lp["bqkv"]).to(dtype)
        q, k, v = (t.reshape(s, h, d).transpose(0, 1) for t in qkv.chunk(3, dim=-1))
        q = (q.float() * cos + rotate_half(q).float() * sin).to(dtype)
        k = (k.float() * cos + rotate_half(k).float() * sin).to(dtype)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
        scores.masked_fill_(~(img_mask if i in full else win_mask), NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(0, 1).reshape(s, h * d)
        x = residual + (qdot(attn, lp["wo"]).to(dtype) + lp["bo"]).to(dtype)

        residual = x
        normed = rms_norm(x, lp["norm2"], 1e-6)
        gate = qdot(normed, lp["w_gate"]).to(dtype) + lp["b_gate"]
        up = qdot(normed, lp["w_up"]).to(dtype) + lp["b_up"]
        inter = (F.silu(gate.float()) * up.float()).to(dtype)
        x = residual + (qdot(inter, lp["w_down"]).to(dtype) + lp["b_down"]).to(dtype)

    # patch merger: RMSNorm, groups of merge_unit, Linear, exact GELU, Linear
    m = params["merger"]
    normed = rms_norm(x, m["ln_q"], 1e-6)
    grouped = normed.reshape(s // cfg.merge_unit, cfg.merge_unit * cfg.hidden_size)
    z = F.gelu(qdot(grouped, m["w1"]) + m["b1"]).to(dtype)
    out = (qdot(z, m["w2"]) + m["b2"]).to(dtype)

    # back to natural order
    inv = np.concatenate([plan.inv_perm, np.arange(plan.inv_perm.shape[0], out.shape[0])])
    return out.index_select(0, torch.as_tensor(inv, dtype=torch.int64, device=dev))


# ---------------------------------------------------------------------------
# Host-side preprocessing + M-RoPE index computation
# ---------------------------------------------------------------------------


def smart_resize(h: int, w: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """HF ``Qwen2VLImageProcessor``'s ``smart_resize``: the nearest multiples
    of ``factor`` whose area lies within [min_pixels, max_pixels]."""
    if max(h, w) / min(h, w) > 200:
        raise ValueError("aspect ratio too extreme")
    h_bar = max(factor, round(h / factor) * factor)
    w_bar = max(factor, round(w / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((h * w) / max_pixels)
        h_bar = math.floor(h / beta / factor) * factor
        w_bar = math.floor(w / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (h * w))
        h_bar = math.ceil(h * beta / factor) * factor
        w_bar = math.ceil(w * beta / factor) * factor
    return h_bar, w_bar


def _normalize(pixels01: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(QWEN_IMAGE_MEAN, device=pixels01.device)
    std = torch.as_tensor(QWEN_IMAGE_STD, device=pixels01.device)
    return (pixels01 - mean) / std


def patchify_image(pixels01: torch.Tensor, cfg: QwenVisionConfig) -> torch.Tensor:
    """[H, W, 3] in [0, 1] (H, W multiples of 2*patch) -> [n_patches,
    C*tp*p*p] in the HF processor's patch layout: token order (gh/sms, gw/sms,
    sms_h, sms_w), feature order (C, tp, ph, pw), the still frame repeated
    ``temporal_patch_size`` times inside each channel block."""
    p, sms = cfg.patch_size, cfg.spatial_merge_size
    x = _normalize(pixels01)
    h, w = x.shape[0] // p, x.shape[1] // p
    x = x.reshape(h // sms, sms, p, w // sms, sms, p, 3)
    x = x.permute(0, 3, 1, 4, 6, 2, 5)  # [gh, gw, sms, sms, C, ph, pw]
    x = x.reshape(h * w, 3, 1, p * p).expand(h * w, 3, cfg.temporal_patch_size, p * p)
    return x.reshape(h * w, 3 * cfg.temporal_patch_size * p * p)


def patchify_video(frames01: torch.Tensor, cfg: QwenVisionConfig) -> torch.Tensor:
    """[T, H, W, 3] in [0, 1] (H, W multiples of 2*patch) -> [ceil(T/tp) *
    H/p * W/p, C*tp*p*p]: temporal pairs of frames per patch; an odd frame
    count repeats the last frame, as HF pads it."""
    p, sms, tp = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    t, hh, ww, _ = frames01.shape
    if t % tp:
        frames01 = torch.cat([frames01, frames01[-1:]], dim=0)
        t += 1
    x = _normalize(frames01)
    h, w = hh // p, ww // p
    x = x.reshape(t // tp, tp, h // sms, sms, p, w // sms, sms, p, 3)
    # token order (t, gh, gw, sms_h, sms_w); feature (C, tp, ph, pw)
    x = x.permute(0, 2, 5, 3, 6, 8, 1, 4, 7)
    return x.reshape((t // tp) * h * w, 3 * tp * p * p)


def get_rope_index_host(
    input_ids: np.ndarray,  # [S]
    image_grid_thw: Sequence[Tuple[int, int, int]],
    cfg: QwenVisionConfig,
    image_token_id: int,
    video_token_id: int,
    vision_start_token_id: int,
    second_per_grid_ts: Sequence[float] = (),
) -> Tuple[np.ndarray, int]:
    """3-D M-RoPE position ids of a prompt (HF ``get_rope_index``): text runs
    advance all three streams together; a vision span takes (t, h, w) grid
    positions from the running start, t stepping by ``second_per_grid_ts *
    tokens_per_second`` truncated to an integer; text after it resumes at
    the span's largest position + 1.  Returns (position_ids [3, S],
    rope_delta = max position + 1 - S)."""
    sms = cfg.spatial_merge_size
    s = input_ids.shape[0]
    pos = np.zeros((3, s), np.int64)
    grids = list(image_grid_thw)
    gi = 0
    st = 0
    st_idx = 0
    out = []
    ids = input_ids.tolist()
    while st < s:
        # find the next vision span
        nxt = None
        for j in range(st, s):
            if ids[j] == image_token_id or ids[j] == video_token_id:
                nxt = j
                break
        if nxt is None:
            text_len = s - st
            out.append(np.tile(np.arange(text_len) + st_idx, (3, 1)))
            st_idx += text_len
            st = s
            break
        text_len = nxt - st
        if text_len:
            out.append(np.tile(np.arange(text_len) + st_idx, (3, 1)))
            st_idx += text_len
        t, h, w = grids[gi]
        spg = second_per_grid_ts[gi] if gi < len(second_per_grid_ts) else 1.0
        gi += 1
        gt, gh, gw = t, h // sms, w // sms
        t_idx = (np.arange(gt)[:, None].repeat(gh * gw, 1)
                 * spg * cfg.tokens_per_second).astype(np.int64).reshape(-1)
        h_idx = np.arange(gh)[None, :, None].repeat(gt, 0).repeat(gw, 2).reshape(-1)
        w_idx = np.arange(gw)[None, None, :].repeat(gt, 0).repeat(gh, 1).reshape(-1)
        out.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
        st_idx = int(out[-1].max()) + 1
        st = nxt + gt * gh * gw
    llm_pos = np.concatenate(out, axis=1)
    assert llm_pos.shape[1] == s, (llm_pos.shape, s)
    pos[:, :] = llm_pos
    rope_delta = int(llm_pos.max()) + 1 - s
    return pos, rope_delta


def init_params(generator: torch.Generator, cfg: QwenVisionConfig, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random parameter dict drawn on ``device`` from ``generator``: N(0,
    0.02) matrices, zero biases, float32 unit norms.  Drawn directly in
    ``dtype`` on ``device``, so the full-width tower is never built on the
    host."""
    h, m, l = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    pin = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    f32 = torch.float32

    def w(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=f32, device=device)

    return {
        "patch_w": w((pin, h)),
        "blocks": {
            "norm1": ones((l, h)), "norm2": ones((l, h)),
            "wqkv": w((l, h, 3 * h)), "bqkv": zeros((l, 3 * h)),
            "wo": w((l, h, h)), "bo": zeros((l, h)),
            "w_gate": w((l, h, m)), "b_gate": zeros((l, m)),
            "w_up": w((l, h, m)), "b_up": zeros((l, m)),
            "w_down": w((l, m, h)), "b_down": zeros((l, h)),
        },
        "merger": {
            "ln_q": ones((h,)),
            "w1": w((4 * h, 4 * h)), "b1": zeros((4 * h,)),
            "w2": w((4 * h, cfg.out_hidden_size)), "b2": zeros((cfg.out_hidden_size,)),
        },
    }
