"""LLaVA-1.5 / LLaVA-NeXT (1.6) multimodal glue: vision tower -> projector ->
anyres packing -> merged text embeddings.

Port of the JAX package's ``models/llava.py``.  The anyres layout decisions
(best resolution, tile grid, unpad crop, newline slots) are host-side
integer planning per image shape (``plan_anyres``, numpy, an own copy),
producing a gather map so packing is one ``index_select``.  The pixel work
(resize, normalize, tower, projector, packing) runs on the tensors' device.

``resize_image`` is the JAX package's bicubic resize
(``jax.image.resize(..., "bicubic")``): the Keys cubic kernel with
a = -0.5, widened by the scale when downsampling (antialiasing), weights
renormalized at the borders and zeroed for samples outside the input.  Its
per-axis ``[in, out]`` weight matrices are built on the host in float32 and
applied as two products on the device.  (``F.interpolate(mode="bicubic")``
uses a = -0.75, clamps at the borders and does not antialias: another
image.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import LlamaConfig
from ..ops.quant import qdot
from . import clip_vit

# OpenAI CLIP normalization (HF CLIPImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# llava-v1.6 grid pinpoints (HF config.json image_grid_pinpoints)
DEFAULT_PINPOINTS = ((336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008))


@dataclass(frozen=True)
class LlavaConfig:
    text: LlamaConfig
    vision: clip_vit.ClipVisionConfig
    image_token_index: int = 32000
    anyres: bool = True  # False => LLaVA-1.5 single-tile path
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = DEFAULT_PINPOINTS

    @property
    def patches_per_side(self) -> int:
        return self.vision.image_size // self.vision.patch_size


class AnyresPlan(NamedTuple):
    """Host-side integer plan for one image.

    grid_h/grid_w: tile grid of the high-res pass (base tile excluded).
    gather_idx: [n_tokens] int32 into the packed source array
        [base (576) ; tile grid flattened (grid_h*24*grid_w*24) ; newline (1)].
    n_tokens: total image tokens this image expands to.
    target_h/target_w: canvas resolution for the high-res resize+pad.
    """

    grid_h: int
    grid_w: int
    gather_idx: np.ndarray
    n_tokens: int
    target_h: int
    target_w: int


def select_best_resolution(
    orig_h: int, orig_w: int, pinpoints: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """HF select_best_resolution: maximize effective resolution, then minimize
    wasted area."""
    best, best_key = None, None
    for th, tw in pinpoints:
        scale = min(tw / orig_w, th / orig_h)
        dw, dh = int(orig_w * scale), int(orig_h * scale)
        effective = min(dw * dh, orig_w * orig_h)
        wasted = tw * th - effective
        key = (effective, -wasted)
        if best_key is None or key > best_key:
            best, best_key = (th, tw), key
    return best


def plan_anyres(orig_h: int, orig_w: int, cfg: LlavaConfig) -> AnyresPlan:
    """Anyres layout plan (HF pack_image_features spatial_unpad semantics):
    tiles reshaped to a [grid_h*24, grid_w*24] feature map, unpadded to the
    original aspect ratio, one image_newline appended per row, flattened, and
    prefixed by the base tile's 576 features."""
    pside = cfg.patches_per_side
    th, tw = select_best_resolution(orig_h, orig_w, cfg.image_grid_pinpoints)
    grid_h, grid_w = th // cfg.vision.image_size, tw // cfg.vision.image_size
    cur_h, cur_w = grid_h * pside, grid_w * pside

    # unpad (HF unpad_image): the feature map holds the image scaled to fit the
    # canvas with symmetric padding; crop back to the content region.
    if orig_w / orig_h > cur_w / cur_h:
        new_h = int(round(orig_h * (cur_w / orig_w), 7))
        pad = (cur_h - new_h) // 2
        y0, y1, x0, x1 = pad, cur_h - pad, 0, cur_w
    else:
        new_w = int(round(orig_w * (cur_h / orig_h), 7))
        pad = (cur_w - new_w) // 2
        y0, y1, x0, x1 = 0, cur_h, pad, cur_w - pad

    n_base = pside * pside
    newline_idx = n_base + cur_h * cur_w
    rows = [np.concatenate([n_base + y * cur_w + np.arange(x0, x1), [newline_idx]])
            for y in range(y0, y1)]
    tile_part = np.concatenate(rows) if rows else np.zeros((0,), np.int64)
    gather = np.concatenate([np.arange(n_base), tile_part]).astype(np.int32)
    return AnyresPlan(grid_h=grid_h, grid_w=grid_w, gather_idx=gather,
                      n_tokens=int(gather.shape[0]), target_h=th, target_w=tw)


# ---------------------------------------------------------------------------
# Device-side preprocessing + encoding
# ---------------------------------------------------------------------------


def normalize(pixels01: torch.Tensor) -> torch.Tensor:
    """[..., 3] floats in [0,1] -> CLIP-normalized."""
    mean = torch.as_tensor(CLIP_MEAN, device=pixels01.device)
    std = torch.as_tensor(CLIP_STD, device=pixels01.device)
    return (pixels01 - mean) / std


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of the JAX package's bicubic
    resize along one axis (``jax.image.resize``'s ``compute_weight_mat``
    with the Keys cubic kernel, antialiased, translation 0)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    x = x / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, np.float32(0.0), w).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def resize_image(pixels01: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bicubic resize of [..., H, W, 3] float32 pixels (an image, or video
    frames) to [..., h, w, 3], as the JAX package's ``jax.image.resize(...,
    "bicubic")`` resizes them: an axis whose size is unchanged is left as
    it is."""
    x = pixels01
    dev = x.device
    if x.shape[-3] != h:
        wh = torch.as_tensor(resize_weights(x.shape[-3], h), device=dev)
        x = torch.einsum("...hwc,hH->...Hwc", x, wh)
    if x.shape[-2] != w:
        ww = torch.as_tensor(resize_weights(x.shape[-2], w), device=dev)
        x = torch.einsum("...hwc,wW->...hWc", x, ww)
    return x


def preprocess_anyres(pixels01: torch.Tensor, plan: AnyresPlan,
                      cfg: LlavaConfig) -> torch.Tensor:
    """Base tile + anyres tiles: [1 + grid_h*grid_w, 336, 336, 3] normalized.

    LlavaNextImageProcessor on the device: base = square resize to 336;
    tiles = aspect-preserving resize onto the (target_h, target_w) canvas
    with symmetric zero padding, then a grid split."""
    size = cfg.vision.image_size
    base = normalize(resize_image(pixels01, size, size))

    oh, ow = pixels01.shape[0], pixels01.shape[1]
    scale = min(plan.target_w / ow, plan.target_h / oh)
    nh, nw = int(oh * scale), int(ow * scale)
    resized = resize_image(pixels01, nh, nw)
    pad_t = (plan.target_h - nh) // 2
    pad_l = (plan.target_w - nw) // 2
    canvas = pixels01.new_zeros((plan.target_h, plan.target_w, 3))
    canvas[pad_t:pad_t + nh, pad_l:pad_l + nw] = resized
    canvas = normalize(canvas)
    tiles = canvas.reshape(plan.grid_h, size, plan.grid_w, size, 3)
    tiles = tiles.permute(0, 2, 1, 3, 4).reshape(-1, size, size, 3)
    return torch.cat([base[None], tiles], dim=0)


def projector(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """multi_modal_projector: linear -> exact (erf) GELU in float32 -> linear."""
    x = qdot(feats, params["proj_w1"]).to(feats.dtype) + params["proj_b1"]
    x = F.gelu(x.float()).to(feats.dtype)
    return qdot(x, params["proj_w2"]).to(x.dtype) + params["proj_b2"]


def encode_image(params: dict, cfg: LlavaConfig, tiles: torch.Tensor,
                 plan: Optional[AnyresPlan]) -> torch.Tensor:
    """Tiles [n_tiles, 336, 336, 3] (normalized, base first) -> packed image
    features [n_tokens, text_hidden]; all tiles go through the tower in one
    call.  plan=None => LLaVA-1.5: one tile, no packing (576 tokens, CLS
    dropped)."""
    feats = clip_vit.forward(params["vision"], cfg.vision, tiles)[:, 1:]
    feats = projector(params, feats)  # [n, 576, text_hidden]
    d = feats.shape[-1]
    if plan is None:
        return feats.reshape(-1, d)
    pside = cfg.patches_per_side
    tile_feats = feats[1:].reshape(plan.grid_h, plan.grid_w, pside, pside, d)
    tile_feats = tile_feats.permute(0, 2, 1, 3, 4).reshape(-1, d)
    src = torch.cat([feats[0], tile_feats, params["image_newline"][None]], dim=0)
    idx = torch.as_tensor(plan.gather_idx, dtype=torch.int64, device=src.device)
    return src.index_select(0, idx)


def merge_image_embeds(text_embeds: torch.Tensor, image_feats: torch.Tensor,
                       image_positions: torch.Tensor) -> torch.Tensor:
    """The features written over the rows at ``image_positions`` (HF's
    masked_scatter)."""
    return text_embeds.index_copy(0, image_positions.to(torch.int64),
                                  image_feats.to(text_embeds.dtype))


def init_projector_params(generator: torch.Generator, vdim: int, tdim: int,
                          device="cuda", dtype=torch.bfloat16) -> dict:
    """Random projector and ``image_newline`` drawn on ``device`` from
    ``generator``: N(0, 0.02) matrices, zero biases."""

    def w(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    return {
        "proj_w1": w((vdim, tdim)),
        "proj_b1": torch.zeros((tdim,), dtype=dtype, device=device),
        "proj_w2": w((tdim, tdim)),
        "proj_b2": torch.zeros((tdim,), dtype=dtype, device=device),
        "image_newline": w((tdim,)),
    }
