"""CLIP ViT vision tower (LLaVA-1.5/1.6's ``vision_tower``).

Port of the JAX package's ``models/clip_vit.py``: the patch "convolution" as
one product over flattened patches, a pre-norm transformer with biased
q/k/v/o and MLP products and quick-GELU, returning the hidden states of the
feature layer (LLaVA's ``vision_feature_layer`` -2) with the CLS token kept.

Tiles ride a leading dimension: ``forward`` takes ``[n_tiles, H, W, 3]`` and
encodes the base tile and every anyres tile in one call (the JAX package
``vmap``s the single-tile forward).  The layer loop stops after the feature
layer: the layers after it do not change what is returned.

Each step keeps the JAX dtypes: products return float32 (``ops.quant.qdot``)
and are rounded to the activation dtype before their bias is added in that
dtype; LayerNorm computes in float32; the attention scores are float32 and
the probabilities are cast to v's dtype before P.V.

Weight layout (as the JAX pytree):
  patch_w: [patch*patch*3, width]        class_embed: [width]
  pos_embed: [num_pos, width]            pre_norm_{w,b}: [width] (float32)
  layers: ln1_{w,b}, ln2_{w,b}: [L, width] (float32)
          wq/wk/wv/wo: [L, width, width], bq/bk/bv/bo: [L, width]
          w_fc1: [L, width, mlp], b_fc1: [L, mlp]
          w_fc2: [L, mlp, width], b_fc2: [L, width]
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.quant import qdot


@dataclass(frozen=True)
class ClipVisionConfig:
    """The defaults are openai/clip-vit-large-patch14-336's published widths."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    feature_layer: int = -2  # LLaVA vision_feature_layer

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(_scalar(1.702, x) * x)


def _scalar(v: float, x: torch.Tensor) -> torch.Tensor:
    """A Python constant in ``x``'s dtype: JAX rounds a weakly typed scalar
    to the array's dtype before the product; torch would multiply by the
    float32 value."""
    return torch.tensor(v, dtype=x.dtype, device=x.device)


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[n, H, W, 3] -> [n, num_patches, patch*patch*3] in conv-weight order
    (C, ph, pw): HF's patch embedding weight is [width, 3, patch, patch]."""
    n, h, w, _ = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(n, gh, patch, gw, patch, 3)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [n, gh, gw, C, ph, pw]
    return x.reshape(n, gh * gw, 3 * patch * patch)


def _biased(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` as JAX computes it: the product rounded to x's dtype,
    then the bias added in that dtype."""
    return qdot(x, w).to(x.dtype) + b


def forward(params: dict, cfg: ClipVisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [n_tiles, H, W, 3] normalized; returns [n_tiles, 1 +
    num_patches, width], the hidden states after layer index
    ``num_hidden_layers + feature_layer`` (CLS token first)."""
    if not -cfg.num_hidden_layers <= cfg.feature_layer < 0:
        raise ValueError(f"feature_layer {cfg.feature_layer} must index one of the "
                         f"{cfg.num_hidden_layers} layers from the end")
    dtype = params["patch_w"].dtype
    patches = patchify(pixels, cfg.patch_size).to(dtype)
    embeds = qdot(patches, params["patch_w"]).to(dtype)
    n = embeds.shape[0]
    cls = params["class_embed"].to(dtype).expand(n, 1, -1)
    x = torch.cat([cls, embeds], dim=1) + params["pos_embed"].to(dtype)
    x = layer_norm(x, params["pre_norm_w"], params["pre_norm_b"], cfg.layer_norm_eps)

    h, d = cfg.num_attention_heads, cfg.head_dim
    s = x.shape[1]
    lp_all = params["layers"]
    scale = _scalar(d ** -0.5, x)
    for li in range(cfg.num_hidden_layers + cfg.feature_layer + 1):
        lp = {k: v[li] for k, v in lp_all.items()}
        residual = x
        normed = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        q = _biased(normed, lp["wq"], lp["bq"])
        k = _biased(normed, lp["wk"], lp["bk"])
        v = _biased(normed, lp["wv"], lp["bv"])
        q = q.reshape(n, s, h, d).transpose(1, 2) * scale
        k = k.reshape(n, s, h, d).transpose(1, 2)
        v = v.reshape(n, s, h, d).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        attn = torch.matmul(probs.float(), v.float()).to(v.dtype)
        attn = attn.transpose(1, 2).reshape(n, s, h * d)
        x = residual + _biased(attn, lp["wo"], lp["bo"]).to(x.dtype)

        residual = x
        normed = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        mlp = quick_gelu(_biased(normed, lp["w_fc1"], lp["b_fc1"]))
        x = residual + _biased(mlp, lp["w_fc2"], lp["b_fc2"]).to(x.dtype)
    return x


def init_params(cfg: ClipVisionConfig, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random parameter dict drawn on ``device`` from ``generator``:
    N(0, 0.02) matrices and embeddings, zero biases, float32 unit norms."""
    w_, l, m = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    pp = cfg.patch_size * cfg.patch_size * 3

    def w(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(0.02)

    def const(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    f32 = torch.float32
    return {
        "patch_w": w((pp, w_)),
        "class_embed": w((w_,)),
        "pos_embed": w((1 + cfg.num_patches, w_)),
        "pre_norm_w": const((w_,), 1.0, f32),
        "pre_norm_b": const((w_,), 0.0, f32),
        "layers": {
            "ln1_w": const((l, w_), 1.0, f32),
            "ln1_b": const((l, w_), 0.0, f32),
            "ln2_w": const((l, w_), 1.0, f32),
            "ln2_b": const((l, w_), 0.0, f32),
            "wq": w((l, w_, w_)),
            "wk": w((l, w_, w_)),
            "wv": w((l, w_, w_)),
            "wo": w((l, w_, w_)),
            "bq": const((l, w_), 0.0),
            "bk": const((l, w_), 0.0),
            "bv": const((l, w_), 0.0),
            "bo": const((l, w_), 0.0),
            "w_fc1": w((l, w_, m)),
            "b_fc1": const((l, m), 0.0),
            "w_fc2": w((l, m, w_)),
            "b_fc2": const((l, w_), 0.0),
        },
    }
