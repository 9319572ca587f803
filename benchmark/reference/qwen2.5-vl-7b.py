"""Plain reference of Qwen2.5-VL-7B-Instruct: the windowed vision tower,
the image rows merged into the prompt, and the text decoder under M-RoPE
(``_plain``), in float32 with TF32 off; and the weight maker that both the
program and this reference take their weights from."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import _plain


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Target, draft and tower from ``seed``: N(0, initializer_range) drawn
    on ``device`` in the served dtype, three calls in all."""
    gen = _plain.generator(seed, device)
    dtype = getattr(torch, cfg["torch_dtype"])
    std = cfg["initializer_range"]
    target = _plain.make_decoder(cfg, gen, device, dtype, std)
    return {"target": target,
            "draft": _plain.make_draft(cfg["draft"], target["embed"], gen, device, dtype, std),
            "vision": _plain.make_tower(cfg["vision_config"], gen, device, dtype, std)}


def _forward(cfg, weights, inp, served: np.ndarray, precision: str) -> torch.Tensor:
    ids = inp.input_ids
    n, s = len(ids), len(served)
    w = weights["target"]
    dev = w["embed"].device
    seq = torch.as_tensor(np.concatenate([ids, served[:-1]]), device=dev)
    embeds = w["embed"][seq].to(torch.float32)
    vc = cfg["vision_config"]
    grids = []
    if inp.image is not None:
        feats = _plain.vision_features(weights["vision"], vc, inp.image, precision)
        at = torch.as_tensor(np.nonzero(ids == cfg["image_token_id"])[0], device=dev)
        embeds[at] = feats
        grids = [(1, inp.image.shape[0] // vc["patch_size"],
                  inp.image.shape[1] // vc["patch_size"])]
    pos, delta = _plain.mrope_positions(ids, grids, cfg)
    later = np.tile(np.arange(n, n + s - 1) + delta, (3, 1))
    pos = torch.as_tensor(np.concatenate([pos, later], axis=1), device=dev)
    rows = torch.arange(n - 1, n - 1 + s, device=dev)
    return _plain.decoder_logits(w, cfg, embeds, pos, rows, precision)


@torch.no_grad()
def gaps(cfg: dict, weights: dict, inp, served: np.ndarray, control=None):
    """Per served token, the reference's best logit minus its logit of the
    served token; with ``control`` ("fp8", "bf16" or "bf16act"), also of the token the
    reference computed at that precision puts first at each position."""
    with _plain.exact_float32():
        ref = _forward(cfg, weights, inp, served, "float32")
        out = _plain.served_gaps(ref, torch.as_tensor(served, device=ref.device))
        ctrl = None
        if control:
            ctrl = _plain.served_gaps(ref, None, _forward(cfg, weights, inp, served, control))
    return out, ctrl
