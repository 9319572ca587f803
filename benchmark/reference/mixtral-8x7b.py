"""Plain reference of Mixtral-8x7B: the decoder with its sparse expert
block (router softmax, the top-2 experts per token, their weights
renormalised), in float32 with TF32 off (``_plain``); and the weight maker
that both the program and this reference take their weights from."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import _plain


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Target and draft from ``seed``: N(0, initializer_range) drawn on
    ``device`` in the served dtype, two calls in all."""
    gen = _plain.generator(seed, device)
    dtype = getattr(torch, cfg["torch_dtype"])
    std = cfg["initializer_range"]
    target = _plain.make_decoder(cfg, gen, device, dtype, std)
    return {"target": target,
            "draft": _plain.make_draft(cfg["draft"], target["embed"], gen, device, dtype, std)}


def _forward(cfg, weights, inp, served: np.ndarray, precision: str) -> torch.Tensor:
    ids = inp.input_ids
    n, s = len(ids), len(served)
    w = weights["target"]
    dev = w["embed"].device
    seq = torch.as_tensor(np.concatenate([ids, served[:-1]]), device=dev)
    embeds = w["embed"][seq].to(torch.float32)
    pos = torch.arange(n + s - 1, device=dev)
    rows = torch.arange(n - 1, n - 1 + s, device=dev)
    return _plain.decoder_logits(w, cfg, embeds, pos, rows, precision)


@torch.no_grad()
def gaps(cfg: dict, weights: dict, inp, served: np.ndarray, control=None):
    """As ``qwen2.5-vl-7b.gaps``: the served tokens' gaps, and with
    ``control`` ("fp8", "bf16" or "bf16act") those of that precision's first choices."""
    with _plain.exact_float32():
        ref = _forward(cfg, weights, inp, served, "float32")
        out = _plain.served_gaps(ref, torch.as_tensor(served, device=ref.device))
        ctrl = None
        if control:
            ctrl = _plain.served_gaps(ref, None, _forward(cfg, weights, inp, served, control))
    return out, ctrl
