"""Token ids and pixels of the traffic's requests, made from the seed.

The benchmark makes every input itself and hands the same objects to the
program and to the reference.  A configuration's file says which ids are
ordinary text (``text_id_range``) and, for a vision model, its special ids
and ``vision_config``; an image request is laid out as Qwen2.5-VL's chat
template lays one out: text, <vision_start>, one placeholder per merged
patch, <vision_end>, text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .traffic import Request


@dataclass
class Input:
    """One request as both sides receive it."""

    index: int
    input_ids: np.ndarray  # int64 [prompt_len]
    cap: int
    image: Optional[torch.Tensor] = None  # [h, w, 3] float32 in [0, 1]
    image_tokens: int = 0  # placeholders of the image

    @property
    def prompt_len(self) -> int:
        return int(self.input_ids.shape[0])


def image_tokens(cfg: dict, size) -> int:
    """Merged patches of an image the processor keeps at its size."""
    v = cfg["vision_config"]
    h, w = size
    p, m = v["patch_size"], v["spatial_merge_size"]
    budget = cfg["image_processor"]
    if h % (p * m) or w % (p * m) or not budget["min_pixels"] <= h * w <= budget["max_pixels"]:
        raise ValueError(f"image {h}x{w}: the processor would resize it (sides must be "
                         f"multiples of {p * m}, the area within {budget})")
    return (h // p) * (w // p) // (m * m)


def make_inputs(cfg: dict, reqs: List[Request], seed: int, device) -> List[Input]:
    """Ids from numpy and pixels from a torch generator on ``device``, both
    seeded from ``seed``, in request order."""
    rng = np.random.default_rng([int(seed), 0x1D5])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    lo, hi = cfg["text_id_range"]
    out = []
    for r in reqs:
        text = rng.integers(lo, hi, r.text_tokens)
        if r.image is None:
            out.append(Input(r.index, text.astype(np.int64), r.cap))
            continue
        n = image_tokens(cfg, r.image)
        head = max(1, r.text_tokens // 2)
        ids = np.concatenate([text[:head], [cfg["vision_start_token_id"]],
                              np.full(n, cfg["image_token_id"]),
                              [cfg["vision_end_token_id"]], text[head:]])
        pixels = torch.rand((*r.image, 3), generator=gen, device=device,
                            dtype=torch.float32)
        out.append(Input(r.index, ids.astype(np.int64), r.cap, pixels, n))
    return out
