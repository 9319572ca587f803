"""Logits processing and token sampling, the JAX package's
``ops/sampling.py`` in plain torch ops (XLA does all of it there).

Temperature -> repetition penalty -> top-p -> top-k, in HF's order, on the
last axis, broadcasting over leading dims: the same code warps the
``[B?, T, vocab]`` verify logits in one pass.  The per-request knobs of
``sample_probs_dyn`` are tensors shaped like the logits' leading dims
before the row axis (``[]`` for one request, ``[B]`` for slots).

Repetition penalty: the committed-token history is a ``[B?, vocab+1]`` bool
``seen`` mask (row ``vocab`` is a trash row for masked scatters).  The spec
path applies it at round granularity (every tree position against the mask
as of the round's start, updated after commit); the AR path per token, as
in the JAX package.

Tie orders follow the JAX package: the top-p sort takes tied logits in
descending index order (JAX sorts ascending and reverses), and
``categorical`` takes the first maximum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import rng

NEG_INF = -1e9


def _lead(x, ref: torch.Tensor) -> torch.Tensor:
    """A per-request knob broadcast against ``ref`` ``[*lead, ..., vocab]``:
    ``[*lead]`` -> ``[*lead, 1, ..., 1]``."""
    x = torch.as_tensor(x, device=ref.device)
    return x.reshape(x.shape + (1,) * (ref.dim() - x.dim()))


def _seen_rows(seen: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``seen[..., :vocab]`` (``[*lead, vocab+1]``) broadcast against
    ``ref`` ``[*lead, (T,) vocab]``."""
    s = seen[..., : ref.shape[-1]]
    while s.dim() < ref.dim():
        s = s.unsqueeze(-2)
    return s


def process_logits(
    logits: torch.Tensor,  # [..., vocab] float32
    temperature: float = 0.0,
    top_p: float = 0.0,
    top_k: int = 0,
    repetition_penalty: float = 1.0,
    seen: Optional[torch.Tensor] = None,  # [B?, vocab+1] bool
) -> torch.Tensor:
    """Temperature, repetition, top-p and top-k warps in HF order, each
    selected by its static value (temperature <= 1e-5 is greedy, and the
    caller does not come here)."""
    if temperature >= 1e-5 and temperature != 1.0:
        logits = logits / temperature
    if repetition_penalty != 1.0 and seen is not None:
        logits = apply_repetition_penalty(logits, seen, repetition_penalty)
    if 1e-8 <= top_p < 1.0:
        logits = _top_p_warp(logits, top_p)
    if top_k > 0:
        logits = _top_k_warp(logits, int(top_k))
    return logits


def sample_probs_dyn(
    logits: torch.Tensor,  # [*lead, (T,) vocab] float32
    temperature: torch.Tensor,  # [*lead] f32 per request
    top_p: torch.Tensor,
    repetition_penalty: torch.Tensor,
    seen: Optional[torch.Tensor] = None,  # [*lead, vocab+1] bool
    top_k: int = 0,  # static bucket: the sort's width
    top_k_dyn: Optional[torch.Tensor] = None,  # [*lead] per-request k (as f32)
) -> torch.Tensor:
    """Per-request sampling transform -> probabilities, every knob but the
    ``top_k`` bucket a tensor: one pass serves a batch mixing greedy,
    sampled and penalized slots.

    A greedy slot (temperature <= 1e-5) gets the one-hot argmax of the raw
    logits, so the acceptance walk reduces to the greedy walk.  A slot with
    no top-p (<= 0 or >= 1) takes the unwarped logits, a temperature of 1.0
    divides exactly and a penalty of 1.0 is an identity: each equals the
    static path bit for bit.  ``top_k_dyn`` masks by the k-th value of the
    bucket's sort (k <= 0 disables the warp for that slot; k clamps to the
    bucket)."""
    temperature = _lead(temperature, logits)
    greedy = temperature <= 1e-5
    x = logits / torch.where(greedy, torch.ones_like(temperature), temperature)
    if seen is not None:
        rp = _lead(repetition_penalty, logits)
        pen = torch.where(x > 0, x / rp, x * rp)
        x = torch.where(_seen_rows(seen, x), pen, x)
    top_p = _lead(top_p, logits)
    no_p = (top_p <= 1e-8) | (top_p >= 1.0)
    eff_p = torch.where(no_p, torch.ones_like(top_p), top_p)
    x = torch.where(no_p, x, _top_p_warp(x, eff_p))
    if top_k_dyn is not None and top_k > 0:
        x = _top_k_warp_dyn(x, _lead(top_k_dyn, logits), int(top_k))
    elif top_k > 0:
        x = _top_k_warp(x, int(top_k))
    probs = torch.softmax(x, dim=-1)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (cols == torch.argmax(logits, dim=-1, keepdim=True)).to(probs.dtype)
    return torch.where(greedy, onehot, probs)


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: for every seen token, positive
    logits are divided by ``penalty`` and negative ones multiplied."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(_seen_rows(seen, logits), pen, logits)


def seen_mask(vocab_size: int, token_ids) -> np.ndarray:
    """Host-side ``[vocab+1]`` bool mask of the tokens in ``token_ids`` (the
    prompt); out-of-range ids land in the trash row, which stays False."""
    m = np.zeros(vocab_size + 1, bool)
    ids = np.clip(np.asarray(token_ids, np.int64), 0, vocab_size)
    m[ids] = True
    m[vocab_size] = False
    return m


def update_seen(seen: torch.Tensor, tokens: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """``seen`` with the valid ``tokens [B?, n]`` set (a new tensor);
    invalid rows go to the trash row."""
    idx = torch.where(valid, tokens.to(torch.int64), seen.shape[-1] - 1)
    return seen.scatter(-1, idx, True)


def mark_seen(seen: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``seen`` with ``token [B?]`` set (a new tensor)."""
    return seen.scatter(-1, token.to(torch.int64).unsqueeze(-1), True)


def _top_p_warp(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Position-based nucleus mask (HF TopPLogitsWarper on tied logits: only
    in-nucleus sorted positions survive).  The sort is ascending and stable,
    then reversed, so tied logits come in descending index order as in JAX."""
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p  # keep the first token crossing the mass
    warped_sorted = torch.where(keep_sorted, sorted_logits, NEG_INF)
    return torch.empty_like(logits).scatter_(-1, order, warped_sorted)


def _top_k_warp(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    top_k = min(top_k, logits.shape[-1])  # HF clamps (TopKLogitsWarper)
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, NEG_INF)


def _top_k_warp_dyn(logits: torch.Tensor, k: torch.Tensor, max_k: int) -> torch.Tensor:
    """Per-request k over a static ``max_k`` bucket: the threshold is the
    k-th value of one sort to the bucket; every logit >= it survives, and
    k <= 0 keeps all logits."""
    max_k = min(max_k, logits.shape[-1])
    vals = torch.topk(logits, max_k, dim=-1).values  # descending
    idx = torch.clamp(k, 1, max_k).to(torch.int64) - 1
    kth = torch.gather(vals, -1, idx.expand(*vals.shape[:-1], 1))
    return torch.where((k <= 0) | (logits >= kth), logits, NEG_INF)


def categorical(noise: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max draw from ``probs [..., vocab]`` given Gumbel
    ``noise`` of the same shape: int32 ``[...]``, the first maximum
    (``jax.random.categorical`` over ``log(max(p, 1e-20))``)."""
    logp = torch.log(torch.clamp(probs, min=1e-20))
    return torch.argmax(logp + noise, dim=-1).to(torch.int32)


def sample_categorical(key: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``probs [*key.shape, vocab]`` from ``key``."""
    return categorical(rng.gumbel(key, probs.shape[key.dim():]), probs)
