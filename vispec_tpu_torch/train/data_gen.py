"""Training-data generation: target-model continuations with hidden-state
capture.

A sample is a prompt plus the target's own greedy continuation: the draft
trains on text the target generated, never on ground truth.  Per position
it keeps the last-layer hidden state, the input embedding, a loss mask (1
on the continuation) and an image mask (the vision-token rows), saved as
``data_{index}.npz`` shards.

The prompt runs through one prefill (the plain causal ``attend``); every
continuation step is the AR step of ``spec/loop.py`` over the target's
cache, so its attention is the length-aware kernel (``verify_attention``,
one launch a layer a step on the card).  Steps are queued in chunks: the
host reads only each chunk's small token vector, one chunk behind the chunk
in flight, and the hidden and embedding stacks stay on the device until one
copy at the end.  ``pipelined=False`` keeps a per-token synced loop as the
oracle.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import llama
from ..ops import kv_cache as kv
from ..ops.attention import causal_mask
from ..spec.loop import _take, target_forward


def _prefill_with_hidden(tparams, tcfg, embeds, real_len: int, cache,
                         position_ids=None, mesh=None):
    """(hidden [pad_len, D], first token [] int32, cache advanced to
    ``real_len``).  ``position_ids`` ``[3, pad_len]`` are M-RoPE ids; the
    dynamic-NTK stretch takes the real prompt length, as the inference
    prefills do."""
    pad_len, device = embeds.shape[0], embeds.device
    mrope = position_ids is not None and position_ids.dim() == 2
    pos = (torch.arange(pad_len, dtype=torch.int32, device=device) if position_ids is None
           else torch.as_tensor(position_ids, device=device).to(torch.int32))
    mask = causal_mask(pad_len, cache.max_len, 0, device)
    real = torch.tensor(real_len, dtype=torch.int32, device=device)
    hidden, cache = target_forward(tparams, tcfg, embeds, pos, cache, mask, seq_len=real,
                                   mrope_ids=mrope, mesh=mesh)
    cache = kv.advance(cache, real)
    logits = llama.lm_head(tparams, _take(hidden, real - 1), mesh)
    return hidden, torch.argmax(logits).to(torch.int32), cache


def _step_with_hidden(tparams, tcfg, token, embeds, cache, rope_delta: int = 0,
                      mesh=None):
    """One greedy AR step of ``token`` (its embedding ``embeds [1, D]``):
    (hidden [D], next token, cache).  The position is the cache row +
    ``rope_delta``; attention goes through the verify kernel's region."""
    pos = cache.length.reshape(1) + rope_delta
    ones = torch.ones((1, 1), dtype=torch.bool, device=embeds.device)
    hidden, cache = target_forward(tparams, tcfg, embeds, pos, cache, None,
                                   region=(cache.length, ones), seq_len=cache.length + 1,
                                   mesh=mesh)
    cache = kv.advance(cache, 1)
    logits = llama.lm_head(tparams, hidden[0], mesh)
    return hidden[0], torch.argmax(logits).to(torch.int32), cache


def _scan_steps_with_hidden(tparams, tcfg, token, cache, chunk: int, rope_delta: int,
                            mesh=None):
    """``chunk`` greedy AR steps queued without a host read.  Each step
    records its INPUT token, that token's embedding and the hidden state it
    produced.  Returns (next token, cache, tokens [chunk], embeds [chunk,
    D], hiddens [chunk, D])."""
    toks, embs, hids = [], [], []
    for _ in range(chunk):
        embeds = llama.embed(tparams, token.reshape(1), mesh)
        h, nxt, cache = _step_with_hidden(tparams, tcfg, token, embeds, cache, rope_delta,
                                          mesh)
        toks.append(token)
        embs.append(embeds[0])
        hids.append(h)
        token = nxt
    return token, cache, torch.stack(toks), torch.stack(embs), torch.stack(hids)


def _host(x: torch.Tensor) -> np.ndarray:
    """A float tensor as a float32 numpy array (bfloat16 values are exact
    in float32; numpy has no bfloat16)."""
    return x.detach().float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()


@torch.no_grad()
def generate_sample(
    tparams: dict,
    tcfg,
    prompt_embeds: torch.Tensor,  # [pad_len, D] (vision-merged, padded)
    prompt_len: int,
    image_mask: Optional[np.ndarray],
    cache: kv.KVCache,
    max_new_tokens: int = 512,
    eos_token_id: int = 2,
    position_ids: Optional[torch.Tensor] = None,  # [pad_len] or [3, pad_len]
    rope_delta: int = 0,
    chunk: int = 16,
    pipelined: bool = True,
    mesh=None,  # parallel.mesh.Mesh when tparams and cache are one rank's shards
) -> Tuple[Dict[str, np.ndarray], kv.KVCache]:
    """One training sample: prompt + greedy continuation with hiddens.

    Returns numpy arrays (floats in float32) and the cache:
      input_ids     [S]  (zeros over the prompt, the generated ids after)
      hidden_state  [S, D] — last-layer hidden per position
      inputs_embeds [S, D]
      loss_mask     [S] — 1 on the generated continuation
      image_mask    [S]
    """
    from ..spec.spec_model import _Readback

    cache = kv.reset(cache)
    hidden_prefix, token, cache = _prefill_with_hidden(
        tparams, tcfg, prompt_embeds, prompt_len, cache, position_ids=position_ids,
        mesh=mesh)
    delta = int(rope_delta)

    if not pipelined:
        hiddens = [_host(hidden_prefix[:prompt_len])]
        embeds = [_host(prompt_embeds[:prompt_len])]
        gen_ids = []
        for _ in range(max_new_tokens):
            tid = int(token)
            gen_ids.append(tid)
            if tid == eos_token_id:
                break
            e = llama.embed(tparams, token.reshape(1), mesh)
            h, token, cache = _step_with_hidden(tparams, tcfg, token, e, cache, delta, mesh)
            hiddens.append(_host(h)[None])
            embeds.append(_host(e))
        hidden_state = np.concatenate(hiddens, axis=0)
        inputs_embeds = np.concatenate(embeds, axis=0)
        gen_np = np.asarray(gen_ids, np.int32)
    else:
        # the pipeline queues up to one chunk past the budget: shrink the
        # chunk if the cache cannot hold that overshoot
        avail = int(cache.max_len) - prompt_len
        if max_new_tokens > avail - 2:
            max_new_tokens = max(0, avail - 2)
        while chunk > 1 and max_new_tokens + 2 * chunk > avail:
            chunk //= 2

        stream: list = []  # host copies of each chunk's input-token vector
        big: list = []  # (embeds, hiddens) per chunk, left on the device
        total = 0
        eos_idx: Optional[int] = None

        def process(tok_np) -> bool:
            nonlocal total, eos_idx
            stream.append(tok_np)
            if eos_idx is None:
                hit = np.nonzero(tok_np == eos_token_id)[0]
                if hit.size:
                    eos_idx = total + int(hit[0])
            total += len(tok_np)
            return eos_idx is not None or total >= max_new_tokens

        pending: Optional[_Readback] = None
        done = max_new_tokens <= 0
        while not done:
            token, cache, toks, embs, hids = _scan_steps_with_hidden(
                tparams, tcfg, token, cache, chunk, delta, mesh)
            big.append((embs, hids))
            batch = _Readback(toks)
            if pending is not None:
                done = process(np.asarray(pending.values(), np.int32))
            if not done:
                pending = batch

        if eos_idx is not None and eos_idx < max_new_tokens:
            n_exec = eos_idx
        else:
            n_exec = min(total, max_new_tokens)
        n_chunks = -(-n_exec // chunk) if n_exec else 0
        prefix_h = _host(hidden_prefix[:prompt_len])
        prefix_e = _host(prompt_embeds[:prompt_len])
        if n_chunks:
            embs_all = _host(torch.cat([b[0] for b in big[:n_chunks]]))
            hids_all = _host(torch.cat([b[1] for b in big[:n_chunks]]))
            hidden_state = np.concatenate([prefix_h, hids_all])[: prompt_len + n_exec]
            inputs_embeds = np.concatenate([prefix_e, embs_all])[: prompt_len + n_exec]
        else:
            hidden_state, inputs_embeds = prefix_h, prefix_e
        gen_np = (np.concatenate(stream) if stream
                  else np.zeros(0, np.int32))[:n_exec].astype(np.int32)

    s = hidden_state.shape[0]
    loss_mask = np.zeros(s, np.float32)
    loss_mask[prompt_len:] = 1.0
    img = np.zeros(s, bool)
    if image_mask is not None:
        img[: len(image_mask)] = np.asarray(image_mask)[:s]
    sample = {
        "input_ids": np.concatenate(
            [np.zeros(prompt_len, np.int32), gen_np[: s - prompt_len]]),
        "hidden_state": hidden_state,
        "inputs_embeds": inputs_embeds,
        "loss_mask": loss_mask,
        "image_mask": img,
    }
    return sample, cache


def generate_vlm_sample(
    model,  # spec.spec_model.SpecModel (a target-only load is enough)
    input_ids: np.ndarray,  # [L] with the image placeholders already expanded
    pixel_values=None,  # [H, W, 3] floats in [0, 1]
    image_size=None,
    pixel_values_videos=None,
    second_per_grid_ts: float = 1.0,
    max_new_tokens: int = 512,
    chunk: int = 16,
    pipelined: bool = True,
) -> Dict[str, np.ndarray]:
    """Image-conditioned training sample: the pixels run through the model's
    vision path (tower, projector, merge; ``SpecModel._padded_prompt``, the
    code inference uses), the target generates the continuation, and the
    saved ``image_mask`` marks the image-token span."""
    ids = np.asarray(input_ids, np.int64)
    l = int(ids.shape[0])
    pad_len = max(128, ((l + 127) // 128) * 128)
    prompt = model._padded_prompt(ids, pad_len, pixel_values, image_size,
                                  pixel_values_videos, second_per_grid_ts)
    position_ids = prompt.rope.position_ids if prompt.rope is not None else None
    rope_delta = prompt.rope.delta if prompt.rope is not None else 0

    budget = min(max_new_tokens, model.target_cache.max_len - l - 2)
    sample, cache = generate_sample(
        model.tparams, model.tcfg, prompt.embeds, l, prompt.image_mask,
        kv.reset(model.target_cache), max_new_tokens=budget,
        eos_token_id=model.eos_token_id, position_ids=position_ids,
        rope_delta=rope_delta, chunk=chunk, pipelined=pipelined, mesh=model.mesh)
    model.target_cache = kv.reset(cache)
    s = sample["hidden_state"].shape[0]
    merged_ids = sample["input_ids"].copy()
    merged_ids[:l] = ids[:s][: min(l, s)]
    sample["input_ids"] = merged_ids
    return sample


def save_sample(outdir: str, index: int, sample: Dict[str, np.ndarray]) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"data_{index}.npz")
    np.savez_compressed(path, **sample)
    return path


def load_sample(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
