"""Batched multi-request speculative decoding: B requests decoded together
in one slot-stacked ``SpecState``.

The JAX package batches by ``jax.vmap`` over the single-request round; here
the round itself takes a leading slot dim (``spec/loop.py``), so a batched
round issues about as many kernel launches as a single request's, whatever
B is, and every weight product takes all B slots' rows at once: the weights
stream once per round for the whole batch.  Every request carries its own
tree, caches, lengths, cap and done flag; finished requests keep executing
(latched by ``done``) until the batch drains.  A batch of one takes the
single-request round, as the JAX package does.

Prefill runs per request (``spec_prefill``, or ``medusa_prefill`` for a
Medusa model) straight into its slot of the stacked caches, which
``cache_pool`` keeps across calls; an image request (``prepare_requests``)
is prefilled with its own draft plan and span bucket, as ``specgenerate``
would prefill it, and a Qwen2.5-VL vision request with its own M-RoPE
position ids; its slot of the stacked state carries its ``rope_delta``.
At T > 0 request i draws from the key of ``seed + i``, as in the JAX
package; a slot's key rides the stacked state.

Under a ``mesh`` the parameters are one rank's shards (as the JAX package's
batch takes sharded parameters): the stacked caches hold the rank's layers
and KV heads, sized from the parameters' shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..ops import kv_cache as kv
from ..ops import rng
from ..utils import profiling
from . import loop as spec_loop
from . import round_graph
from .spec_model import (PaddedPrompt, _bucket, _Readback, output_rows,
                         padded_text_embeds, plan_prompt)


def _slot_cache(cache: kv.KVCache, i: int) -> kv.KVCache:
    """Slot ``i`` of a slot-stacked cache as a single-request cache: views of
    its buffers (writes land in the stacked storage), lengths zero."""
    zero = torch.zeros((), dtype=torch.int32, device=cache.k.device)
    return kv.KVCache(
        k=cache.k[i], v=cache.v[i], length=zero, real_length=zero.clone(),
        k_scale=None if cache.k_scale is None else cache.k_scale[i],
        v_scale=None if cache.v_scale is None else cache.v_scale[i])


def _local_cache_dims(params_layer: dict, head_dim: int) -> tuple:
    """(layers, KV heads) of the cache a (possibly sharded) layer stack
    writes: the stacked weights' leading dim and ``wk``'s heads."""
    shape = params_layer["wk"].shape  # a plain or quantized weight
    return (shape[0] if len(shape) == 3 else 1), shape[-1] // head_dim


def batched_prefill(
    tparams, dparams, tcfg: LlamaConfig, dcfg: DraftConfig, spec: SpecConfig,
    sampling: spec_loop.SamplingParams,
    requests: Sequence[dict],
    max_len: int,
    max_out: int,
    dtype=torch.bfloat16,
    seed: int = 0,
    cache_pool: Optional[List] = None,
    mparams: Optional[dict] = None,  # Medusa heads: medusa_prefill, no draft cache
    quantize_kv: bool = False,  # int8 target caches (kv_cache.init_cache)
    device="cuda",
    mesh=None,
) -> spec_loop.SpecState:
    """Prefill each request into its slot and return the slot-stacked state.

    Each request dict (``prepare_requests``) carries ``embeds`` [pad, D],
    ``real_len``, ``plan`` and ``max_span`` (a Medusa prefill takes neither
    plan nor draft cache), and optionally ``rope`` (a Qwen2.5-VL vision
    prompt's ``PromptRope``).  ``cache_pool`` is a list holding one (target,
    draft) pair of slot-stacked caches, reused across calls and replaced by
    a larger pair when a batch outgrows it (a Medusa batch leaves the draft
    entry None); None allocates fresh buffers.  At T > 0 request i draws
    from the key of ``seed + i``."""
    b = len(requests)
    medusa = mparams is not None
    if (cache_pool and cache_pool[0][0].k.shape[0] >= b
            and (medusa or cache_pool[0][1] is not None)):
        tc_all, dc_all = cache_pool[0]
    else:
        if cache_pool:
            cache_pool.clear()  # free the smaller pair before the larger one lands
        t_layers, t_heads = _local_cache_dims(tparams["layers"], tcfg.head_dim)
        tc_all = kv.init_cache(t_layers, t_heads, max_len, tcfg.head_dim, dtype, device,
                               quantized=quantize_kv, slots=b)
        dc_all = None if medusa else kv.init_cache(
            1, _local_cache_dims(dparams["layer"], dcfg.head_dim)[1], max_len,
            dcfg.head_dim, dtype, device, slots=b)
        if cache_pool is not None:
            cache_pool.append((tc_all, dc_all))
    keys = [None] * b if sampling.greedy else rng.keys(
        [seed + i for i in range(b)], device).unbind(0)

    def prefill(i, req):
        if medusa:
            return spec_loop.medusa_prefill(tparams, mparams, tcfg, spec, sampling,
                                            req["embeds"], req["real_len"],
                                            _slot_cache(tc_all, i), max_out, key=keys[i],
                                            mesh=mesh)
        return spec_loop.spec_prefill(
            tparams, dparams, tcfg, dcfg, spec, req["plan"], sampling, req["embeds"],
            _slot_cache(tc_all, i), _slot_cache(dc_all, i), max_out, req["max_span"],
            key=keys[i], rope=req.get("rope"), mesh=mesh)

    states = [prefill(i, req) for i, req in enumerate(requests)]
    # the rows already sit in the stacked buffers: stack only the rest (a
    # Medusa state's dummy draft caches are stacked as they are)
    stacked = spec_loop.stack_states(
        [st._replace(target_cache=None, draft_cache=st.draft_cache if medusa else None)
         for st in states])

    def lengths(all_cache: kv.KVCache, caches) -> kv.KVCache:
        return kv.KVCache(
            k=all_cache.k[:b], v=all_cache.v[:b],
            length=torch.stack([c.length.to(torch.int32) for c in caches]),
            real_length=torch.stack([c.real_length.to(torch.int32) for c in caches]),
            k_scale=None if all_cache.k_scale is None else all_cache.k_scale[:b],
            v_scale=None if all_cache.v_scale is None else all_cache.v_scale[:b])

    return stacked._replace(
        target_cache=lengths(tc_all, [st.target_cache for st in states]),
        draft_cache=stacked.draft_cache if medusa else lengths(
            dc_all, [st.draft_cache for st in states]))


def text_prompt(tparams, device="cuda", mesh=None):
    """The ``padded_prompt`` of ``prepare_requests`` for token lists:
    ``padded_text_embeds`` in ``SpecModel._padded_prompt``'s signature."""
    def padded(ids, pad, pixel_values=None, image_size=None, pixel_values_videos=None,
               second_per_grid_ts=1.0):
        if pixel_values is not None or pixel_values_videos is not None:
            raise ValueError("image and video requests need a model with a vision tower "
                             "(SpecModel.specgenerate_batch)")
        return PaddedPrompt(padded_text_embeds(tparams, ids, pad, device, mesh), None, None,
                            0, None)
    return padded


def prepare_requests(dcfg: DraftConfig, requests: Sequence, max_len: int, slack: int,
                     padded_prompt, device="cuda") -> List[dict]:
    """Prefill inputs of each request (a token list, or a dict with
    ``input_ids`` and, for a vision prompt, ``pixel_values`` /
    ``image_size`` or ``pixel_values_videos`` / ``second_per_grid_ts``),
    each padded to its own 128-row bucket and planned at its own span
    buckets, as ``specgenerate`` pads and plans it.
    ``padded_prompt`` is ``SpecModel._padded_prompt``, which merges the
    image features, or ``text_prompt`` for token lists.  (The JAX package
    shares the longest prompt's bucket and span bucket so that one compiled
    prefill serves the batch; an eager prefill gains nothing from that, and
    its own buckets give each request the same prefill as a single-request
    run.)"""
    requests = [r if isinstance(r, dict) else {"input_ids": r} for r in requests]
    prompts = [np.asarray(r["input_ids"], np.int64) for r in requests]
    longest = max(len(p) for p in prompts)
    if _bucket(longest) > max_len or longest + slack > max_len:
        raise ValueError(
            f"longest prompt {longest} (bucketed {_bucket(longest)}) too long for "
            f"max_len={max_len} (needs {slack} rows of tree headroom)")
    out = []
    for r, ids in zip(requests, prompts):
        l, pad = len(ids), _bucket(len(ids))
        prompt = padded_prompt(ids, pad, r.get("pixel_values"), r.get("image_size"),
                               r.get("pixel_values_videos"),
                               r.get("second_per_grid_ts", 1.0))
        plan, max_span = plan_prompt(dcfg, prompt.shifted, prompt.n_spans, l, pad, device)
        out.append(dict(embeds=prompt.embeds, real_len=l, plan=plan, max_span=max_span,
                        rope=prompt.rope))
    return out


def _unit(round_fn):
    """``round_fn`` over a batch of one through the single-request round
    (and its kernel), as the JAX package squeezes its unit batch."""
    def one(states, eos, caps):
        state = round_fn(spec_loop.map_states(lambda x: x[0], states), eos,
                         caps.reshape(-1)[0])
        return spec_loop.map_states(lambda x: x[None], state)
    return one


def _rounds_chunk(round_fn, states: spec_loop.SpecState, eos_id, max_new_tokens,
                  n_rounds: int, mesh=None, weights=()):
    """``n_rounds`` rounds of ``round_fn(state, eos, caps)`` queued back to
    back with no host read; returns (states, cumulative counters
    ``[n_rounds, B]``).  Inside ``round_graph.replaying(graph)`` the rounds
    replay a captured round where ``graph`` engages (CUDA tensors, no
    ``mesh``), its first chunk eager; ``weights`` are the trees the round
    reads besides the state."""
    if states.done.shape[0] == 1:
        round_fn = _unit(round_fn)
    graph = round_graph.current()
    if graph is not None and graph.engages(states, mesh):
        if graph.warm:
            return graph.rounds(round_fn, states, eos_id, max_new_tokens, n_rounds, weights)
        graph.warm = True
    device = states.done.device
    eos = torch.as_tensor(eos_id, dtype=torch.int32, device=device)
    caps = torch.as_tensor(max_new_tokens, dtype=torch.int32, device=device)
    counts = []
    for _ in range(n_rounds):
        with profiling.span("engine.round"):
            states = round_fn(states, eos, caps)
        counts.append(states.new_token)
    return states, torch.stack(counts)


def batched_decode_rounds_chunk(
    tparams, dparams, tcfg: LlamaConfig, dcfg: DraftConfig, spec: SpecConfig,
    sampling: spec_loop.SamplingParams,
    states: spec_loop.SpecState,
    eos_id,
    max_new_tokens,  # scalar, or [B] per-request caps
    n_rounds: int = 8,
    mesh=None,
):
    """``n_rounds`` batched rounds queued back to back with no host read;
    returns (states, cumulative counters ``[n_rounds, B]``).  The caches are
    written in place; ``states`` must not be used again except through what
    this returns."""
    def one(state, eos, caps):
        return spec_loop.decode_round(tparams, dparams, tcfg, dcfg, spec, sampling, state,
                                      eos, caps, mesh)
    return _rounds_chunk(one, states, eos_id, max_new_tokens, n_rounds, mesh,
                         (tparams, dparams))


def batched_medusa_rounds_chunk(
    tparams, mparams, tcfg: LlamaConfig, spec: SpecConfig,
    sampling: spec_loop.SamplingParams,
    states: spec_loop.SpecState,
    eos_id,
    max_new_tokens,
    n_rounds: int = 8,
    mesh=None,
):
    """``batched_decode_rounds_chunk`` for Medusa rounds
    (``loop.medusa_decode_round``)."""
    def one(state, eos, caps):
        return spec_loop.medusa_decode_round(tparams, mparams, tcfg, spec, sampling, state,
                                             eos, caps, mesh)
    return _rounds_chunk(one, states, eos_id, max_new_tokens, n_rounds, mesh,
                         (tparams, mparams))


def apply_count_diffs(counts_np, prev, accepts, slot_keys) -> None:
    """Recover per-round acceptance lengths from cumulative device counters.

    counts_np: [n_rounds, B] cumulative new_token per round; prev: mutable
    per-slot int array; accepts: mapping key -> list; slot_keys: (slot, key)
    pairs to track.  A round whose counter didn't move was latched (done)."""
    for r in range(counts_np.shape[0]):
        for slot, key in slot_keys:
            c = int(counts_np[r, slot])
            if c != int(prev[slot]):
                accepts[key].append(c - int(prev[slot]) - 1)
                prev[slot] = c


def pick_chunk_rounds(max_chunk: int, prev, rounds_in, caps, live) -> int:
    """Chunk-size ladder: the largest of {1, 2, 4, max_chunk} not expected to
    overshoot any live slot's remaining budget, so early finishers stop
    paying dead full-cost verify rounds to a distant chunk boundary.
    Per-slot rounds-to-finish = remaining / tokens-per-round (floored at 1:
    every live round commits at least the bonus token, so the estimate never
    exceeds the cap-driven truth)."""
    ladder = sorted({v for v in (1, 2, 4) if v < max_chunk} | {max_chunk})
    horizon = max_chunk
    for j in range(len(prev)):
        if not live[j]:
            continue
        tpr = max(1.0, int(prev[j]) / max(1, int(rounds_in[j])))
        rem = max(1, int(caps[j]) - int(prev[j]))
        horizon = min(horizon, int(np.ceil(rem / tpr)))
    best = ladder[0]
    for v in ladder:
        if v <= max(1, horizon):
            best = v
    return best


def drain_batch(
    tparams, dparams, tcfg, dcfg, spec, sampling, states,
    budget: int, eos_id: int, chunk_rounds: int = 8,
    mparams: Optional[dict] = None,
    mesh=None,
):
    """Run batched rounds (Medusa rounds with ``mparams``) until every
    request is done or the budget is hit, each dispatch sized from the chunk
    ladder, with one host read per chunk.  Returns (states, per-request
    acceptance-length lists, rounds dispatched)."""
    b = int(states.done.shape[0])
    prev = np.zeros(b, np.int64)
    rounds_in = np.zeros(b, np.int64)
    live = np.ones(b, bool)
    caps = np.full(b, budget, np.int64)
    accepts: List[List[int]] = [[] for _ in range(b)]
    slot_keys = [(j, j) for j in range(b)]
    rounds = 0
    graph = round_graph.RoundGraph()
    while rounds < budget:
        ch = pick_chunk_rounds(chunk_rounds, prev, rounds_in, caps, live)
        with round_graph.replaying(graph):
            if mparams is not None:
                states, counts = batched_medusa_rounds_chunk(
                    tparams, mparams, tcfg, spec, sampling, states, eos_id, budget,
                    n_rounds=ch, mesh=mesh)
            else:
                states, counts = batched_decode_rounds_chunk(
                    tparams, dparams, tcfg, dcfg, spec, sampling, states, eos_id, budget,
                    n_rounds=ch, mesh=mesh)
        vals = np.asarray(_Readback(torch.cat(
            [counts.reshape(-1), states.done.to(torch.int32)])).values())
        apply_count_diffs(vals[:ch * b].reshape(ch, b), prev, accepts, slot_keys)
        rounds += ch
        rounds_in += ch
        done = vals[ch * b:].astype(bool)
        live = ~done
        if done.all():
            break
    return states, accepts, rounds


def finished_outputs(states: spec_loop.SpecState, eos_id: int) -> List[np.ndarray]:
    """Each slot's generated ids, cut after its first EOS (one host read)."""
    out_lens = states.out_len.cpu().numpy()
    outputs = states.output.cpu().numpy().astype(np.int64)
    outs = []
    for b in range(outputs.shape[0]):
        toks = outputs[b, :int(out_lens[b])]
        epos = np.nonzero(toks == eos_id)[0]
        outs.append(toks[: epos[0] + 1] if epos.size else toks)
    return outs


def generate_batch(
    tparams, dparams, tcfg: LlamaConfig, dcfg: DraftConfig, spec: SpecConfig,
    prompts: Sequence[Sequence[int]],
    max_new_tokens: int = 128,
    max_len: int = 1024,
    eos_id: int = 2,
    temperature: float = 0.0,
    top_p: float = 0.0,
    top_k: int = 0,
    dtype=torch.bfloat16,
    seed: int = 0,
    chunk_rounds: int = 8,
    cache_pool: Optional[List] = None,
    quantize_kv: bool = False,
    device="cuda",
    mesh=None,  # parallel.mesh.Mesh when the parameters are one rank's shards
) -> List[np.ndarray]:
    """Decode a batch of text prompts to completion; returns generated ids per
    request (request i sampled from the key of ``seed + i`` at T > 0)."""
    sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k))
    slack = max(spec.total_tokens, spec.depth * spec.top_k + spec.depth + 2) + 10
    max_out = output_rows(spec, max_new_tokens)
    requests = prepare_requests(dcfg, prompts, max_len, slack,
                                text_prompt(tparams, device, mesh), device)
    longest = max(len(p) for p in prompts)
    budget = min(max_new_tokens, max_len - longest - slack)
    if budget <= 0:
        raise ValueError(f"no generation headroom: max_len={max_len}, longest "
                         f"prompt {longest}, slack {slack}")
    with torch.no_grad():
        states = batched_prefill(tparams, dparams, tcfg, dcfg, spec, sampling, requests,
                                 max_len, max_out, dtype, seed, cache_pool=cache_pool,
                                 quantize_kv=quantize_kv, device=device, mesh=mesh)
        states, _, _ = drain_batch(tparams, dparams, tcfg, dcfg, spec, sampling, states,
                                   budget, eos_id, chunk_rounds, mesh=mesh)
    return finished_outputs(states, eos_id)
