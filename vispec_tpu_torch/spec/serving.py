"""Continuous-batching serving engine: text, LLaVA image or Qwen2.5-VL
image and video prompts, greedy or sampled, over the ViSpec, EAGLE-2 or
Medusa drafter.

``spec/batch.py`` decodes a fixed batch to completion.  This engine keeps a
pool of ``batch_size`` slots decoding indefinitely: when a slot finishes,
its output is harvested and a queued request is admitted into that slot
between chunks; the other slots' trees and caches are untouched, because
admission writes the new request's state into the slot's rows in place (no
repacking, no pause).  Scheduling is decode-priority (admissions happen
between chunks, one prefill at a time on the same device); a finished
slot's done latch (``spec/loop.latch_done``) keeps it a no-op until
refilled.

The engine is online: ``submit()`` enqueues a request at any time,
``step()`` runs one decode chunk (one host read) and returns the request ids
that finished, ``results[rid]`` holds outputs; ``run_all`` submits
everything and steps until dry.

An image request (a dict with ``pixel_values`` / ``image_size``, or on a
Qwen2.5-VL model ``pixel_values_videos`` / ``second_per_grid_ts``, as
``specgenerate`` takes them) is planned at the engine's fixed span buckets,
``max_images`` and ``max_span``; a longer image span fails that request
with a ValueError (recorded in ``errors``).  A Qwen2.5-VL request's slot
carries its M-RoPE ``rope_delta``.  Vision requests never take the
prefix-snapshot path.

Sampling: the engine's ``temperature`` / ``top_p`` / ``top_k`` apply to
every slot, and admission n draws from the key of ``seed + n``.  With
``per_request_sampling`` each request may carry its own ``temperature``,
``top_p``, ``repetition_penalty`` and ``top_k`` (the engine's values are
the defaults, and its ``top_k`` bounds the per-request k): one batched
round mixes greedy and sampled slots.  A Medusa model's admissions run
``medusa_prefill`` with a tiny dummy draft cache; Medusa refuses a prefix
cache and a repetition penalty, with the JAX package's messages.

A sharded model (``SpecModel.shard_over``, ``from_pretrained(mesh=)``)
serves as one process per rank: every rank builds the engine over its
shards and submits the same requests in the same order, and then every
rank admits, decodes and finishes alike (SPMD).  Its slot caches hold the
rank's heads (and layers under pp); the prefills and the rounds take the
model's mesh.  Every decision the engine or a round makes from the device
reads values that all ranks hold equal: the logits are gathered over tp
before any top-k, acceptance or draw, and the host reads the same
counters, lengths and outputs on every rank.  A request that only some
ranks submit would leave the others waiting in a collective.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import draft as draft_mod
from ..ops import kv_cache as kv
from ..ops import rng
from ..ops.sampling import seen_mask
from ..parallel import sharding
from . import batch as batch_mod
from . import loop as spec_loop
from .spec_model import _bucket, _Readback, output_rows, padded_text_embeds

def admit(states: spec_loop.SpecState, state1: spec_loop.SpecState, slot: int) -> None:
    """Write a freshly prefilled single-request state into slot ``slot`` in
    place.  The prefill's caches hold only the pad-bucket rows; they land in
    the slot's first rows, and rows past them keep the previous request's
    KV, masked (columns past ``length``) until decode appends overwrite
    them."""

    def put(big, small):
        big[slot][tuple(slice(0, n) for n in small.shape)].copy_(small)
        return big

    spec_loop.map_states(put, states, state1)


class ServingEngine:
    """Fixed-slot continuous batching over a SpecModel.

    >>> eng = ServingEngine(model, batch_size=4)
    >>> outs = eng.run_all(prompts)        # dynamic admission as slots free
    """

    def __init__(
        self,
        model,
        batch_size: int,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_p: float = 0.0,
        top_k: int = 0,
        pad_bucket=None,  # int, or a sequence of bucket sizes: each admission
        # pads to the smallest bucket that fits its prompt
        chunk_rounds: int = 8,
        seed: int = 0,  # admission n draws from the key of seed + n
        max_images: int = 4,  # image-span plan buckets, fixed for the engine
        max_span: int = 64,
        prefix_ids: Optional[Sequence[int]] = None,  # shared TEXT prefix
        suffix_bucket: int = 128,  # pad bucket for prefix-cached suffixes
        per_request_sampling: bool = False,  # per-slot knobs from submit()
    ):
        if model.mparams is not None and prefix_ids is not None:
            raise NotImplementedError(
                "prefix caching needs the draft-side snapshot; medusa has no "
                "draft transformer — construct the engine without prefix_ids")
        self.per_request = bool(per_request_sampling)
        if self.per_request:
            # the constructor's knobs become the defaults of requests that
            # name none; only top_k stays static (the sort's width, and the
            # largest k a request may ask for)
            self.sampling = spec_loop.SamplingParams(0.0, 0.0, int(top_k), 1.0,
                                                     per_request=True)
            self._default_samp = (float(temperature), float(top_p), 1.0, float(top_k))
        else:
            self.sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k))
        self.seed = seed
        self.m = model
        self.b = batch_size
        self.chunk_rounds = chunk_rounds
        # chunk-size ladder: step() picks the largest value expected to end
        # before any slot's completion, so a slot that finishes early stops
        # paying dead full-cost verify rounds to a distant chunk boundary
        self.chunk_ladder = tuple(sorted(
            {v for v in (1, 2, 4) if v < chunk_rounds} | {chunk_rounds}))
        spec = model.spec
        self.slack = model._cache_slack()
        if pad_bucket is None:
            pad_bucket = 128
        self.buckets = tuple(sorted(
            (pad_bucket,) if isinstance(pad_bucket, int) else pad_bucket))
        if not self.buckets or any(b % 128 for b in self.buckets):
            raise ValueError(f"pad buckets must be 128-multiples: {self.buckets}")
        self.pad = self.buckets[-1]  # the largest bucket bounds the headroom
        self.max_images, self.max_span = max_images, max_span
        self.max_new = min(max_new_tokens, model.max_len - self.pad - self.slack)
        if self.max_new <= 0:
            raise ValueError(f"no headroom: max_len={model.max_len}, pad bucket "
                             f"{self.pad}, slack {self.slack}")
        self.max_out = output_rows(spec, self.max_new)
        self._n_prefills = 0

        # Admission prefills run in small caches (pad-bucket rows, not
        # max_len): a prefill writes only the prompt rows and the first
        # tree's beam rows, and admit() copies just those rows into the
        # slot, so an admission never allocates a max_len cache.
        self._t_rows = {b: b for b in self.buckets}
        self._d_rows = {b: _bucket(b + self.slack) for b in self.buckets}

        # optional prefix cache: the shared text prefix is prefilled once;
        # admissions whose ids start with it prefill only their suffix
        self._snap = None
        self._prefix = None
        if prefix_ids is not None:
            self._prefix = np.asarray(prefix_ids, np.int64)
            plen = len(self._prefix)
            ppad = _bucket(plen)
            self.suffix_bucket = suffix_bucket
            if plen < 2 or plen + suffix_bucket + self.slack > model.max_len:
                raise ValueError(
                    f"prefix length {plen} + suffix bucket {suffix_bucket} + "
                    f"slack {self.slack} exceeds max_len={model.max_len}")
            big = self.buckets[-1]
            self._t_rows[big] = max(self._t_rows[big], _bucket(ppad + suffix_bucket))
            self._d_rows[big] = max(self._d_rows[big],
                                    _bucket(ppad + suffix_bucket + self.slack))
            self.max_new = min(self.max_new,
                               model.max_len - plen - suffix_bucket - self.slack)
        # every admission cache lands in slot buffers of exactly max_len rows
        for name, rows in (("target", self._t_rows), ("draft", self._d_rows)):
            worst = max(rows.values())
            if worst > model.max_len:
                raise ValueError(
                    f"{name} admission cache needs {worst} rows > "
                    f"max_len={model.max_len}; use a smaller pad bucket / "
                    f"prefix / suffix_bucket (row needs per bucket: {rows})")
        if self._prefix is not None:
            with torch.no_grad():
                tc, dc = self._fresh_caches(self.buckets[-1])
                pembeds = padded_text_embeds(model.tparams, self._prefix, ppad, model.device,
                                             model.mesh)
                self._snap = spec_loop.make_prefix_snapshot(
                    model.tparams, model.dparams, model.tcfg, model.dcfg, pembeds,
                    torch.tensor(plen, dtype=torch.int32, device=model.device), tc, dc,
                    mesh=model.mesh)

    # ------------------------------------------------------------------
    def _cache_dims(self):
        """((layers, KV heads) of the target cache, KV heads of the draft
        cache) on this rank: the whole model's, or a sharded model's part
        (``sharding.local_cache_dims``)."""
        m = self.m
        target = sharding.local_cache_dims(m.mesh, m.tcfg.num_hidden_layers,
                                           m.tcfg.num_key_value_heads, pp=m._pp)
        return target, sharding.local_cache_dims(m.mesh, 1, m.dcfg.num_key_value_heads)[1]

    def _fresh_caches(self, bucket: int):
        """A new zero cache pair of the bucket's admission rows (a Medusa
        model's draft entry is None)."""
        m = self.m
        (layers, heads), d_heads = self._cache_dims()
        target = kv.init_cache(layers, heads, self._t_rows[bucket], m.tcfg.head_dim,
                               m.dtype, m.device, quantized=m.quantize_kv)
        if m.mparams is not None:
            return target, None
        return target, kv.init_cache(1, d_heads, self._d_rows[bucket], m.dcfg.head_dim,
                                     m.dtype, m.device)

    def _bucket_for(self, length: int) -> int:
        """Smallest admission bucket that fits ``length`` prompt tokens."""
        for b in self.buckets:
            if length < b:
                return b
        raise ValueError(
            f"prompt length {length} >= largest pad bucket {self.buckets[-1]}; "
            f"construct the engine with a larger pad_bucket (or add one to the "
            f"bucket list)")

    def _empty_stacked(self, template: spec_loop.SpecState) -> spec_loop.SpecState:
        """Slot-stacked state with every slot drained.  Non-cache leaves
        replicate the template prefill (overwritten on admission or latched
        by ``done``); the caches are allocated at the model's max_len, but a
        Medusa state's tiny dummy draft cache is stacked as it is."""
        m, b = self.m, self.b
        medusa = m.mparams is not None
        (layers, heads), d_heads = self._cache_dims()
        st = spec_loop.stack_states(
            [template._replace(target_cache=None,
                               draft_cache=template.draft_cache if medusa else None)] * b)
        return st._replace(
            target_cache=kv.init_cache(layers, heads, m.max_len, m.tcfg.head_dim, m.dtype,
                                       m.device, quantized=m.quantize_kv, slots=b),
            draft_cache=st.draft_cache if medusa else kv.init_cache(
                1, d_heads, m.max_len, m.dcfg.head_dim, m.dtype, m.device, slots=b),
            done=torch.ones((b,), dtype=torch.bool, device=m.device))

    def _draws(self, rid, ids):
        """(key, seen, samp) of an admission: the key of ``seed + n`` for
        the n-th prefill (None when greedy), and in the per-request mode the
        request's knobs and its prompt's seen mask (always carried there:
        any slot may be penalized, and a penalty of 1.0 is an identity)."""
        m = self.m
        self._n_prefills += 1
        key = None if self.sampling.greedy else rng.key(self.seed + self._n_prefills,
                                                        m.device)
        if not self.per_request:
            return key, None, None
        samp = torch.tensor(self._req_samp.get(rid, self._default_samp),
                            dtype=torch.float32, device=m.device)
        seen = None if m.mparams is not None else torch.as_tensor(
            seen_mask(m.tcfg.vocab_size, ids), device=m.device)
        return key, seen, samp

    def _prefill_one(self, request, rid=None) -> spec_loop.SpecState:
        """Prefill one request (a token list, or a dict with ``input_ids``
        and optional ``pixel_values`` / ``image_size`` or
        ``pixel_values_videos`` / ``second_per_grid_ts``) into a fresh
        admission cache pair."""
        m = self.m
        req = request if isinstance(request, dict) else {"input_ids": request}
        ids = np.asarray(req["input_ids"], np.int64)
        if ids.ndim != 1 or ids.shape[0] == 0:
            raise ValueError(f"input_ids must be a non-empty 1-D id list, got shape "
                             f"{ids.shape}")
        if (self._snap is not None and req.get("pixel_values") is None
                and req.get("pixel_values_videos") is None):
            plen = len(self._prefix)
            sl = len(ids) - plen
            if 0 < sl < self.suffix_bucket and np.array_equal(ids[:plen], self._prefix):
                # an over-long suffix falls through to the full prefill below
                sembeds = padded_text_embeds(m.tparams, ids[plen:], self.suffix_bucket,
                                             m.device, m.mesh)
                tc, dc = self._fresh_caches(self.buckets[-1])
                key, seen, samp = self._draws(rid, ids)
                return spec_loop.spec_prefill_continue(
                    m.tparams, m.dparams, m.tcfg, m.dcfg, m.spec, self.sampling,
                    self._snap, sembeds,
                    torch.tensor(sl, dtype=torch.int32, device=m.device), tc, dc,
                    self.max_out, key=key, seen=seen, samp=samp, mesh=m.mesh)
        l = len(ids)
        bucket = self._bucket_for(l)
        prompt = m._padded_prompt(ids, bucket, req.get("pixel_values"),
                                  req.get("image_size"), req.get("pixel_values_videos"),
                                  req.get("second_per_grid_ts", 1.0))
        if m.mparams is not None:
            # Medusa: heads on the target hidden; no plan, no draft cache
            tc, _ = self._fresh_caches(bucket)
            key, _, samp = self._draws(rid, ids)
            return spec_loop.medusa_prefill(m.tparams, m.mparams, m.tcfg, m.spec,
                                            self.sampling, prompt.embeds, l, tc,
                                            self.max_out, key=key, samp=samp, mesh=m.mesh)
        plan, ms = draft_mod.make_prefill_plan(
            prompt.shifted, l, m.dcfg.num_q, bucket, max_images=self.max_images,
            max_span=self.max_span, device=m.device)
        if ms > self.max_span:
            raise ValueError(
                f"image span {ms} exceeds engine max_span={self.max_span}; "
                f"construct the engine with a larger bucket")
        tc, dc = self._fresh_caches(bucket)
        key, seen, samp = self._draws(rid, ids)
        return spec_loop.spec_prefill(
            m.tparams, m.dparams, m.tcfg, m.dcfg, m.spec, plan, self.sampling,
            prompt.embeds, tc, dc, self.max_out, self.max_span, key=key, seen=seen,
            samp=samp, rope=prompt.rope, mesh=m.mesh)

    # ------------------------------------------------------------------
    # Online serving API: submit() requests at any time, step() one decode
    # chunk, read completions from .results; run_all() is the batch wrapper.
    # ------------------------------------------------------------------
    def start_session(self) -> None:
        """Reset the live-serving state (called lazily by submit/run_all)."""
        self._queue: deque = deque()  # (rid, request) awaiting a slot
        self._states: Optional[spec_loop.SpecState] = None  # allocated at first admit
        self._active: Dict[int, int] = {}  # slot -> rid
        self.results: Dict[int, np.ndarray] = {}  # rid -> generated ids
        self.acceptance: Dict[int, List[int]] = {}
        self._emitted: Dict[int, int] = {}  # rid -> streamed-token cursor
        self._req_cap: Dict[int, int] = {}  # rid -> per-request token budget
        self._req_samp: Dict[int, tuple] = {}  # rid -> (T, top_p, penalty, top_k)
        self._caps = np.full(self.b, self.max_new, np.int32)  # per-slot caps
        self._canceled: set = set()
        self._cancel_req: List[int] = []  # active cancels, applied by step()
        self.errors: Dict[int, str] = {}  # rid -> admission-failure message
        self._failed_now: List[int] = []  # failed admissions awaiting report
        self._prev = np.zeros(self.b, np.int64)
        self._slot_rounds = np.zeros(self.b, np.int64)  # rounds since admit
        self._next_rid = 0
        self._guard = 0
        self._chunks = 0
        # EWMA of surprise (EOS-before-budget) finishes per chunk: gates the
        # queued-admission chunk cap in _pick_chunk
        self._eos_ewma = 0.0
        # mid-flight admissions serialize their prefill with decode on the
        # one device; "rounds" counts the batched rounds dispatched
        self.stats = {"admissions": 0, "admit_dispatch_s": 0.0, "wall_s": 0.0,
                      "rounds": 0}

    def submit(self, request, max_new_tokens: Optional[int] = None) -> int:
        """Enqueue a request (token list, or dict with ``input_ids`` and
        optional ``pixel_values`` / ``image_size``, or on a Qwen2.5-VL model
        ``pixel_values_videos`` / ``second_per_grid_ts``); returns a request
        id.
        Admission into a decode slot happens inside step().

        ``max_new_tokens`` (kwarg or request-dict key) caps this request's
        generation (clamped to the engine's budget); the cap rides the
        batched round as a per-slot vector, so a short request frees its
        slot as soon as its own budget is hit.

        With ``per_request_sampling``, dict keys ``temperature`` /
        ``top_p`` / ``repetition_penalty`` / ``top_k`` set this request's
        sampling (unset keys take the engine's values); ``top_k`` must not
        exceed the engine's, and 0 disables the warp for this request."""
        if not hasattr(self, "_queue"):
            self.start_session()
        if isinstance(request, dict):
            if (request.get("pixel_values_videos") is not None
                    and self.m.qwen_cfg is None):
                raise ValueError("video requests need a Qwen2.5-VL model "
                                 "(SpecModel with qwen_cfg and vparams)")
            if max_new_tokens is None:
                max_new_tokens = request.get("max_new_tokens")
        cap = self.max_new if max_new_tokens is None else int(max_new_tokens)
        if cap < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {cap}")
        if self.per_request:
            d = request if isinstance(request, dict) else {}
            req_k = int(d.get("top_k", self._default_samp[3]))
            if req_k > self.sampling.top_k:
                raise ValueError(
                    f"request top_k={req_k} exceeds the engine's static "
                    f"top_k bucket {self.sampling.top_k} (the ctor value "
                    f"bounds the per-request k — construct the engine with "
                    f"top_k >= the largest k you will serve)")
            samp = (float(d.get("temperature", self._default_samp[0])),
                    float(d.get("top_p", self._default_samp[1])),
                    float(d.get("repetition_penalty", self._default_samp[2])),
                    float(req_k))
            if samp[2] != 1.0 and self.m.mparams is not None:
                raise ValueError("repetition_penalty is not supported with "
                                 "the medusa drafter")
        elif isinstance(request, dict) and any(
                k in request for k in ("temperature", "top_p", "repetition_penalty",
                                       "top_k")):
            raise ValueError(
                "per-request sampling keys need "
                "ServingEngine(per_request_sampling=True); this engine uses "
                "one static sampling config for all slots")
        rid = self._next_rid
        self._next_rid += 1
        if self.per_request:
            self._req_samp[rid] = samp
        self.acceptance[rid] = []
        self._emitted[rid] = 0
        self._req_cap[rid] = min(cap, self.max_new)
        self._queue.append((rid, request))
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request: a queued one is dropped (empty result); an
        active one has its slot's done latch forced, and the next step()
        harvests what it generated so far.  Returns False if the rid is
        unknown, already finished, or already canceled.  Always deferred to
        step(), which owns the queue and the states."""
        if not hasattr(self, "_queue"):
            return False
        if rid in self._canceled:
            return False
        if rid in self.results or rid not in self._emitted:
            return False
        self._canceled.add(rid)
        self._cancel_req.append(rid)
        return True

    def was_canceled(self, rid: int) -> bool:
        """True if the request was canceled (its result holds whatever was
        generated before the cancel took effect)."""
        return rid in getattr(self, "_canceled", ())

    def pop_result(self, rid: int) -> np.ndarray:
        """Return a finished request's output and release its per-request
        state; an unknown, unfinished or already-popped rid raises
        KeyError."""
        try:
            out = self.results.pop(rid)
        except KeyError:
            raise KeyError(
                f"request {rid}: unknown, unfinished, or already popped "
                "(pop_result must be called exactly once per finished rid)") from None
        for d in (self.acceptance, self._emitted, self._req_cap, self._req_samp,
                  self.errors):
            d.pop(rid, None)
        self._canceled.discard(rid)
        return out

    def pending(self) -> bool:
        """True while any request is queued or decoding."""
        return bool(getattr(self, "_queue", None)) or bool(getattr(self, "_active", None))

    def _admit_from_queue(self) -> None:
        """Fill free slots from the queue, one prefill at a time."""
        free = [s for s in range(self.b) if s not in self._active]
        while self._queue and free:
            rid, request = self._queue.popleft()
            t_adm = time.perf_counter()
            try:
                s1 = self._prefill_one(request, rid)
            except (ValueError, KeyError, TypeError) as e:
                # a malformed request fails that request, not the engine
                self.results[rid] = np.zeros(0, np.int64)
                self.errors[rid] = f"{type(e).__name__}: {e}"
                self._failed_now.append(rid)
                continue
            if self._states is None:
                self._states = self._empty_stacked(s1)
            slot = free.pop(0)
            admit(self._states, s1, slot)
            if self._chunks:
                # only mid-flight admissions stall other slots' decode
                self.stats["admissions"] += 1
                self.stats["admit_dispatch_s"] += time.perf_counter() - t_adm
            self._active[slot] = rid
            self._prev[slot] = 0
            self._slot_rounds[slot] = 0
            self._caps[slot] = self._req_cap[rid]

    def _pick_chunk(self) -> int:
        """This step's chunk size from the ladder: the largest value not
        expected to overshoot any active slot's completion (rounds-to-finish
        from its tokens per round, floored at 1).  While requests wait behind
        full slots and EOS finishes are actually happening (``_eos_ewma``),
        the chunk is capped at 2 so such a finish frees its slot quickly."""
        full = self.chunk_ladder[-1]
        horizon = full
        for slot, rid in self._active.items():
            committed = int(self._prev[slot])
            tpr = max(1.0, committed / max(1, int(self._slot_rounds[slot])))
            rem = max(1, self._req_cap[rid] - committed)
            horizon = min(horizon, int(np.ceil(rem / tpr)))
        if self._queue and self._eos_ewma > 0.02:
            horizon = min(horizon, 2)
        best = self.chunk_ladder[0]
        for v in self.chunk_ladder:
            if v <= max(1, horizon):
                best = v
        return best

    @torch.no_grad()
    def step(self, on_tokens=None) -> List[int]:
        """Admit queued requests into free slots, run one decode chunk
        (ladder-selected rounds, one host read), harvest finished slots into
        ``self.results``; returns the rids completed this step.

        ``on_tokens(rid, token_ids)`` streams each request's newly generated
        tokens once per chunk."""
        m = self.m
        while self._cancel_req:  # deferred cancels: no chunk is in flight here
            rid = self._cancel_req.pop()
            entry = next((e for e in list(self._queue) if e[0] == rid), None)
            if entry is not None:
                self._queue.remove(entry)
                self.results[rid] = np.zeros(0, np.int64)
                self._failed_now.append(rid)  # reported through step()'s return
                continue
            slot = next((s for s, a in self._active.items() if a == rid), None)
            if slot is None:
                # finished before the cancel could take effect: the full
                # result stands, so the request was not canceled after all
                self._canceled.discard(rid)
            else:
                self._states.done[slot] = True
        self._admit_from_queue()
        failed = self._failed_now
        self._failed_now = []
        if not self._active:
            return failed
        chunk = self._pick_chunk()
        if m.mparams is not None:
            states, counts = batch_mod.batched_medusa_rounds_chunk(
                m.tparams, m.mparams, m.tcfg, m.spec, self.sampling, self._states,
                m.eos_token_id, self._caps, n_rounds=chunk, mesh=m.mesh)
        else:
            states, counts = batch_mod.batched_decode_rounds_chunk(
                m.tparams, m.dparams, m.tcfg, m.dcfg, m.spec, self.sampling,
                self._states, m.eos_token_id, self._caps, n_rounds=chunk, mesh=m.mesh)
        self._states = states
        for slot in self._active:
            self._slot_rounds[slot] += chunk
        # one host read per chunk: counters, done flags, lengths and outputs
        b = self.b
        vals = np.asarray(_Readback(torch.cat([
            counts.reshape(-1), states.done.to(torch.int32), states.out_len,
            states.output.reshape(-1)])).values(), np.int64)
        counts_np = vals[:chunk * b].reshape(chunk, b)
        done = vals[chunk * b:(chunk + 1) * b].astype(bool)
        out_lens = vals[(chunk + 1) * b:(chunk + 2) * b]
        outputs = vals[(chunk + 2) * b:].reshape(b, -1)
        batch_mod.apply_count_diffs(counts_np, self._prev, self.acceptance,
                                    list(self._active.items()))
        if on_tokens is not None:
            for slot, rid in self._active.items():
                n = min(int(out_lens[slot]), self._req_cap[rid])
                if n > self._emitted[rid]:
                    on_tokens(rid, outputs[slot][self._emitted[rid]:n])
                    self._emitted[rid] = n
        completed = []
        surprise = False  # any EOS-before-budget finish this chunk
        for slot in [s for s in range(b) if done[s] and s in self._active]:
            toks = outputs[slot][: int(out_lens[slot])]
            epos = np.nonzero(toks == m.eos_token_id)[0]
            if epos.size:
                toks = toks[: epos[0] + 1]
            rid = self._active.pop(slot)  # the slot stays latched until refilled
            if epos.size and int(epos[0]) + 1 < self._req_cap[rid]:
                surprise = True
            self.results[rid] = toks[: self._req_cap[rid]]
            completed.append(rid)
        self._eos_ewma = 0.9 * self._eos_ewma + (0.1 if surprise else 0.0)
        completed.extend(failed)
        self._guard += chunk
        self._chunks += 1
        self.stats["rounds"] += chunk
        if self._guard > (self._next_rid + self.b) * (self.max_new + 8):
            raise RuntimeError("serving engine failed to converge")
        return completed

    # ------------------------------------------------------------------
    def run_all(self, prompts: Sequence, on_tokens=None) -> List[np.ndarray]:
        """Serve every request with dynamic slot admission; returns generated
        token ids per request (submission order).  Greedy outputs match
        single-request ``specgenerate`` exactly.  ``on_tokens(request_idx,
        token_ids)`` streams each request's newly generated tokens once per
        chunk."""
        if not prompts:
            return []
        self.start_session()
        t_run0 = time.perf_counter()
        rids = [self.submit(p) for p in prompts]
        while self.pending():
            self.step(on_tokens=on_tokens)
        self.stats["wall_s"] = time.perf_counter() - t_run0
        return [self.results[r] for r in rids]
