"""User-facing speculative-decoding model, text path: ``SpecModel`` with
``specgenerate`` (greedy ViSpec decoding) and ``ar_generate`` (the
autoregressive baseline it must equal token for token).

The host loop keeps the JAX version's shape: rounds are queued in chunks,
each round latches ``done`` on the device, and the host reads the per-round
counters one chunk behind through a pinned copy, so the decode loop never
waits on the device once per round.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..ops import kv_cache as kv
from ..ops.quant import quantize_draft_params, quantize_target_params
from . import loop as spec_loop


def _bucket(n: int, step: int = 128) -> int:
    return max(step, ((n + step - 1) // step) * step)


@dataclass
class GenerationResult:
    sequences: np.ndarray  # [total_len] prompt + generated
    new_tokens: int
    rounds: int  # live rounds (spec) or generated tokens (AR)
    acceptance_lengths: List[int]
    decode_time: float
    # rounds (spec) or steps (AR) run on the device, including the latched
    # ones queued past the end; what the kernel launch count follows
    dispatched: int = 0


class _Readback:
    """A copy of a small device tensor started now and read later, without
    waiting for the device work queued after it."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cuda":
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = x, None

    def values(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


class SpecModel:
    """Target + draft pair with a preallocated KV runtime (text path)."""

    def __init__(
        self,
        tcfg: LlamaConfig,
        dcfg: DraftConfig,
        spec: SpecConfig,
        tparams: dict,
        dparams: dict,
        max_len: int = 2048,
        dtype=torch.bfloat16,
        eos_token_id: int = 2,
        device="cuda",
        quantize_draft=False,  # False | True/"int8" | "int4" | "int4_head" | "mixed" | "auto"
        quantize_kv: bool = False,  # int8 target KV cache with per-row scales
    ):
        if max_len % 128 != 0:
            raise ValueError(
                f"max_len must be a multiple of 128 (prompt buckets assume it); "
                f"got {max_len}")
        self.quantize_draft = False
        self.quantize_target = False  # set by quantize_target_inplace
        self.quantize_kv = bool(quantize_kv)
        self.tcfg, self.dcfg, self.spec = tcfg, dcfg, spec
        self.tparams, self.dparams = tparams, dparams
        if quantize_draft:
            self.quantize_draft_inplace(
                "int8" if quantize_draft is True else quantize_draft)
        else:
            self._derive_fuse_mats()
        self.max_len = max_len
        self.dtype = dtype
        self.eos_token_id = eos_token_id
        self.device = torch.device(device)
        self.chunk_rounds = 8  # device-side rounds per host read
        # the caches are allocated at first use: at 7B/2048 the target cache
        # alone is 1 GB in bf16
        self._target_cache: Optional[kv.KVCache] = None
        self._draft_cache: Optional[kv.KVCache] = None

    @property
    def target_cache(self) -> kv.KVCache:
        if self._target_cache is None:
            self._target_cache = kv.init_cache(
                self.tcfg.num_hidden_layers, self.tcfg.num_key_value_heads,
                self.max_len, self.tcfg.head_dim, self.dtype, self.device,
                quantized=self.quantize_kv)
        return self._target_cache

    @target_cache.setter
    def target_cache(self, cache) -> None:
        self._target_cache = cache

    @property
    def draft_cache(self) -> kv.KVCache:
        if self._draft_cache is None:
            self._draft_cache = kv.init_cache(
                self.dcfg.num_hidden_layers, self.dcfg.num_key_value_heads,
                self.max_len, self.dcfg.head_dim, self.dtype, self.device)
        return self._draft_cache

    @draft_cache.setter
    def draft_cache(self, cache) -> None:
        self._draft_cache = cache

    def _derive_fuse_mats(self) -> None:
        """Precompute the request-independent decode fuse matrices into
        dparams (draft.fuse_weight_mats)."""
        w_e, w_h = draft_mod.fuse_weight_mats(self.dparams, self.dcfg)
        self.dparams = dict(self.dparams)
        self.dparams["fuse_we"], self.dparams["fuse_wh"] = w_e, w_h

    def quantize_draft_inplace(self, mode: str = "int8") -> None:
        """Switch the draft to weight-only quantization
        (``ops.quant.quantize_draft_params``): ``int8``, ``int4`` (the int4
        kernel at decode shapes), ``int4_head``, ``mixed`` or ``auto``.
        Verification is untouched, so greedy output still equals the
        target's own; only the proposals (tau) can change.  A draft
        quantized after the target ranks with the target's int8 head."""
        base = {k: v for k, v in self.dparams.items()
                if k not in ("fuse_we", "fuse_wh")}
        self.dparams = quantize_draft_params(base, self.tparams["lm_head"], mode=mode)
        self.quantize_draft = mode
        self._derive_fuse_mats()

    def quantize_target_inplace(self, mode: str = "int8") -> None:
        """Weight-only int8 target quantization
        (``ops.quant.quantize_target_params``), replacing the entries of the
        caller's parameter dicts so each bf16 matrix can be freed.  Outputs
        change (the verifier itself is quantized), but speculative output
        still equals autoregressive output on the same weights."""
        quantize_target_params(self.tparams, mode=mode, inplace=True)
        self.quantize_target = mode

    def _cache_slack(self) -> int:
        """Rows of headroom beyond prompt + generated tokens: the verify tree
        block (target) and the draft's beam scratch plus the padded
        accepted-append block."""
        draft_scratch = self.spec.depth * self.spec.top_k + self.spec.depth + 2
        return max(self.spec.total_tokens, draft_scratch) + 10

    def _padded_embeds(self, input_ids: np.ndarray, pad_len: int) -> torch.Tensor:
        ids = torch.as_tensor(input_ids, dtype=torch.int64, device=self.device)
        embeds = llama.embed(self.tparams, ids)
        pad = embeds.new_zeros((pad_len - embeds.shape[0], embeds.shape[1]))
        return torch.cat([embeds, pad], dim=0)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def specgenerate(
        self,
        input_ids: Sequence[int],
        temperature: float = 0.0,
        top_p: float = 0.0,
        top_k: int = 0,
        max_new_tokens: int = 512,
    ) -> GenerationResult:
        """Greedy speculative decoding of a text prompt."""
        input_ids = np.asarray(input_ids, np.int64)
        l = int(input_ids.shape[0])
        if l == 0:
            raise ValueError("input_ids must be non-empty")
        pad_len = _bucket(l)
        if pad_len > self.max_len or l + self._cache_slack() > self.max_len:
            raise ValueError(
                f"prompt length {l} (bucketed {pad_len}) too long for "
                f"max_len={self.max_len} (need {self._cache_slack()} rows of "
                f"tree/scratch headroom)")
        sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k))
        max_out = min(self.max_len, max_new_tokens + 2 * (self.spec.depth + 2))

        embeds = self._padded_embeds(input_ids, pad_len)
        plan, max_span = draft_mod.make_prefill_plan(
            None, l, self.dcfg.num_q, pad_len, max_images=4,
            max_span=_bucket(1, 64), device=self.device)
        max_span = _bucket(max_span, 64)
        state = spec_loop.spec_prefill(
            self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, plan,
            sampling, embeds, kv.reset(self.target_cache),
            kv.reset(self.draft_cache), max_out, max_span)

        # cap rounds so the cache cannot overflow
        budget = min(max_new_tokens, self.max_len - l - self._cache_slack())
        t0 = time.perf_counter()
        accept_lengths: List[int] = []
        rounds = 0
        eos = torch.tensor(self.eos_token_id, dtype=torch.int32, device=self.device)
        cap = torch.tensor(budget, dtype=torch.int32, device=self.device)

        # Queue a chunk of rounds, start the copy of their counters, and read
        # the PREVIOUS chunk's counters while this one runs.  Chunks shrink as
        # the tokens-per-round estimate says generation is about to finish: a
        # latched round still runs a full verify.  Each live round commits at
        # least one token, so budget + 1 rounds bound the whole loop.
        prev = 0
        pending: Optional[_Readback] = None
        stop = False
        dispatched = 0

        def process(vals) -> bool:
            nonlocal prev, rounds
            for c in vals:
                if c == prev:  # latched round => generation done
                    return True
                accept_lengths.append(c - prev - 1)
                prev = c
                rounds += 1
            return False

        while not stop:
            remaining = budget - prev
            if remaining <= 0 and pending is None:
                break
            in_flight = dispatched - rounds
            toks_per_round = (prev / rounds) if rounds else 1.0
            est = -(-max(remaining, 0) // max(int(toks_per_round), 1))
            n = min(self.chunk_rounds, est + 1 - in_flight, budget + 1 - dispatched)
            if n <= 0:
                if pending is None:
                    break
                stop = process(pending.values())
                pending = None
                continue
            counters = []
            for _ in range(n):
                state = spec_loop.decode_round(
                    self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec,
                    sampling, state, eos, cap)
                counters.append(state.new_token)
            dispatched += n
            batch = _Readback(torch.stack(counters))
            if pending is not None:
                stop = process(pending.values())
            pending = batch
        if pending is not None and not stop:
            process(pending.values())
        out_len = int(state.out_len)
        decode_time = time.perf_counter() - t0

        out = state.output[:out_len].cpu().numpy().astype(np.int64)
        # keep tokens up to and including the first EOS
        eos_pos = np.nonzero(out == self.eos_token_id)[0]
        if eos_pos.size:
            out = out[: eos_pos[0] + 1]
        self.target_cache = kv.reset(state.target_cache)
        self.draft_cache = kv.reset(state.draft_cache)
        return GenerationResult(
            sequences=np.concatenate([input_ids, out]),
            new_tokens=int(out.shape[0]),
            rounds=rounds,
            acceptance_lengths=accept_lengths,
            decode_time=decode_time,
            dispatched=dispatched,
        )

    # ------------------------------------------------------------------
    @torch.no_grad()
    def ar_generate(
        self,
        input_ids: Sequence[int],
        temperature: float = 0.0,
        top_p: float = 0.0,
        top_k: int = 0,
        max_new_tokens: int = 512,
    ) -> GenerationResult:
        """Plain greedy AR baseline over the same runtime."""
        input_ids = np.asarray(input_ids, np.int64)
        l = int(input_ids.shape[0])
        if l == 0:
            raise ValueError("input_ids must be non-empty")
        pad_len = _bucket(l)
        if pad_len > self.max_len or l + 2 > self.max_len:
            raise ValueError(f"prompt length {l} (bucketed {pad_len}) too long for "
                             f"max_len={self.max_len}")
        sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k))
        embeds = self._padded_embeds(input_ids, pad_len)
        tok, cache = spec_loop.ar_prefill(self.tparams, self.tcfg, sampling, embeds,
                                          l, kv.reset(self.target_cache))
        t0 = time.perf_counter()
        out = [int(tok)]
        chunk = self.chunk_rounds
        # headroom for one lookahead chunk of steps past eos/budget
        budget = min(max_new_tokens, self.max_len - l - 2 * chunk - 2)
        if budget <= 0:
            chunk = 1
            budget = min(max_new_tokens, self.max_len - l - 4)
        # queue ``chunk`` steps, start the copy of their tokens, and read the
        # previous chunk while this one runs (each step emits one token)
        pending: Optional[_Readback] = None
        stop = out[-1] == self.eos_token_id
        dispatched = 0

        def process(vals) -> bool:
            for t in vals:
                out.append(t)
                if t == self.eos_token_id or len(out) >= budget:
                    return True
            return False

        while not stop:
            n = min(chunk, (budget - 1) - dispatched)
            if n <= 0:
                if pending is None:
                    break
                stop = process(pending.values())
                pending = None
                continue
            toks = []
            for _ in range(n):
                tok, cache = spec_loop.ar_step(self.tparams, self.tcfg, sampling, tok,
                                               cache)
                toks.append(tok)
            dispatched += n
            batch = _Readback(torch.stack(toks))
            if pending is not None:
                stop = process(pending.values())
            pending = batch
        if pending is not None and not stop:
            process(pending.values())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = out[:max_new_tokens]
        decode_time = time.perf_counter() - t0
        self.target_cache = kv.reset(cache)
        return GenerationResult(
            sequences=np.concatenate([input_ids, np.asarray(out, np.int64)]),
            new_tokens=len(out),
            rounds=len(out),
            acceptance_lengths=[],
            decode_time=decode_time,
            dispatched=dispatched,
        )
