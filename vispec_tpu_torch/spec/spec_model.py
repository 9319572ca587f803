"""User-facing speculative-decoding model: ``SpecModel`` with
``specgenerate`` (speculative decoding, greedy or sampled), ``ar_generate``
(the autoregressive baseline it must equal token for token when greedy, and
in distribution when sampled), and the serving half: ``specgenerate_batch`` (a fixed batch decoded together,
``spec/batch.py``) and ``serving_engine`` (continuous batching,
``spec/serving.py``).  Prompts are text, LLaVA-1.5/1.6 image prompts or
Qwen2.5-VL image and video prompts: a model built with ``llava_cfg`` (or
``qwen_cfg``) and ``vparams`` encodes each image (``models/llava.py``,
``models/qwen2_5_vl.py``) and writes its features over the prompt's
``image_token_index`` rows (a video's over its ``video_token_index``
rows); the draft compresses each image or video span.  A Qwen2.5-VL
vision prompt also carries its 3-row M-RoPE position ids and the offset
``rope_delta`` that every later position takes (except under Medusa,
whose prefill gives every prompt plain positions, as the JAX package's
does).

Three drafters: ViSpec's draft (a ``DraftConfig`` with ``vision=True``),
EAGLE-2's (the same draft without the image adaptor, ``vision=False``),
and Medusa's heads on the target (``mparams``; ``models/medusa.py``).
Sampling takes ``temperature`` / ``top_p`` / ``top_k``, a ``seed`` for the
request's random key and a ``repetition_penalty`` (active at T > 0).

The host loop keeps the JAX version's shape: rounds are queued in chunks,
each round latches ``done`` on the device, and the host reads the per-round
counters one chunk behind through a pinned copy, so the decode loop never
waits on the device once per round.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama, llava
from ..models import medusa
from ..models import qwen2_5_vl as qwen_vl
from ..ops import kv_cache as kv
from ..ops import rng
from ..ops.quant import quantize_draft_params, quantize_target_params
from ..ops.sampling import seen_mask
from . import loop as spec_loop


def _bucket(n: int, step: int = 128) -> int:
    return max(step, ((n + step - 1) // step) * step)


def padded_text_embeds(tparams: dict, input_ids, pad_len: int, device) -> torch.Tensor:
    """Token embeddings of a text prompt, zero rows to ``pad_len``."""
    x = llama.embed(tparams, torch.as_tensor(np.asarray(input_ids, np.int64), device=device))
    return torch.cat([x, x.new_zeros((pad_len - x.shape[0], x.shape[1]))])


class PaddedPrompt(NamedTuple):
    """A prompt ready for prefill (``SpecModel._padded_prompt``)."""

    embeds: torch.Tensor  # [pad_len, hidden] token embeds, vision rows merged
    image_mask: Optional[np.ndarray]  # [L] the vision-token rows; None for text
    shifted: Optional[np.ndarray]  # image_mask[1:]: what the draft's plan takes
    n_spans: int  # runs of True in ``shifted``
    rope: Optional[spec_loop.PromptRope]  # a Qwen2.5-VL vision prompt's M-RoPE


def plan_prompt(dcfg: DraftConfig, shifted, n_spans: int, real_len: int, pad_len: int,
                device):
    """The draft's prefill plan at ``specgenerate``'s buckets: the image-span
    count in steps of four (at least four), the longest span rounded up to
    64 rows.  Returns (plan, max_span)."""
    max_images = max(4, -(-n_spans // 4) * 4)
    plan, max_span = draft_mod.make_prefill_plan(
        shifted, real_len, dcfg.num_q, pad_len, max_images=max_images,
        max_span=_bucket(1, 64), device=device)
    return plan, _bucket(max_span, 64)


def _stub_draft_config(tcfg: LlamaConfig, num_q: int = 2) -> DraftConfig:
    """Placeholder draft config of a model without a draft transformer (a
    target-only model, or Medusa): sized so an unused draft cache stays
    small."""
    return DraftConfig(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
        intermediate_size=128, num_attention_heads=tcfg.num_attention_heads,
        num_key_value_heads=1, num_q=num_q)


def _stub_draft_params(tparams: dict, dtype) -> dict:
    """Draft parameters without a layer: the target's embedding only."""
    return {"embed": tparams["embed"], "layer": {},
            "fc_w": torch.zeros((1,), dtype=dtype, device=tparams["embed"].device)}


def output_rows(spec: SpecConfig, max_new_tokens: int) -> int:
    """Rows of a request's output buffer: the budget plus two rounds'
    commits of the drafter that commits more per round (the JAX package's
    ``max_new_tokens + 2 * max(depth + 2, NUM_HEADS + 1)``)."""
    return max_new_tokens + 2 * max(spec.depth + 2, medusa.NUM_HEADS + 1)


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
    """Target + draft pair with a preallocated KV runtime; with ``llava_cfg``
    and ``vparams`` (``{"vision": clip_vit params, **projector params}``) it
    takes LLaVA image prompts, with ``qwen_cfg`` and ``vparams`` (the
    Qwen2.5-VL tower's tree) Qwen2.5-VL image and video prompts over a
    target whose config has ``mrope_section``."""

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
        llava_cfg: Optional[llava.LlavaConfig] = None,
        vparams: Optional[dict] = None,
        image_token_index: Optional[int] = None,
        mparams: Optional[dict] = None,  # Medusa heads => the Medusa decode path
        qwen_cfg: Optional[qwen_vl.QwenVisionConfig] = None,
        vision_start_token_id: int = 151652,
        video_token_index: Optional[int] = None,
        min_pixels: int = 256 * 28 * 28,  # the Qwen image budget (HF processor's)
        max_pixels: int = 1280 * 28 * 28,
        video_max_pixels: int = 768 * 28 * 28,  # per-frame budget of a video
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
        self.mparams = mparams
        self.llava_cfg, self.vparams = llava_cfg, vparams
        self.image_token_index = image_token_index
        if qwen_cfg is not None and tcfg.mrope_section is None:
            raise ValueError("a Qwen2.5-VL tower needs a target config with mrope_section")
        self.qwen_cfg = qwen_cfg
        self.vision_start_token_id = vision_start_token_id
        self.video_token_index = video_token_index
        self.min_pixels, self.max_pixels = min_pixels, max_pixels
        self.video_max_pixels = video_max_pixels
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
        # slot-stacked caches of specgenerate_batch, kept across calls
        self._batch_pool: List = []

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
        dparams (draft.fuse_weight_mats); a draft without a layer (the stub
        of a target-only or Medusa model) has no fuse path."""
        d = self.dparams
        if not d.get("layer") or getattr(d.get("fc_w"), "ndim", 0) != 2:
            return
        w_e, w_h = draft_mod.fuse_weight_mats(self.dparams, self.dcfg)
        self.dparams = dict(self.dparams)
        self.dparams["fuse_we"], self.dparams["fuse_wh"] = w_e, w_h

    def quantize_draft_inplace(self, mode: str = "int8") -> None:
        """Switch the draft to weight-only quantization
        (``ops.quant.quantize_draft_params``): ``int8``, ``int4`` (the int4
        kernel at decode shapes), ``int4_head``, ``mixed`` or ``auto``.
        Verification is untouched, so greedy output still equals the
        target's own; only the proposals (tau) can change.  A draft
        quantized after the target ranks with the target's int8 head.  A
        draft without a layer (Medusa, target-only) is left as it is."""
        if not self.dparams.get("layer"):
            return
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
        still equals autoregressive output on the same weights.  The vision
        tower and projector (``vparams``) stay as they are."""
        quantize_target_params(self.tparams, mode=mode, inplace=True)
        self.quantize_target = mode

    def _cache_slack(self) -> int:
        """Rows of headroom beyond prompt + generated tokens: the verify tree
        block (target) and the draft's beam scratch plus the padded
        accepted-append block."""
        draft_scratch = self.spec.depth * self.spec.top_k + self.spec.depth + 2
        return max(self.spec.total_tokens, draft_scratch) + 10

    def _seen_mask(self, sampling, input_ids) -> Optional[torch.Tensor]:
        """The ``[vocab+1]`` prompt-token mask when the repetition penalty is
        live (T > 0 and a penalty other than 1.0); None otherwise, so the
        round carries nothing."""
        if sampling.greedy or sampling.repetition_penalty == 1.0:
            return None
        return torch.as_tensor(seen_mask(self.tcfg.vocab_size, input_ids),
                               device=self.device)

    def _key(self, sampling, seed: int) -> Optional[torch.Tensor]:
        """The request's random key, or None when greedy (nothing is drawn)."""
        return None if sampling.greedy else rng.key(seed, self.device)

    # ------------------------------------------------------------------
    def count_image_tokens(self, image_size: Tuple[int, int]) -> int:
        """Number of image-token placeholders one image of this size
        expands to; it must agree with the vision path's feature count."""
        oh, ow = image_size
        if self.llava_cfg is not None:
            if self.llava_cfg.anyres:
                return llava.plan_anyres(oh, ow, self.llava_cfg).n_tokens
            return self.llava_cfg.patches_per_side ** 2
        if self.qwen_cfg is not None:
            rh, rw = qwen_vl.smart_resize(oh, ow, min_pixels=self.min_pixels,
                                          max_pixels=self.max_pixels)
            q = self.qwen_cfg
            return (rh // q.patch_size) * (rw // q.patch_size) // q.merge_unit
        raise ValueError("not a vision model")

    def count_video_tokens(self, num_frames: int, frame_size: Tuple[int, int]) -> int:
        """Number of video-token placeholders a Qwen2.5-VL video of
        ``num_frames`` frames of ``frame_size`` expands to (frames taken in
        pairs, an odd count padded by its last frame)."""
        if self.qwen_cfg is None:
            raise ValueError("not a Qwen2.5-VL model")
        q = self.qwen_cfg
        rh, rw = qwen_vl.smart_resize(*frame_size, max_pixels=int(self.video_max_pixels))
        groups = -(-num_frames // q.temporal_patch_size)
        return groups * (rh // q.patch_size) * (rw // q.patch_size) // q.merge_unit

    def _encode_image(self, image, image_size) -> torch.Tensor:
        """One image [H, W, 3] in [0, 1] -> its packed features [n_tokens,
        hidden]: the anyres tiles (LLaVA-1.6) or one square tile (1.5)."""
        cfg = self.llava_cfg
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        oh, ow = image_size if image_size is not None else img.shape[:2]
        if cfg.anyres:
            plan = llava.plan_anyres(oh, ow, cfg)
            tiles = llava.preprocess_anyres(img, plan, cfg)
        else:
            plan = None
            size = cfg.vision.image_size
            tiles = llava.normalize(llava.resize_image(img, size, size))[None]
        return llava.encode_image(self.vparams, cfg, tiles, plan)

    def _qwen_vision(self, images, sizes, video, second_per_grid_ts: float):
        """A Qwen2.5-VL prompt's vision input: the images (each resized to
        the pixel budget by ``smart_resize``) or the video (frames resized
        alike to the per-frame budget, taken in pairs), patchified, padded
        to a multiple of 64 rows and encoded in one tower call over all
        their grids.  Returns (features [n_merged, hidden], the token id
        they replace, the grids, the seconds per temporal grid step)."""
        q, dev = self.qwen_cfg, self.device
        if video is not None:
            frames = torch.as_tensor(video, dtype=torch.float32, device=dev)
            t, oh, ow = frames.shape[:3]
            rh, rw = qwen_vl.smart_resize(oh, ow, max_pixels=int(self.video_max_pixels))
            patches = qwen_vl.patchify_video(llava.resize_image(frames, rh, rw), q)
            grids = [(-(-t // q.temporal_patch_size), rh // q.patch_size,
                      rw // q.patch_size)]
            token, spgs = self.video_token_index, [second_per_grid_ts]
        else:
            parts, grids = [], []
            for img, isz in zip(images, sizes):
                img = torch.as_tensor(img, dtype=torch.float32, device=dev)
                oh, ow = isz if isz is not None else img.shape[:2]
                rh, rw = qwen_vl.smart_resize(oh, ow, min_pixels=self.min_pixels,
                                              max_pixels=self.max_pixels)
                parts.append(qwen_vl.patchify_image(llava.resize_image(img, rh, rw), q))
                grids.append((1, rh // q.patch_size, rw // q.patch_size))
            patches = torch.cat(parts)
            token, spgs = self.image_token_index, []
        n = patches.shape[0]
        pad = _bucket(n, 64)
        patches = torch.cat([patches, patches.new_zeros((pad - n, patches.shape[1]))])
        plan = qwen_vl.plan_vision(grids, q, pad)
        feats = qwen_vl.forward(self.vparams, q, patches, plan)[:plan.n_merged]
        return feats, token, grids, spgs

    def _padded_prompt(self, input_ids, pad_len: int, pixel_values=None,
                       image_size=None, pixel_values_videos=None,
                       second_per_grid_ts: float = 1.0) -> PaddedPrompt:
        """The prompt's token embeds padded to ``pad_len`` with the vision
        features written over the image-token (or video-token) rows,
        features of several images concatenated in prompt order (the JAX
        package's ``_prompt_embeds`` and ``_padded_prompt``).  A Qwen2.5-VL
        vision prompt also gets its M-RoPE ids, continued over the padding,
        and rope_delta; a text prompt, a LLaVA prompt and a Qwen2.5-VL text
        prompt take plain positions (``rope`` None).  A video takes
        precedence over images given with it, which are not used (as in
        the JAX package)."""
        ids = np.asarray(input_ids, np.int64)
        images, sizes = _as_image_list(pixel_values, image_size)
        video = pixel_values_videos
        if not images and video is None:
            return PaddedPrompt(padded_text_embeds(self.tparams, ids, pad_len, self.device),
                                None, None, 0, None)
        if video is not None and (self.qwen_cfg is None or self.vparams is None):
            raise ValueError("pixel_values_videos given to a model without a Qwen2.5-VL "
                             "vision tower (construct it with qwen_cfg and vparams)")
        if (self.llava_cfg is None and self.qwen_cfg is None) or self.vparams is None:
            raise ValueError("pixel_values given to a model without a vision tower "
                             "(construct it with llava_cfg or qwen_cfg, and vparams)")
        if self.qwen_cfg is not None:
            feats, token, grids, spgs = self._qwen_vision(images, sizes, video,
                                                          second_per_grid_ts)
        else:
            feats = torch.cat([self._encode_image(img, isz)
                               for img, isz in zip(images, sizes)])
            token = self.image_token_index
        image_mask = ids == token
        positions = np.nonzero(image_mask)[0]
        if positions.size != feats.shape[0]:
            kind = "video" if video is not None else "image"
            raise ValueError(f"{kind} token count {positions.size} != "
                             f"{'merged ' if self.qwen_cfg else ''}features {feats.shape[0]}")
        # the vision rows are overwritten: look them up as id 0, so that an
        # image_token_index past the vocab cannot fault (JAX's take fills them)
        embeds = padded_text_embeds(self.tparams, np.where(image_mask, 0, ids), pad_len,
                                    self.device)
        embeds = llava.merge_image_embeds(embeds, feats,
                                          torch.as_tensor(positions, device=self.device))
        shifted = image_mask[1:]
        n_spans = int((shifted & ~np.concatenate([[False], shifted[:-1]])).sum())
        rope = None
        if self.qwen_cfg is not None:
            pos, rope_delta = qwen_vl.get_rope_index_host(
                ids, grids, self.qwen_cfg, self.image_token_index or -1,
                self.video_token_index or -2, self.vision_start_token_id,
                second_per_grid_ts=spgs)
            cont = pos[:, -1:] + 1 + np.arange(pad_len - ids.shape[0])[None, :]
            rope = spec_loop.PromptRope(
                torch.as_tensor(np.concatenate([pos, cont], axis=1), dtype=torch.int32,
                                device=self.device), int(rope_delta))
        return PaddedPrompt(embeds, image_mask, shifted, n_spans, rope)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def specgenerate(
        self,
        input_ids: Sequence[int],
        temperature: float = 0.0,
        top_p: float = 0.0,
        top_k: int = 0,
        max_new_tokens: int = 512,
        pixel_values=None,
        image_size=None,
        pixel_values_videos=None,
        stop_token_id: Optional[int] = None,
        seed: int = 0,
        repetition_penalty: float = 1.0,  # active at T > 0 only
        second_per_grid_ts: float = 1.0,
    ) -> GenerationResult:
        """Speculative decoding of a prompt, greedy at ``temperature`` 0,
        else sampled from the request's key of ``seed``.  ``pixel_values``
        is one image [H, W, 3] in [0, 1] or a list of them, ``image_size``
        its (height, width) or their list; the prompt holds each image's
        ``count_image_tokens`` placeholders.  A Qwen2.5-VL model also takes
        ``pixel_values_videos``, one video [T, H, W, 3] in [0, 1] whose
        ``count_video_tokens`` placeholders the prompt holds, with
        ``second_per_grid_ts`` seconds per pair of frames (its M-RoPE time
        step).  Generation stops at EOS or at
        ``stop_token_id`` (an extra stop id, such as Llama 3's
        ``<|eot_id|>``); the output keeps the tokens up to and including the
        first of either.  A Medusa model (``mparams``) refuses a repetition
        penalty, as the JAX package does."""
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
        sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k),
                                            float(repetition_penalty))
        seen = self._seen_mask(sampling, input_ids)
        if seen is not None and self.mparams is not None:
            raise NotImplementedError(
                "repetition_penalty is not supported with the medusa drafter")
        max_out = min(self.max_len, output_rows(self.spec, max_new_tokens))
        key = self._key(sampling, seed)

        prompt = self._padded_prompt(input_ids, pad_len, pixel_values, image_size,
                                     pixel_values_videos, second_per_grid_ts)
        if self.mparams is not None:
            state = spec_loop.medusa_prefill(
                self.tparams, self.mparams, self.tcfg, self.spec, sampling, prompt.embeds,
                l, kv.reset(self.target_cache), max_out, key=key)
        else:
            plan, max_span = plan_prompt(self.dcfg, prompt.shifted, prompt.n_spans, l,
                                         pad_len, self.device)
            state = spec_loop.spec_prefill(
                self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, plan,
                sampling, prompt.embeds, kv.reset(self.target_cache),
                kv.reset(self.draft_cache), max_out, max_span, key=key, seen=seen,
                rope=prompt.rope)

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
        # least one token, so budget + 1 rounds bound the whole loop.  With a
        # stop id the host reads the output after each chunk (a synced read;
        # chunk_rounds = 1 makes that every round).
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
                state = self._round(sampling, state, eos, cap)
                counters.append(state.new_token)
            dispatched += n
            batch = _Readback(torch.stack(counters))
            if pending is not None:
                stop = process(pending.values())
            pending = batch
            if not stop and stop_token_id is not None:
                out_now = state.output[:int(state.out_len)]
                if bool((out_now == stop_token_id).any()):
                    break
        if pending is not None and not stop:
            process(pending.values())
        out_len = int(state.out_len)
        decode_time = time.perf_counter() - t0

        out = state.output[:out_len].cpu().numpy().astype(np.int64)
        # keep tokens up to and including the first EOS or stop id
        stops = out == self.eos_token_id
        if stop_token_id is not None:
            stops |= out == stop_token_id
        eos_pos = np.nonzero(stops)[0]
        if eos_pos.size:
            out = out[: eos_pos[0] + 1]
        self.target_cache = kv.reset(state.target_cache)
        if self.mparams is None:
            self.draft_cache = kv.reset(state.draft_cache)
        return GenerationResult(
            sequences=np.concatenate([input_ids, out]),
            new_tokens=int(out.shape[0]),
            rounds=rounds,
            acceptance_lengths=accept_lengths,
            decode_time=decode_time,
            dispatched=dispatched,
        )

    def _round(self, sampling, state, eos, cap):
        """One decode round of this model's drafter."""
        if self.mparams is not None:
            return spec_loop.medusa_decode_round(self.tparams, self.mparams, self.tcfg,
                                                 self.spec, sampling, state, eos, cap)
        return spec_loop.decode_round(self.tparams, self.dparams, self.tcfg, self.dcfg,
                                      self.spec, sampling, state, eos, cap)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def ar_generate(
        self,
        input_ids: Sequence[int],
        temperature: float = 0.0,
        top_p: float = 0.0,
        top_k: int = 0,
        max_new_tokens: int = 512,
        pixel_values=None,
        image_size=None,
        pixel_values_videos=None,
        seed: int = 0,
        repetition_penalty: float = 1.0,
        second_per_grid_ts: float = 1.0,
    ) -> GenerationResult:
        """Plain AR baseline over the same runtime (image and video prompts
        and sampling knobs as in ``specgenerate``; the penalty's mask updates
        per token)."""
        input_ids = np.asarray(input_ids, np.int64)
        l = int(input_ids.shape[0])
        if l == 0:
            raise ValueError("input_ids must be non-empty")
        pad_len = _bucket(l)
        if pad_len > self.max_len or l + 2 > self.max_len:
            raise ValueError(f"prompt length {l} (bucketed {pad_len}) too long for "
                             f"max_len={self.max_len}")
        sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k),
                                            float(repetition_penalty))
        seen = self._seen_mask(sampling, input_ids)
        prompt = self._padded_prompt(input_ids, pad_len, pixel_values, image_size,
                                     pixel_values_videos, second_per_grid_ts)
        tok, cache, key, seen, delta = spec_loop.ar_prefill(
            self.tparams, self.tcfg, sampling, prompt.embeds, l,
            kv.reset(self.target_cache), key=self._key(sampling, seed), seen=seen,
            rope=prompt.rope)
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
                tok, cache, key, seen = spec_loop.ar_step(
                    self.tparams, self.tcfg, sampling, tok, cache, key=key, seen=seen,
                    rope_delta=delta)
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

    # ------------------------------------------------------------------
    @torch.no_grad()
    def specgenerate_batch(
        self,
        requests: Sequence[dict],
        temperature: float = 0.0,
        max_new_tokens: int = 256,
        top_p: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
    ) -> List[GenerationResult]:
        """Batched multi-request decoding of request dicts (``input_ids``
        and, for a vision prompt, ``pixel_values`` / ``image_size`` or
        ``pixel_values_videos`` / ``second_per_grid_ts`` as in
        ``specgenerate``): each request is padded to its own 128-row bucket,
        planned at its own span buckets and prefilled on its own into its
        slot of the pooled stacked caches, then all decode together in
        batched rounds; finished requests are frozen in place until the
        batch drains.  Request i samples from the key of ``seed + i``, so
        its output equals ``specgenerate(..., seed=seed + i)``'s, greedy or
        sampled.  As in the JAX package, there is no repetition penalty
        here (the engine's per-request mode has one)."""
        from . import batch as batch_mod

        sampling = spec_loop.SamplingParams(temperature, top_p, int(top_k))
        slack = self._cache_slack()
        prompts = [np.asarray(r["input_ids"], np.int64) for r in requests]
        reqs = batch_mod.prepare_requests(self.dcfg, requests, self.max_len, slack,
                                          self._padded_prompt, self.device)
        max_out = min(self.max_len, output_rows(self.spec, max_new_tokens))
        states = batch_mod.batched_prefill(
            self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, sampling, reqs,
            self.max_len, max_out, self.dtype, cache_pool=self._batch_pool,
            quantize_kv=self.quantize_kv, device=self.device, seed=seed,
            mparams=self.mparams)
        # decode_time excludes prefill, as in specgenerate
        t0 = time.perf_counter()
        budget = min(max_new_tokens, self.max_len - max(len(p) for p in prompts) - slack)
        states, accepts, dispatched = batch_mod.drain_batch(
            self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, sampling, states,
            budget, self.eos_token_id, self.chunk_rounds, mparams=self.mparams)
        outs = batch_mod.finished_outputs(states, self.eos_token_id)
        decode_time = time.perf_counter() - t0
        return [GenerationResult(
            sequences=np.concatenate([ids, toks[:max_new_tokens]]),
            new_tokens=int(toks[:max_new_tokens].shape[0]),
            rounds=len(acc), acceptance_lengths=acc, decode_time=decode_time,
            dispatched=dispatched)
            for ids, toks, acc in zip(prompts, outs, accepts)]

    # ------------------------------------------------------------------
    def serving_engine(self, batch_size: int, **kw):
        """Continuous-batching engine over this model (``spec/serving.py``):
        fixed decode slots, queued requests admitted as slots free up."""
        from .serving import ServingEngine

        return ServingEngine(self, batch_size, **kw)


def _as_image_list(pixel_values, image_size):
    """One image or a list of images (a multi-image prompt) -> parallel
    lists of images and sizes."""
    if pixel_values is None:
        return [], []
    if isinstance(pixel_values, (list, tuple)):
        if image_size is None:
            sizes = [None] * len(pixel_values)
        elif isinstance(image_size, (list, tuple)) and (
                not image_size or isinstance(image_size[0], (list, tuple))):
            sizes = list(image_size)
        else:
            raise ValueError("image_size must be a list of (h, w) when "
                             "pixel_values is a list")
        if len(sizes) != len(pixel_values):
            raise ValueError("len(image_size) != len(pixel_values)")
        return list(pixel_values), sizes
    return [pixel_values], [image_size]
