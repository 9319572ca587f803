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

``shard_over`` (or ``from_pretrained(mesh=...)``) places the model over a
rank mesh (``parallel/mesh.py``): every rank of a ``torchrun`` world builds
the same model, keeps its shard of the weights and caches, and runs the
same calls; each rank's result is the whole generation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import clip_vit, llama, llava
from ..models import medusa, mixtral
from ..models import qwen2_5_vl as qwen_vl
from ..ops import kv_cache as kv
from ..ops import rng
from ..ops.attention import causal_mask
from ..ops.quant import quantize_draft_params, quantize_target_params
from ..ops.sampling import seen_mask
from ..parallel import sharding
from . import loop as spec_loop


def _bucket(n: int, step: int = 128) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _first(x):
    return x[0] if isinstance(x, list) else x


def padded_text_embeds(tparams: dict, input_ids, pad_len: int, device,
                       mesh=None) -> torch.Tensor:
    """Token embeddings of a text prompt, zero rows to ``pad_len``."""
    x = llama.embed(tparams, torch.as_tensor(np.asarray(input_ids, np.int64), device=device),
                    mesh)
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


class ConversationSnapshot:
    """What a finished text generation leaves for the next turn of its
    conversation (``specgenerate(keep_hiddens=True)``): copies of the
    committed target and draft cache rows (and the int8 cache's row scales),
    the target's verify hidden of every generated token, and the committed
    ids.  ``specgenerate(..., continue_from=snap)`` with a prompt that
    extends a committed prefix reuses those rows and prefills only the
    suffix."""

    def __init__(self, t_k, t_v, d_k, d_v, hiddens, seq, prompt_len, t_ks=None,
                 t_vs=None):
        self.t_k, self.t_v, self.d_k, self.d_v = t_k, t_v, d_k, d_v
        self.t_ks, self.t_vs = t_ks, t_vs  # int8-cache row scales, or None
        self.hiddens = hiddens  # [max_out, hidden], indexed like the output
        self.seq = np.asarray(seq)  # committed ids: prompt + trimmed output
        self.prompt_len = int(prompt_len)

    def cut_for(self, input_ids) -> Optional[int]:
        """The longest reusable committed prefix of ``input_ids``, or None.
        A cut lies past the original prompt (hiddens exist only for
        generated tokens) and leaves at least one suffix token."""
        ids = np.asarray(input_ids)
        m = min(len(self.seq), len(ids) - 1)
        if m <= self.prompt_len:
            return None
        neq = np.nonzero(ids[:m] != self.seq[:m])[0]
        plen = int(neq[0]) if neq.size else m
        return plen if plen > self.prompt_len else None


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
        llava_cfg: Optional[llava.LlavaConfig] = None,
        vparams: Optional[dict] = None,
        eos_token_id: int = 2,
        image_token_index: Optional[int] = None,
        qwen_cfg: Optional[qwen_vl.QwenVisionConfig] = None,
        vision_start_token_id: int = 151652,
        video_token_index: Optional[int] = None,
        mparams: Optional[dict] = None,  # Medusa heads => the Medusa decode path
        min_pixels: int = 256 * 28 * 28,  # the Qwen image budget (HF processor's)
        max_pixels: int = 1280 * 28 * 28,
        video_max_pixels: int = 768 * 28 * 28,  # per-frame budget of a video
        quantize_draft=False,  # False | True/"int8" | "int4" | "int4_head" | "mixed" | "auto"
        quantize_kv: bool = False,  # int8 target KV cache with per-row scales
        device="cuda",
    ):
        if max_len % 128 != 0:
            raise ValueError(
                f"max_len must be a multiple of 128 (prompt buckets assume it); "
                f"got {max_len}")
        self.mesh = None  # set by shard_over
        self._pp = False
        self._sp = False
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
        self.last_snapshot: Optional[ConversationSnapshot] = None  # keep_hiddens
        self.last_autotune_s: Optional[dict] = None  # autotune_total_token's times
        # the caches are allocated at first use: at 7B/2048 the target cache
        # alone is 1 GB in bf16
        self._target_cache: Optional[kv.KVCache] = None
        self._draft_cache: Optional[kv.KVCache] = None
        # slot-stacked caches of specgenerate_batch, kept across calls
        self._batch_pool: List = []

    @property
    def target_cache(self) -> kv.KVCache:
        if self._target_cache is None:
            # under a mesh, this rank's part (shard_over ran before first touch)
            layers, heads = sharding.local_cache_dims(
                self.mesh, self.tcfg.num_hidden_layers, self.tcfg.num_key_value_heads,
                pp=self._pp)
            self._target_cache = kv.init_cache(
                layers, heads, self.max_len, self.tcfg.head_dim, self.dtype, self.device,
                quantized=self.quantize_kv)
        return self._target_cache

    @target_cache.setter
    def target_cache(self, cache) -> None:
        self._target_cache = cache

    @property
    def draft_cache(self) -> kv.KVCache:
        if self._draft_cache is None:
            layers, heads = sharding.local_cache_dims(
                self.mesh, self.dcfg.num_hidden_layers, self.dcfg.num_key_value_heads)
            self._draft_cache = kv.init_cache(
                layers, heads, self.max_len, self.dcfg.head_dim, self.dtype, self.device)
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
        self._refuse_sharded("quantize_draft_inplace")
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
        self._refuse_sharded("quantize_target_inplace")
        quantize_target_params(self.tparams, mode=mode, inplace=True)
        self.quantize_target = mode

    def _refuse_sharded(self, what: str) -> None:
        if self.mesh is not None:
            raise ValueError(f"{what} after shard_over: quantize first, then shard, "
                             "as the JAX package orders them")

    # ------------------------------------------------------------------
    def shard_over(self, mesh, pp: bool = False, sp: bool = False) -> None:
        """Keep this rank's shard of the weights and single-request caches
        (``parallel/sharding.py``), the public entry to multi-device
        inference.  Every rank of the mesh's world calls it on the same
        model and then makes the same calls.

        Default: tensor parallelism (heads, MLP columns and a Mixtral
        target's experts over ``tp``, embed and head over the vocab, KV
        caches over heads).  ``pp=True`` places the target's layers (and its
        cache's) in stages over ``pp``; ``sp=True`` splits each prefill's
        prompt rows over ``sp``.  A mesh with pp (sp) > 1 needs ``pp=True``
        (``sp=True``): its ranks would otherwise hold the same layers (rows)
        and the port does not repeat work silently.  The draft (quantized or
        not) shards over tp and never over pp; the vision tower and Medusa
        heads stay whole.  Caches that exist are cut now; the lazy ones are
        allocated at this rank's size on first touch.  Quantize before
        sharding.  The engine (``serving_engine``) is not sharded."""
        if mesh.shape["pp"] > 1 and not pp or mesh.shape["sp"] > 1 and not sp:
            raise ValueError(f"a mesh with pp={mesh.shape['pp']} sp={mesh.shape['sp']} "
                             f"needs shard_over(pp={mesh.shape['pp'] > 1}, "
                             f"sp={mesh.shape['sp'] > 1})")
        if torch.device(mesh.device) != self.device:
            raise ValueError(f"the model lives on {self.device}, the mesh on {mesh.device}")
        if "router" in self.tparams.get("layers", {}):
            tspecs = (sharding.mixtral_param_specs_pp(self.tcfg) if pp
                      else sharding.mixtral_param_specs(self.tcfg))
        else:
            tspecs = (sharding.llama_param_specs_pp(self.tcfg) if pp
                      else sharding.llama_param_specs(self.tcfg))
        tspecs = sharding.quantize_aware_specs(tspecs, self.tparams)
        # a draft that shares the target's embed keeps sharing its shard
        aliased = self.dparams.get("embed") is self.tparams.get("embed")
        self.tparams = sharding.apply_specs(mesh, self.tparams, tspecs)
        draft = {k: v for k, v in self.dparams.items() if not (aliased and k == "embed")}
        if self.dparams.get("layer"):
            draft = sharding.apply_specs(mesh, draft,
                                         sharding.quantized_draft_specs(self.dcfg, draft))
        self.dparams = {**draft, **({"embed": self.tparams["embed"]} if aliased else {})}
        # cut only the caches that exist: an engine-only model never
        # allocates the single-request pair
        if self._target_cache is not None:
            self._target_cache = sharding.shard_cache(mesh, self._target_cache, pp=pp)
        if self._draft_cache is not None:
            self._draft_cache = sharding.shard_cache(mesh, self._draft_cache)
        self.mesh, self._pp, self._sp = mesh, pp, sp

    def _cache_slack(self) -> int:
        """Rows of headroom beyond prompt + generated tokens: the verify tree
        block (target) and the draft's beam scratch plus the padded
        accepted-append block."""
        draft_scratch = self.spec.depth * self.spec.top_k + self.spec.depth + 2
        return max(self.spec.total_tokens, draft_scratch) + 10

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(
        cls,
        base_model_path: str,
        spec_model_path: Optional[str],
        total_token: int = 30,
        depth: int = 3,
        top_k: int = 8,
        threshold: float = 1.0,
        num_q: int = 2,
        max_len: int = 2048,
        dtype=torch.bfloat16,
        method: str = "vispec",  # "vispec" | "eagle" | "medusa"
        min_pixels: int = 256 * 28 * 28,
        max_pixels: int = 1280 * 28 * 28,
        video_max_pixels: int = 768 * 28 * 28,
        quantize_draft=False,  # False | True/"int8" | "int4" | "int4_head" | "mixed" | "auto"
        quantize_kv: bool = False,
        mesh=None,  # parallel.mesh.Mesh: shard_over() the loaded model
        pp: bool = False,  # with mesh: layer-stage placement of the target
        sp: bool = False,  # with mesh: sequence-parallel prompt prefill
        device="cuda",
    ) -> "SpecModel":
        """Load an HF checkpoint directory (``config.json`` and its
        safetensors or ``.bin`` weights, ``convert/hf.py``) as the target, and
        ``spec_model_path`` as the drafter: a ViSpec draft (``method``
        "vispec"), the same without its image adaptor ("eagle") or Medusa
        heads ("medusa"); None builds a target-only model with a stub draft.
        Targets: ``LlamaForCausalLM``, ``Qwen2ForCausalLM``,
        ``MixtralForCausalLM``, ``Llava(Next)ForConditionalGeneration`` (its
        text model at 8,192 positions, as the reference forces) and
        ``Qwen2_5_VLForConditionalGeneration``.  Weights land on ``device``
        in ``dtype`` tensor by tensor.  ``total_token=-1`` picks the verify
        tree's width with ``autotune_total_token``.  ``threshold`` is
        accepted and unused, as in the reference.  ``mesh`` (with ``pp`` /
        ``sp``) shards the loaded model with ``shard_over``: every rank reads
        the checkpoint onto the mesh's device and keeps its shard."""
        del threshold
        from ..convert import hf

        if mesh is not None:
            device = mesh.device

        with open(os.path.join(base_model_path, "config.json")) as f:
            hf_cfg = json.load(f)
        arch = hf_cfg["architectures"][0]
        autotune = total_token == -1
        # the largest candidate sizes the cache slack until the autotune runs
        spec_cfg = SpecConfig(total_tokens=60 if autotune else total_token, depth=depth,
                              top_k=top_k)
        kw = dict(max_len=max_len, dtype=dtype, quantize_draft=quantize_draft,
                  quantize_kv=quantize_kv, device=device,
                  eos_token_id=_first(hf_cfg.get("eos_token_id", 2)))
        sd = hf.load_state_dict(base_model_path)
        if arch in ("LlavaForConditionalGeneration", "LlavaNextForConditionalGeneration"):
            tcfg = dataclasses.replace(hf.llama_config_from_hf(hf_cfg["text_config"]),
                                       max_position_embeddings=8192)
            tparams = hf.convert_llama(sd, tcfg, dtype, prefix="language_model.model.",
                                       lm_head_key="language_model.lm_head.weight",
                                       device=device)
            vraw = hf_cfg["vision_config"]
            vcfg = clip_vit.ClipVisionConfig(
                hidden_size=vraw["hidden_size"], intermediate_size=vraw["intermediate_size"],
                num_hidden_layers=vraw["num_hidden_layers"],
                num_attention_heads=vraw["num_attention_heads"],
                image_size=vraw["image_size"], patch_size=vraw["patch_size"],
                feature_layer=hf_cfg.get("vision_feature_layer", -2))
            llava_cfg = llava.LlavaConfig(
                text=tcfg, vision=vcfg,
                image_token_index=hf_cfg.get("image_token_index", 32000),
                anyres=arch == "LlavaNextForConditionalGeneration",
                image_grid_pinpoints=tuple(tuple(p) for p in hf_cfg.get(
                    "image_grid_pinpoints", llava.DEFAULT_PINPOINTS)))
            kw.update(llava_cfg=llava_cfg, image_token_index=llava_cfg.image_token_index,
                      vparams=hf.convert_clip_and_projector(sd, vcfg, dtype, device=device))
        elif arch in ("LlamaForCausalLM", "Qwen2ForCausalLM"):
            tcfg = hf.llama_config_from_hf(hf_cfg)
            tparams = hf.convert_llama(sd, tcfg, dtype, device=device)
        elif arch == "MixtralForCausalLM":
            tcfg = hf.mixtral_config_from_hf(hf_cfg)
            tparams = mixtral.convert_mixtral(sd, tcfg, dtype, device=device)
        elif arch == "Qwen2_5_VLForConditionalGeneration":
            tcfg, tparams = cls._from_pretrained_qwen_vl(sd, hf_cfg, dtype, kw,
                                                         min_pixels, max_pixels,
                                                         video_max_pixels)
        else:
            raise NotImplementedError(f"architecture {arch} not yet supported")
        del sd

        if spec_model_path is None:
            dcfg, dparams = _stub_draft_config(tcfg, num_q), _stub_draft_params(tparams, dtype)
        else:
            dsd = hf.load_state_dict(spec_model_path)
            cfg_path = os.path.join(spec_model_path, "config.json")
            if os.path.exists(cfg_path):
                dcfg = DraftConfig.from_json(cfg_path, num_q=num_q)
            else:
                dcfg = DraftConfig(
                    vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
                    intermediate_size=tcfg.intermediate_size,
                    num_attention_heads=tcfg.num_attention_heads,
                    num_key_value_heads=tcfg.num_key_value_heads, num_q=num_q)
            if method == "medusa":
                kw["mparams"] = medusa.convert_medusa(dsd, dtype, device=device)
                dparams = _stub_draft_params(tparams, dtype)
            else:
                if method == "eagle":
                    dcfg = dataclasses.replace(dcfg, vision=False)
                dparams = hf.convert_draft(dsd, dcfg, dtype, embed_fallback=tparams["embed"],
                                           device=device)
        model = cls(tcfg, dcfg, spec_cfg, tparams, dparams, **kw)
        if mesh is not None:
            model.shard_over(mesh, pp=pp, sp=sp)
        if autotune:
            model.autotune_total_token()
        return model

    @staticmethod
    def _from_pretrained_qwen_vl(sd, hf_cfg: dict, dtype, kw: dict, min_pixels: int,
                                 max_pixels: int, video_max_pixels: int):
        """The Qwen2.5-VL branch of ``from_pretrained``: the text model (qkv
        bias, M-RoPE sections, 4,096 positions as the reference forces) and
        the vision tower; fills ``kw`` with the tower and the token ids.
        Returns (target config, target parameters)."""
        from ..convert import hf

        device = kw["device"]
        tcfg = dataclasses.replace(hf.llama_config_from_hf(hf_cfg),
                                   max_position_embeddings=4096, qkv_bias=True)
        tparams = hf.convert_llama(sd, tcfg, dtype, device=device)
        vraw = hf_cfg["vision_config"]
        qcfg = qwen_vl.QwenVisionConfig(
            hidden_size=vraw["hidden_size"],
            out_hidden_size=vraw.get("out_hidden_size", hf_cfg["hidden_size"]),
            intermediate_size=vraw["intermediate_size"], depth=vraw["depth"],
            num_heads=vraw["num_heads"], patch_size=vraw["patch_size"],
            temporal_patch_size=vraw["temporal_patch_size"],
            spatial_merge_size=vraw["spatial_merge_size"], window_size=vraw["window_size"],
            fullatt_block_indexes=tuple(vraw["fullatt_block_indexes"]),
            tokens_per_second=vraw.get("tokens_per_second", 2))
        kw.update(
            vparams=hf.convert_qwen_vision(sd, qcfg, dtype, device=device), qwen_cfg=qcfg,
            eos_token_id=_first(hf_cfg.get("eos_token_id", 151645)),
            image_token_index=hf_cfg.get("image_token_id", 151655),
            video_token_index=hf_cfg.get("video_token_id", 151656),
            vision_start_token_id=hf_cfg.get("vision_start_token_id", 151652),
            min_pixels=min_pixels, max_pixels=max_pixels, video_max_pixels=video_max_pixels)
        return tcfg, tparams

    # ------------------------------------------------------------------
    @torch.no_grad()
    def autotune_total_token(self, cans=(40, 48, 50, 56, 60),
                             weights=(1.0, 1.05, 1.07, 1.1, 1.13), iters: int = 20) -> int:
        """Pick the verify tree's width: time ``iters`` target forwards of
        each candidate width from a reset cache (CUDA events after a warm-up
        forward on the card, ``perf_counter`` on the CPU), divide by the
        expected acceptance gain ``weights``, keep the argmin, and set it in
        ``self.spec`` (the reference's ``total_token == -1`` path).  Each
        candidate's seconds over its weight stay in ``self.last_autotune_s``."""
        cache = kv.reset(self.target_cache)
        cuda = self.device.type == "cuda"
        times = []
        for length, weight in zip(cans, weights):
            ids = np.random.default_rng(0).integers(0, max(2, self.tcfg.vocab_size - 200),
                                                    length)
            embeds = llama.embed(self.tparams, torch.as_tensor(ids, device=self.device),
                                 self.mesh)
            mask = causal_mask(length, cache.max_len, 0, self.device)
            pos = torch.arange(length, dtype=torch.int32, device=self.device)

            def forward():
                spec_loop.target_forward(self.tparams, self.tcfg, embeds, pos, cache, mask,
                                         mesh=self.mesh)

            forward()  # warm-up
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
            for _ in range(iters):
                forward()
            if cuda:
                end.record()
                end.synchronize()
                elapsed = start.elapsed_time(end) / 1e3
            else:
                elapsed = time.perf_counter() - t0
            times.append(elapsed / weight)
        best = cans[times.index(min(times))]
        self.spec = dataclasses.replace(self.spec, total_tokens=best)
        self.last_autotune_s = dict(zip(cans, times))
        return best

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
            return PaddedPrompt(padded_text_embeds(self.tparams, ids, pad_len, self.device,
                                                   self.mesh), None, None, 0, None)
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
                                    self.device, self.mesh)
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
        second_per_grid_ts: float = 1.0,
        seed: int = 0,
        log: bool = False,  # accepted and unused, as in the JAX package
        stop_token_id: Optional[int] = None,
        repetition_penalty: float = 1.0,  # active at T > 0 only
        keep_hiddens: bool = False,  # record self.last_snapshot (text prompts)
        continue_from: Optional["ConversationSnapshot"] = None,
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
        penalty, as the JAX package does.

        Multi-turn conversations: ``keep_hiddens=True`` leaves a
        ``ConversationSnapshot`` of this generation in ``self.last_snapshot``
        (text prompts of a ViSpec or EAGLE-2 model only), and a later call
        with ``continue_from=snap`` whose prompt extends the snapshot's
        committed tokens prefills only the new suffix.  A suffix that would
        not fit the cache, a vision prompt and a Medusa model take the full
        prefill instead."""
        del log
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
        text_only = pixel_values is None and pixel_values_videos is None
        snapshots_on = keep_hiddens and text_only and self.mparams is None

        state = None
        if continue_from is not None and text_only and self.mparams is None:
            plen = continue_from.cut_for(input_ids)
            # the suffix block is written at row plen: a suffix whose bucket
            # and the round's slack would not fit takes the full prefill
            if plen is not None and (plen + _bucket(l - plen) + self._cache_slack()
                                     <= self.max_len):
                state = self._prefill_from_snapshot(continue_from, input_ids, plen,
                                                    sampling, key, max_out, seen=seen,
                                                    keep_hiddens=snapshots_on)
        if state is None:
            prompt = self._padded_prompt(input_ids, pad_len, pixel_values, image_size,
                                         pixel_values_videos, second_per_grid_ts)
            if self.mparams is not None:
                state = spec_loop.medusa_prefill(
                    self.tparams, self.mparams, self.tcfg, self.spec, sampling,
                    prompt.embeds, l, kv.reset(self.target_cache), max_out, key=key,
                    mesh=self.mesh)
            else:
                plan, max_span = plan_prompt(self.dcfg, prompt.shifted, prompt.n_spans,
                                             l, pad_len, self.device)
                state = spec_loop.spec_prefill(
                    self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, plan,
                    sampling, prompt.embeds, kv.reset(self.target_cache),
                    kv.reset(self.draft_cache), max_out, max_span, key=key, seen=seen,
                    rope=prompt.rope, keep_hiddens=snapshots_on, mesh=self.mesh)

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
        seq = np.concatenate([input_ids, out])
        if snapshots_on:
            # copies of the committed rows: the caches are reused by the
            # next call
            pad = _bucket(seq.shape[0])
            tc, dc = state.target_cache, state.draft_cache

            def rows(t):
                return None if t is None else t[:, :, :pad].clone()

            self.last_snapshot = ConversationSnapshot(
                t_k=rows(tc.k), t_v=rows(tc.v), d_k=rows(dc.k), d_v=rows(dc.v),
                hiddens=state.hiddens, seq=seq, prompt_len=l,
                t_ks=rows(tc.k_scale), t_vs=rows(tc.v_scale))
        self.target_cache = kv.reset(state.target_cache)
        if self.mparams is None:
            self.draft_cache = kv.reset(state.draft_cache)
        return GenerationResult(
            sequences=seq,
            new_tokens=int(out.shape[0]),
            rounds=rounds,
            acceptance_lengths=accept_lengths,
            decode_time=decode_time,
            dispatched=dispatched,
        )

    def _prefill_from_snapshot(self, snap: "ConversationSnapshot", input_ids, plen: int,
                               sampling, key, max_out: int, seen=None,
                               keep_hiddens: bool = False) -> spec_loop.SpecState:
        """The continuation prefill from a ``ConversationSnapshot``: the
        caches take its committed rows ``[0, plen)``, and only the suffix
        runs through the target (``loop.spec_prefill_continue``).  ``seen``
        (the repetition penalty's mask, built from the whole conversation)
        rides along."""
        suffix = np.asarray(input_ids, np.int64)[plen:]
        s_embeds = padded_text_embeds(self.tparams, suffix, _bucket(len(suffix)),
                                      self.device, self.mesh)
        psnap = spec_loop.PrefixSnapshot(
            t_k=snap.t_k, t_v=snap.t_v, d_k=snap.d_k, d_v=snap.d_v,
            prefix_len=torch.tensor(plen, dtype=torch.int32, device=self.device),
            boundary_hidden=snap.hiddens[plen - 1 - snap.prompt_len],
            t_ks=snap.t_ks, t_vs=snap.t_vs)
        return spec_loop.spec_prefill_continue(
            self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, sampling, psnap,
            s_embeds, torch.tensor(len(suffix), dtype=torch.int32, device=self.device),
            kv.reset(self.target_cache), kv.reset(self.draft_cache), max_out, key=key,
            seen=seen, keep_hiddens=keep_hiddens, mesh=self.mesh)

    def _round(self, sampling, state, eos, cap):
        """One decode round of this model's drafter."""
        if self.mparams is not None:
            return spec_loop.medusa_decode_round(self.tparams, self.mparams, self.tcfg,
                                                 self.spec, sampling, state, eos, cap,
                                                 self.mesh)
        return spec_loop.decode_round(self.tparams, self.dparams, self.tcfg, self.dcfg,
                                      self.spec, sampling, state, eos, cap, self.mesh)

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
        second_per_grid_ts: float = 1.0,
        seed: int = 0,
        repetition_penalty: float = 1.0,
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
            rope=prompt.rope, mesh=self.mesh)
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
                    rope_delta=delta, mesh=self.mesh)
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
        seed: int = 0,
        top_p: float = 0.0,
        top_k: int = 0,
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
            self.max_len, max_out, self.dtype, seed, cache_pool=self._batch_pool,
            mparams=self.mparams, quantize_kv=self.quantize_kv, device=self.device,
            mesh=self.mesh)
        # decode_time excludes prefill, as in specgenerate
        t0 = time.perf_counter()
        budget = min(max_new_tokens, self.max_len - max(len(p) for p in prompts) - slack)
        states, accepts, dispatched = batch_mod.drain_batch(
            self.tparams, self.dparams, self.tcfg, self.dcfg, self.spec, sampling, states,
            budget, self.eos_token_id, self.chunk_rounds, mparams=self.mparams,
            mesh=self.mesh)
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
        fixed decode slots, queued requests admitted as slots free up.  On a
        sharded model every rank builds it and submits the same requests in
        the same order (the engine's docstring)."""
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
