"""Model / draft / speculation configuration dataclasses.

Own copy of the JAX package's configs (the port imports nothing from it).
Frozen dataclasses, so configs are hashable and compare by value.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LlamaConfig:
    """Decoder-only transformer config (LLaMA / Vicuna text backbones).

    The defaults are Vicuna-7B's published widths."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    hidden_act: str = "silu"
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling_type: Optional[str] = None  # None | "linear" | "dynamic"
    rope_scaling_factor: float = 1.0
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    mrope_section: Optional[Tuple[int, int, int]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclass(frozen=True)
class DraftConfig:
    """ViSpec / EAGLE one-layer draft model config."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 1
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    hidden_act: str = "silu"
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    fc_bias: bool = True
    num_q: int = 2  # learned image-compression queries
    # False => EAGLE-2 draft: no ImgAdaptor, no img_fc
    vision: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def from_json(cls, path: str, num_q: int = 2) -> "DraftConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in fields}
        if "bias" in raw:
            kwargs["fc_bias"] = bool(raw["bias"])
        if raw.get("num_key_value_heads") is None:
            kwargs["num_key_value_heads"] = raw.get(
                "num_attention_heads", cls.num_attention_heads
            )
        kwargs["num_q"] = num_q
        return cls(**kwargs)


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding hyper-parameters (depth=3, top_k=8,
    total_tokens=30 are the reference driver's values).  ``total_tokens``
    counts verify-tree nodes including the sampled root."""

    total_tokens: int = 30
    depth: int = 3
    top_k: int = 8

    @property
    def num_draft(self) -> int:
        """Drafted (non-root) node count."""
        return self.total_tokens - 1

    @property
    def num_candidates(self) -> int:
        """Flat candidate pool size scored during beam expansion."""
        return self.top_k + self.top_k * self.top_k * self.depth
