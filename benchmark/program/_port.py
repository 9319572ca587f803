"""What the benchmark asks of the program under test, ``vispec_tpu_torch``:
its configs built from a configuration file, a ``SpecModel`` over the
benchmark's weights, and requests submitted to its serving engine."""

from __future__ import annotations

import numpy as np
import torch

from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig


def text_config(cfg: dict, cls=LlamaConfig, **extra):
    section = (cfg.get("rope_scaling") or {}).get("mrope_section")
    return cls(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
               intermediate_size=cfg["intermediate_size"],
               num_hidden_layers=cfg["num_hidden_layers"],
               num_attention_heads=cfg["num_attention_heads"],
               num_key_value_heads=cfg["num_key_value_heads"],
               hidden_act=cfg["hidden_act"],
               max_position_embeddings=cfg["max_position_embeddings"],
               rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
               qkv_bias=bool(cfg.get("qkv_bias", False)),
               tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
               mrope_section=None if section is None else tuple(section), **extra)


def draft_config(cfg: dict) -> DraftConfig:
    return DraftConfig(**cfg["draft"])


def spec_config(cfg: dict) -> SpecConfig:
    return SpecConfig(**cfg["spec"])


def place(model, mesh):
    """A model of a several-card cell keeps its shard (``shard_over``)."""
    if mesh is not None:
        model.shard_over(mesh)
    return model


def submit(engine, inp) -> int:
    """Submit one benchmark input; returns the engine's request id."""
    req = {"input_ids": np.asarray(inp.input_ids), "max_new_tokens": int(inp.cap)}
    if inp.image is not None:
        req["pixel_values"] = inp.image
        req["image_size"] = tuple(int(x) for x in inp.image.shape[:2])
    return engine.submit(req)


def dtype(cfg: dict):
    return getattr(torch, cfg["torch_dtype"])
