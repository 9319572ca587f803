"""Tiny configurations and a benchmark tree in a temporary directory, for
the CPU tests: the harness's own files copied, the manifest rewritten to
cells of tiny widths (same families, same code paths) on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent

TINY_VL = {
    "hidden_act": "silu", "hidden_size": 64, "initializer_range": 0.02,
    "intermediate_size": 128, "max_position_embeddings": 4096, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "torch_dtype": "float32",
    "vocab_size": 512, "qkv_bias": True, "bos_token_id": 1, "eos_token_id": 503,
    "vision_start_token_id": 501, "vision_end_token_id": 502, "vision_token_id": 505,
    "image_token_id": 500, "video_token_id": 504,
    "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]},
    "vision_config": {"depth": 2, "hidden_act": "silu", "hidden_size": 32,
                      "intermediate_size": 64, "num_heads": 2, "in_chans": 3,
                      "out_hidden_size": 64, "patch_size": 14, "spatial_merge_size": 2,
                      "spatial_patch_size": 14, "window_size": 56,
                      "fullatt_block_indexes": [1], "tokens_per_second": 2,
                      "temporal_patch_size": 2},
    "source": "test", "reduced": [],
    "draft": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
              "rope_theta": 10000.0, "qkv_bias": True, "fc_bias": True, "num_q": 2,
              "vision": True},
    "spec": {"total_tokens": 10, "depth": 3, "top_k": 3},
    "serve": {"max_len": 512, "batch_size": 2},
    "text_id_range": [3, 400],
    "image_processor": {"min_pixels": 3136, "max_pixels": 1003520},
}

TINY_MOE = {
    "hidden_act": "silu", "hidden_size": 64, "initializer_range": 0.02,
    "intermediate_size": 96, "max_position_embeddings": 4096, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 4, "num_local_experts": 4,
    "num_experts_per_tok": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "tie_word_embeddings": False, "torch_dtype": "float32", "vocab_size": 256,
    "bos_token_id": 1, "eos_token_id": 2, "source": "test",
    "reduced": ["num_hidden_layers"],
    "draft": {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 96,
              "num_attention_heads": 4, "num_key_value_heads": 4,
              "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0, "qkv_bias": False, "fc_bias": True, "num_q": 2,
              "vision": True},
    "spec": {"total_tokens": 10, "depth": 3, "top_k": 3},
    "serve": {"max_len": 512, "batch_size": 2},
    "text_id_range": [3, 256],
}

TINY_IMAGE_MIX = {
    "loop": "open", "rate_per_s": 4.0, "schedule_seed": 1,
    "prompt": {"text_tokens": {"dist": "uniform", "min": 4, "max": 24},
               "images": [{"size": [56, 56], "weight": 0.5},
                          {"size": [112, 84], "weight": 0.5}]},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 16},
}

TINY_CHAT_MIX = {
    "loop": "closed", "clients": 2, "requests_per_client_per_s": 2.0, "schedule_seed": 1,
    "prompt": {"text_tokens": {"dist": "lognormal", "median": 40, "sigma": 0.7, "min": 8,
                               "max": 200}},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 16},
}

CHECK = {"sample_requests": 100, "min_served_tokens": 4, "widest_logit_gap": 1e-3,
         "worst_median_logit_gap": 1e-4}


def tree(tmp: Path, chips: int = 1, mesh=None) -> Path:
    """A benchmark tree under ``tmp`` with two tiny cells, ``tiny-vl.image``
    and ``tiny-moe.chat``; returns the manifest's path."""
    root = tmp / "root"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    moe = dict(TINY_MOE, **({"mesh": mesh} if mesh else {}))
    for name, cfg, family in (("tiny-vl", TINY_VL, "qwen2.5-vl-7b"),
                              ("tiny-moe", moe, "mixtral-8x7b")):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        for kind in ("reference", "program"):
            shutil.copy(bench / kind / f"{family}.py", bench / kind / f"{name}.py")
    (bench / "traffic" / "tiny-image.json").write_text(json.dumps(TINY_IMAGE_MIX))
    (bench / "traffic" / "tiny-chat.json").write_text(json.dumps(TINY_CHAT_MIX))
    (bench / "cells" / "tiny-vl.image.json").write_text(json.dumps(
        {"engine": {"pad_bucket": [128, 256], "max_span": 64, "chunk_rounds": 4},
         "check": CHECK}))
    (bench / "cells" / "tiny-moe.chat.json").write_text(json.dumps(
        {"engine": {"pad_bucket": [128, 256], "chunk_rounds": 4}, "check": CHECK}))
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    man = copy.deepcopy(man)
    man["configs"] = [
        {"name": "tiny-vl", "source": "test", "file": "benchmark/configs/tiny-vl.json",
         "reduced": [], "why": "test"},
        {"name": "tiny-moe", "source": "test", "file": "benchmark/configs/tiny-moe.json",
         "reduced": [], "why": "test"}]
    man["workloads"] = [
        {"name": "tiny-vl.image", "config": "tiny-vl", "traffic": "tiny-image",
         "chips": 1, "why": "test"},
        {"name": "tiny-moe.chat", "config": "tiny-moe", "traffic": "tiny-chat",
         "chips": chips, "why": "test"}]
    rename = {"mixtral-8x7b.chat": "tiny-moe.chat",
              "qwen2.5-vl-7b.image-chat": "tiny-vl.image"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]]
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(man, indent=1))
    return path


def load(man: Path, name: str):
    from benchmark.lib import manifest

    return manifest.load_cell(name, man, man.parent / "benchmark")
