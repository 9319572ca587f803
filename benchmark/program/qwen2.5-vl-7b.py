"""Qwen2.5-VL-7B-Instruct as ``vispec_tpu_torch`` serves it: a SpecModel
with the Qwen2.5-VL tower (``qwen_cfg``, ``vparams``) over an M-RoPE
target and the ViSpec draft."""

from __future__ import annotations

from benchmark.program import _port
from vispec_tpu_torch.models.qwen2_5_vl import QwenVisionConfig
from vispec_tpu_torch.spec.spec_model import SpecModel

submit = _port.submit


def build(cfg: dict, weights: dict, device, mesh=None) -> SpecModel:
    vc = cfg["vision_config"]
    qcfg = QwenVisionConfig(
        hidden_size=vc["hidden_size"], out_hidden_size=vc["out_hidden_size"],
        intermediate_size=vc["intermediate_size"], depth=vc["depth"],
        num_heads=vc["num_heads"], patch_size=vc["patch_size"],
        temporal_patch_size=vc["temporal_patch_size"],
        spatial_merge_size=vc["spatial_merge_size"], window_size=vc["window_size"],
        fullatt_block_indexes=tuple(vc["fullatt_block_indexes"]),
        in_channels=vc["in_chans"], tokens_per_second=vc["tokens_per_second"])
    model = SpecModel(
        _port.text_config(cfg), _port.draft_config(cfg), _port.spec_config(cfg),
        weights["target"], weights["draft"], max_len=cfg["serve"]["max_len"],
        dtype=_port.dtype(cfg), device=device, eos_token_id=cfg["eos_token_id"],
        qwen_cfg=qcfg, vparams=weights["vision"],
        image_token_index=cfg["image_token_id"], video_token_index=cfg["video_token_id"],
        vision_start_token_id=cfg["vision_start_token_id"],
        min_pixels=cfg["image_processor"]["min_pixels"],
        max_pixels=cfg["image_processor"]["max_pixels"])
    return _port.place(model, mesh)
