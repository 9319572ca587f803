"""Mixtral-8x7B as ``vispec_tpu_torch`` serves it: a SpecModel over the
port's Mixtral target (``models/mixtral.py``) and a one-layer draft."""

from __future__ import annotations

from benchmark.program import _port
from vispec_tpu_torch.models.mixtral import MixtralConfig
from vispec_tpu_torch.spec.spec_model import SpecModel

submit = _port.submit


def build(cfg: dict, weights: dict, device, mesh=None) -> SpecModel:
    tcfg = _port.text_config(cfg, MixtralConfig,
                             num_local_experts=cfg["num_local_experts"],
                             num_experts_per_tok=cfg["num_experts_per_tok"])
    model = SpecModel(tcfg, _port.draft_config(cfg), _port.spec_config(cfg),
                      weights["target"], weights["draft"], max_len=cfg["serve"]["max_len"],
                      dtype=_port.dtype(cfg), device=device,
                      eos_token_id=cfg["eos_token_id"])
    return _port.place(model, mesh)
