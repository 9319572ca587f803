"""Draft checkpoints back to the HF layout: the inverse of
``convert.hf.convert_draft`` (weights transposed back to ``nn.Linear``'s
``[out, in]``, the reference's module names), written as
``model.safetensors`` by the port's own writer (``write_safetensors``, the
inverse of ``convert.hf``'s reader) plus ``config.json``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import torch

from .hf import SAFETENSORS_DTYPES

_DTYPE_NAMES = {dt: name for name, dt in SAFETENSORS_DTYPES.items()}


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, any of the format's dtypes) to ``path``
    as safetensors: the JSON header padded with spaces to 8 bytes, then each
    tensor's little-endian bytes, one tensor at a time."""
    entries, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        entries[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                         "data_offsets": [offset, offset + n]}
        offset += n
    header = json.dumps(entries, separators=(",", ":")).encode()
    header += b" " * (-len(header) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for t in tensors.values():
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
            f.write(memoryview(raw.numpy()))


def draft_to_hf_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The draft's parameters under the reference's names, float32 (as the
    JAX package writes them), on the parameters' device."""
    def t(x):
        return x.float().T.contiguous()

    def a(x):
        return x.float().contiguous()

    layer = params["layer"]
    p = "layers.0."
    sd = {
        "embed_tokens.weight": a(params["embed"]),
        p + "self_attn.q_proj.weight": t(layer["wq"]),
        p + "self_attn.k_proj.weight": t(layer["wk"]),
        p + "self_attn.v_proj.weight": t(layer["wv"]),
        p + "self_attn.o_proj.weight": t(layer["wo"]),
        p + "mlp.gate_proj.weight": t(layer["w_gate"]),
        p + "mlp.up_proj.weight": t(layer["w_up"]),
        p + "mlp.down_proj.weight": t(layer["w_down"]),
        p + "post_attention_layernorm.weight": a(layer["post_norm"]),
        "fc.weight": t(params["fc_w"]),
    }
    for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
        if ours in layer:
            sd[p + f"self_attn.{theirs}.bias"] = a(layer[ours])
    if "fc_b" in params:
        sd["fc.bias"] = a(params["fc_b"])
    if "img_fc_w" in params:
        sd["img_fc.weight"] = t(params["img_fc_w"])
        if "img_fc_b" in params:
            sd["img_fc.bias"] = a(params["img_fc_b"])
    if "adaptor" in params:
        ad = params["adaptor"]
        sd["imadpt.q"] = a(ad["q"])
        for ours, theirs in (("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
            sd[f"imadpt.{theirs}.weight"] = t(ad[ours])
        if "bk" in ad:
            sd["imadpt.k_proj.bias"] = a(ad["bk"])
            sd["imadpt.v_proj.bias"] = a(ad["bv"])
    return sd


def save_draft(params: dict, outdir: str, draft_config: dict) -> str:
    """Write ``model.safetensors`` and ``config.json`` in the reference's
    layout under ``outdir``; returns the safetensors path."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "model.safetensors")
    write_safetensors(draft_to_hf_state_dict(params), path)
    with open(os.path.join(outdir, "config.json"), "w") as f:
        json.dump(draft_config, f, indent=2)
    return path
