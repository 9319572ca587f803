"""HF checkpoint ingestion: ``model.safetensors`` (also sharded, with its
``.index.json``) and ``pytorch_model.bin`` state dicts -> the port's
parameter dicts, in the JAX package's layouts.

``nn.Linear`` stores ``[out, in]``; the port's products take ``[in, out]``,
so every weight is transposed.  Layer weights are stacked ``[L, ...]``,
norms are float32, everything else is in the model dtype.

The safetensors reader is the port's own (the format: an 8-byte
little-endian header length, a JSON header of ``dtype`` / ``shape`` /
``data_offsets`` counted from the end of the header, then the raw
little-endian bytes), so loading needs nothing but torch.
``load_state_dict`` returns a lazy mapping: each tensor is read from disk
when it is looked up, moved to the device in its stored dtype, cast there,
and copied into its slot of a preallocated ``[L, ...]`` tensor, so the host
holds one tensor at a time and never a float32 copy of the checkpoint.
bf16 -> float32 -> bf16 and f16 -> float32 are exact, so the values equal
those of the JAX package's float32 route.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, Iterator, Mapping

import torch

from ..configs import DraftConfig, LlamaConfig

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors_header(path: str):
    """(the tensors' header entries by name, the byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class StateDict(Mapping):
    """A checkpoint's tensors by name, each read from disk on lookup as a
    CPU tensor in its stored dtype (``load_state_dict``)."""

    def __init__(self):
        self._safetensors: Dict[str, tuple] = {}  # name -> (path, entry, data start)
        self._tensors: Dict[str, torch.Tensor] = {}  # .bin entries (memory-mapped)

    def add_safetensors(self, path: str) -> None:
        header, start = read_safetensors_header(path)
        for name, entry in header.items():
            self._safetensors[name] = (path, entry, start)

    def add_torch_bin(self, path: str) -> None:
        sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        self._tensors.update({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})

    def __getitem__(self, name: str) -> torch.Tensor:
        if name in self._tensors:
            return self._tensors[name]
        path, entry, start = self._safetensors[name]
        begin, end = entry["data_offsets"]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        with open(path, "rb") as f:
            f.seek(start + begin)
            if f.readinto(memoryview(buf.numpy())) != end - begin:
                raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
        dtype = SAFETENSORS_DTYPES[entry["dtype"]]
        return buf.view(dtype).reshape(entry["shape"])

    def __contains__(self, name) -> bool:  # without reading the tensor
        return name in self._safetensors or name in self._tensors

    def __iter__(self) -> Iterator[str]:
        return iter([*self._safetensors, *self._tensors])

    def __len__(self) -> int:
        return len(self._safetensors) + len(self._tensors)


def _weight_map_files(index_path: str):
    with open(index_path) as f:
        return sorted(set(json.load(f)["weight_map"].values()))


def load_state_dict(path: str) -> StateDict:
    """A checkpoint directory or file as a lazy ``StateDict``, in the JAX
    package's order: ``model.safetensors.index.json`` (its shards),
    ``model.safetensors``, ``pytorch_model.bin.index.json``,
    ``pytorch_model.bin``; a file path is read as safetensors when its name
    ends in ``.safetensors``, else with ``torch.load``."""
    sd = StateDict()
    if not os.path.isdir(path):
        if path.endswith(".safetensors"):
            sd.add_safetensors(path)
        else:
            sd.add_torch_bin(path)
        return sd
    for index, add in (("model.safetensors.index.json", sd.add_safetensors),
                       ("model.safetensors", sd.add_safetensors),
                       ("pytorch_model.bin.index.json", sd.add_torch_bin),
                       ("pytorch_model.bin", sd.add_torch_bin)):
        p = os.path.join(path, index)
        if not os.path.exists(p):
            continue
        for f in _weight_map_files(p) if index.endswith(".json") else [index]:
            add(os.path.join(path, f))
        return sd
    raise FileNotFoundError(f"no checkpoint found under {path}")


def to_device(t, device) -> torch.Tensor:
    """A state-dict entry (tensor or array) on ``device`` in its own dtype."""
    return torch.as_tensor(t).to(device)


def tensor(sd: Mapping, key: str, dtype, device, transpose: bool = False) -> torch.Tensor:
    """``sd[key]`` on ``device`` in ``dtype`` (transposed: ``[out, in]`` ->
    ``[in, out]``), contiguous."""
    t = to_device(sd[key], device)
    return (t.T if transpose else t).to(dtype).contiguous()


def stack_layers(sd: Mapping, fmt: str, n: int, dtype, device,
                 transpose: bool = True) -> torch.Tensor:
    """``[n, ...]``: ``sd[fmt.format(i)]`` for layers ``0 .. n-1``
    (transposed unless told otherwise), each copied into its slot of one
    tensor preallocated on ``device`` in ``dtype``."""
    out = None
    for i in range(n):
        t = to_device(sd[fmt.format(i)], device)
        t = t.T if transpose else t
        if out is None:
            out = torch.empty((n, *t.shape), dtype=dtype, device=device)
        out[i].copy_(t)
    return out


def convert_draft(sd: Mapping, cfg: DraftConfig, dtype=torch.bfloat16, embed_fallback=None,
                  device="cuda") -> dict:
    """A ViSpec / EAGLE draft state dict (``embed_tokens``, ``layers.0.*``,
    ``fc``, ``img_fc``, ``imadpt.{q, k_proj, v_proj, o_proj}``) -> the
    draft's parameters.  ``embed_fallback`` (the target's embedding) stands
    in for a checkpoint without ``embed_tokens.weight``, as the reference
    copies the frozen embedding from the base model.  A config without
    ``vision`` (EAGLE-2) drops the image adaptor and ``img_fc``."""
    p = "layers.0."

    def w(key, transpose=True):
        return tensor(sd, key, dtype, device, transpose)

    layer = {"post_norm": tensor(sd, p + "post_attention_layernorm.weight", torch.float32,
                                 device)}
    for ours, theirs in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                         ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                         ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                         ("w_down", "mlp.down_proj")):
        layer[ours] = w(p + theirs + ".weight")
    if cfg.qkv_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layer[ours] = w(p + f"self_attn.{theirs}.bias", False)
    if "embed_tokens.weight" in sd:
        embed = w("embed_tokens.weight", False)
    elif embed_fallback is not None:
        embed = torch.as_tensor(embed_fallback).to(device=device, dtype=dtype)
    else:
        raise KeyError(
            "draft checkpoint has no embed_tokens.weight and no embed_fallback "
            "was provided (the reference copies the frozen embedding from the "
            "base model)")
    params = {"embed": embed, "layer": layer, "fc_w": w("fc.weight")}
    if "fc.bias" in sd:
        params["fc_b"] = w("fc.bias", False)
    if not cfg.vision:
        return params
    if "imadpt.q" in sd:
        adaptor = {"q": w("imadpt.q", False), "wk": w("imadpt.k_proj.weight"),
                   "wv": w("imadpt.v_proj.weight"), "wo": w("imadpt.o_proj.weight")}
        if cfg.qkv_bias and "imadpt.k_proj.bias" in sd:
            adaptor["bk"] = w("imadpt.k_proj.bias", False)
            adaptor["bv"] = w("imadpt.v_proj.bias", False)
        params["adaptor"] = adaptor
    if "img_fc.weight" in sd:
        params["img_fc_w"] = w("img_fc.weight")
        if "img_fc.bias" in sd:
            params["img_fc_b"] = w("img_fc.bias", False)
    return params


def convert_llama(sd: Mapping, cfg: LlamaConfig, dtype=torch.bfloat16,
                  prefix: str = "model.", lm_head_key: str = "lm_head.weight",
                  device="cuda", mlp: bool = True) -> dict:
    """An HF Llama / Qwen2 text-model state dict -> ``models/llama.py``
    parameters (a LLaVA checkpoint: ``prefix='language_model.model.'``,
    ``lm_head_key='language_model.lm_head.weight'``).  Without an lm_head the
    embedding is tied.  ``mlp=False`` leaves out the dense MLP (a Mixtral
    layer holds experts instead, ``models/mixtral.convert_mixtral``)."""
    l = cfg.num_hidden_layers
    lay = prefix + "layers.{}."

    def stack(name, transpose=True, dt=dtype):
        return stack_layers(sd, lay + name, l, dt, device, transpose)

    layers = {
        "input_norm": stack("input_layernorm.weight", False, torch.float32),
        "post_norm": stack("post_attention_layernorm.weight", False, torch.float32),
        "wq": stack("self_attn.q_proj.weight"),
        "wk": stack("self_attn.k_proj.weight"),
        "wv": stack("self_attn.v_proj.weight"),
        "wo": stack("self_attn.o_proj.weight"),
    }
    if mlp:
        layers.update(w_gate=stack("mlp.gate_proj.weight"), w_up=stack("mlp.up_proj.weight"),
                      w_down=stack("mlp.down_proj.weight"))
    if cfg.qkv_bias:
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            layers[ours] = stack(f"self_attn.{theirs}.bias", False)
    embed_key = prefix + "embed_tokens.weight"
    head_key = lm_head_key if lm_head_key in sd else embed_key  # tied embeddings
    return {
        "embed": tensor(sd, embed_key, dtype, device),
        "layers": layers,
        "final_norm": tensor(sd, prefix + "norm.weight", torch.float32, device),
        "lm_head": tensor(sd, head_key, dtype, device, transpose=True),
    }


def convert_clip_and_projector(sd: Mapping, vcfg, dtype=torch.bfloat16,
                               device="cuda") -> dict:
    """An HF LLaVA checkpoint's CLIP tower (``vision_tower.vision_model.*``),
    projector (``multi_modal_projector.linear_{1,2}``) and LLaVA-Next
    ``image_newline`` -> ``vparams``; LayerNorm weights and biases float32."""
    v = "vision_tower.vision_model."
    lay = v + "encoder.layers.{}."

    def stack(name, transpose=True, dt=dtype):
        return stack_layers(sd, lay + name, vcfg.num_hidden_layers, dt, device, transpose)

    patch_w = to_device(sd[v + "embeddings.patch_embedding.weight"], device)  # [w, 3, p, p]
    layers = {f"{ln}_{wb}": stack(f"layer_norm{ln[-1]}.{full}", False, torch.float32)
              for ln in ("ln1", "ln2") for wb, full in (("w", "weight"), ("b", "bias"))}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("o", "out_proj")):
        layers["w" + ours] = stack(f"self_attn.{theirs}.weight")
        layers["b" + ours] = stack(f"self_attn.{theirs}.bias", False)
    for i in (1, 2):
        layers[f"w_fc{i}"] = stack(f"mlp.fc{i}.weight")
        layers[f"b_fc{i}"] = stack(f"mlp.fc{i}.bias", False)
    out = {
        "vision": {
            "patch_w": patch_w.reshape(patch_w.shape[0], -1).T.to(dtype).contiguous(),
            "class_embed": tensor(sd, v + "embeddings.class_embedding", dtype,
                                  device).reshape(-1),
            "pos_embed": tensor(sd, v + "embeddings.position_embedding.weight", dtype, device),
            "pre_norm_w": tensor(sd, v + "pre_layrnorm.weight", torch.float32, device),
            "pre_norm_b": tensor(sd, v + "pre_layrnorm.bias", torch.float32, device),
            "layers": layers,
        },
    }
    for i in (1, 2):
        proj = f"multi_modal_projector.linear_{i}."
        out[f"proj_w{i}"] = tensor(sd, proj + "weight", dtype, device, transpose=True)
        out[f"proj_b{i}"] = tensor(sd, proj + "bias", dtype, device)
    if "image_newline" in sd:
        out["image_newline"] = tensor(sd, "image_newline", dtype, device)
    return out


def convert_qwen_vision(sd: Mapping, vcfg, dtype=torch.bfloat16, device="cuda") -> dict:
    """An HF Qwen2.5-VL checkpoint's ``visual.*`` tower -> the tree of
    ``models/qwen2_5_vl.py``; RMSNorm weights float32."""
    v = "visual."

    def stack(name, transpose=True, dt=dtype):
        return stack_layers(sd, v + "blocks.{}." + name, vcfg.depth, dt, device, transpose)

    patch_w = to_device(sd[v + "patch_embed.proj.weight"], device)  # [hidden, C, tp, p, p]
    blocks = {"norm1": stack("norm1.weight", False, torch.float32),
              "norm2": stack("norm2.weight", False, torch.float32),
              "wqkv": stack("attn.qkv.weight"), "bqkv": stack("attn.qkv.bias", False),
              "wo": stack("attn.proj.weight"), "bo": stack("attn.proj.bias", False)}
    for name in ("gate", "up", "down"):
        blocks["w_" + name] = stack(f"mlp.{name}_proj.weight")
        blocks["b_" + name] = stack(f"mlp.{name}_proj.bias", False)
    merger = {"ln_q": tensor(sd, v + "merger.ln_q.weight", torch.float32, device)}
    for ours, theirs in (("1", "0"), ("2", "2")):
        merger["w" + ours] = tensor(sd, v + f"merger.mlp.{theirs}.weight", dtype, device,
                                    transpose=True)
        merger["b" + ours] = tensor(sd, v + f"merger.mlp.{theirs}.bias", dtype, device)
    return {"patch_w": patch_w.reshape(patch_w.shape[0], -1).T.to(dtype).contiguous(),
            "blocks": blocks, "merger": merger}


def llama_config_from_hf(hf_cfg: dict) -> LlamaConfig:
    """An HF ``config.json`` (Llama / Qwen2 / Qwen2.5-VL text fields) ->
    ``LlamaConfig``."""
    rope_scaling = hf_cfg.get("rope_scaling") or {}
    mrope = rope_scaling.get("mrope_section")
    return LlamaConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        intermediate_size=hf_cfg["intermediate_size"],
        num_hidden_layers=hf_cfg["num_hidden_layers"],
        num_attention_heads=hf_cfg["num_attention_heads"],
        num_key_value_heads=hf_cfg.get("num_key_value_heads",
                                       hf_cfg["num_attention_heads"]),
        max_position_embeddings=hf_cfg.get("max_position_embeddings", 2048),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-6),
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rope_scaling_type=(rope_scaling.get("type")
                           if rope_scaling.get("type") in ("linear", "dynamic") else None),
        rope_scaling_factor=float(rope_scaling.get("factor", 1.0)),
        qkv_bias=(hf_cfg.get("model_type") == "qwen2"
                  or hf_cfg.get("attention_bias", False)),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        mrope_section=tuple(mrope) if mrope else None,
    )


def mixtral_config_from_hf(hf_cfg: dict):
    """An HF Mixtral ``config.json`` -> ``models.mixtral.MixtralConfig``."""
    from ..models.mixtral import MixtralConfig

    return MixtralConfig(**dataclasses.asdict(llama_config_from_hf(hf_cfg)),
                         num_local_experts=hf_cfg.get("num_local_experts", 8),
                         num_experts_per_tok=hf_cfg.get("num_experts_per_tok", 2))

