"""HF checkpoint loading of the port (convert/hf.py, convert/export.py,
SpecModel.from_pretrained) against the JAX package and the safetensors
package, on fabricated HF-layout checkpoint directories
(tests/test_from_pretrained.py, tests/vlm_fixtures.py, and
tests/test_mixtral.py's Mixtral layout) in float32 on the CPU.

The port's own safetensors reader must equal the safetensors package for
every dtype, and its writer must be read back by it.  ``from_pretrained``
must give the JAX package's ``from_pretrained`` parameters exactly (the JAX
trees through ``convert.params.from_numpy``) for every architecture branch
and drafter, and the same tokens.

Each test runs in this module's child pytest process
(``tests.torch_parity.in_fresh_interpreter``), so its JAX compiles stay
out of the process that runs the rest of the suite."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from tests.test_from_pretrained import write_draft_ckpt, write_llama_ckpt
from tests.torch_parity import CPU, in_fresh_interpreter, t2n, to_numpy_tree
from tests.vlm_fixtures import (IMAGE_TOKEN, VISION_START, write_llava_ckpt,
                                write_qwen_vl_ckpt, write_vision_draft_ckpt)
from vispec_tpu.convert import export as jexport
from vispec_tpu.spec.spec_model import SpecModel as JSpecModel
from vispec_tpu_torch.convert import export as texport
from vispec_tpu_torch.convert import hf as thf
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models.medusa import NUM_HEADS
from vispec_tpu_torch.ops.quant import Q4Tensor, QTensor
from vispec_tpu_torch.spec.spec_model import SpecModel as TSpecModel

H, I, V, L, E = 48, 96, 160, 2, 4
LOAD = dict(total_token=12, depth=3, top_k=4, max_len=512)
PROMPT = list(range(10, 40))
NEW = 12


def _w(rng, *shape):
    return rng.normal(0, 0.05, shape).astype(np.float32)


def write_mixtral_ckpt(d):
    """tests/test_mixtral.py::test_mixtral_from_pretrained's checkpoint."""
    rng = np.random.default_rng(3)
    sd = {"model.embed_tokens.weight": _w(rng, V, H), "model.norm.weight": np.ones(H, np.float32),
          "lm_head.weight": _w(rng, V, H)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": np.ones(H, np.float32),
                   p + "post_attention_layernorm.weight": np.ones(H, np.float32),
                   p + "self_attn.q_proj.weight": _w(rng, H, H),
                   p + "self_attn.k_proj.weight": _w(rng, H // 2, H),
                   p + "self_attn.v_proj.weight": _w(rng, H // 2, H),
                   p + "self_attn.o_proj.weight": _w(rng, H, H),
                   p + "block_sparse_moe.gate.weight": _w(rng, E, H) * 20})
        for j in range(E):
            q = p + f"block_sparse_moe.experts.{j}."
            sd.update({q + "w1.weight": _w(rng, I, H), q + "w2.weight": _w(rng, H, I),
                       q + "w3.weight": _w(rng, I, H)})
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))
    cfg = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
           "vocab_size": V, "hidden_size": H, "intermediate_size": I,
           "num_hidden_layers": L, "num_attention_heads": 4, "num_key_value_heads": 2,
           "max_position_embeddings": 2048, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
           "eos_token_id": 5, "num_local_experts": E, "num_experts_per_tok": 2}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)


def write_qwen2_ckpt(d):
    """The Llama checkpoint as a Qwen2ForCausalLM (qkv biases)."""
    write_llama_ckpt(d)
    path = os.path.join(d, "model.safetensors")
    sd = load_file(path)
    rng = np.random.default_rng(5)
    for i in range(L):
        for name, n in (("q_proj", H), ("k_proj", H // 2), ("v_proj", H // 2)):
            sd[f"model.layers.{i}.self_attn.{name}.bias"] = _w(rng, n) * 2
    save_file(sd, path)
    with open(os.path.join(d, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(architectures=["Qwen2ForCausalLM"], model_type="qwen2")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)


def write_medusa_ckpt(d):
    rng = np.random.default_rng(6)
    sd = {}
    for i in range(NUM_HEADS):
        sd[f"medusa_head.{i}.0.linear.weight"] = _w(rng, H, H)
        sd[f"medusa_head.{i}.0.linear.bias"] = _w(rng, H)
    os.makedirs(d, exist_ok=True)
    save_file(sd, os.path.join(d, "model.safetensors"))


TARGETS = {"llama": write_llama_ckpt, "qwen2": write_qwen2_ckpt,
           "mixtral": write_mixtral_ckpt, "llava-1.5": lambda d: write_llava_ckpt(d, False),
           "llava-next": lambda d: write_llava_ckpt(d, True), "qwen2.5-vl": write_qwen_vl_ckpt}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Every target, the ViSpec drafts (plain and with qkv bias) and Medusa
    heads, written once."""
    root = tmp_path_factory.mktemp("ckpts")
    dirs = {}
    for name, write in TARGETS.items():
        dirs[name] = str(root / name)
        write(dirs[name])
    for name, write in (("draft", write_draft_ckpt), ("vdraft", write_vision_draft_ckpt),
                        ("vdraft_bias", lambda d: write_vision_draft_ckpt(d, qkv_bias=True)),
                        ("medusa", write_medusa_ckpt)):
        dirs[name] = str(root / name)
        write(dirs[name])
    return dirs


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def assert_same_params(got: dict, jtree: dict, what: str):
    """The port's parameters equal the JAX tree handed over by from_numpy,
    bit for bit and dtype for dtype."""
    want = dict(_leaves(from_numpy(to_numpy_tree(jtree), CPU)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (QTensor, Q4Tensor)):
            for a, b in zip(g, w):
                assert torch.equal(a, b), (what, k)
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        assert torch.equal(g, w), (what, k)


# ---------------------------------------------------------------------------
# The safetensors reader and writer
# ---------------------------------------------------------------------------


@in_fresh_interpreter
def test_reader_matches_the_safetensors_package(tmp_path):
    """F32, F16, I64, I32, U8 and BOOL through safetensors.numpy and BF16
    through safetensors.torch: equal values, shapes and dtypes; the
    ``__metadata__`` entry is skipped."""
    from safetensors.torch import load_file as tload
    from safetensors.torch import save_file as tsave

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-2**40, 2**40, (2, 2, 3)),
              "i32": rng.integers(-9, 9, (4,)).astype(np.int32),
              "u8": rng.integers(0, 255, (5, 1)).astype(np.uint8),
              "flag": rng.uniform(size=(6,)) < 0.5,
              "empty": np.zeros((0, 3), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = thf.load_state_dict(str(tmp_path / "a.safetensors"))
    ref = load_file(str(tmp_path / "a.safetensors"))
    assert sorted(got) == sorted(ref)
    for k, a in ref.items():
        assert got[k].numpy().dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    bf = {"bf16": torch.randn(4, 9, generator=torch.Generator().manual_seed(1)).bfloat16()}
    tsave(bf, str(tmp_path / "b.safetensors"))
    got = thf.load_state_dict(str(tmp_path / "b.safetensors"))["bf16"]
    want = tload(str(tmp_path / "b.safetensors"))["bf16"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@in_fresh_interpreter
def test_writer_is_read_by_the_safetensors_package(tmp_path):
    from safetensors.torch import load_file as tload

    g = torch.Generator().manual_seed(2)
    tensors = {"w": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g).bfloat16(),
               "h": torch.randn(2, 2, generator=g).half(), "i": torch.arange(6).reshape(2, 3),
               "m": torch.tensor([True, False, True]), "t": torch.randn(4, 3, generator=g).T}
    path = str(tmp_path / "w.safetensors")
    texport.write_safetensors(tensors, path)
    back = tload(path)
    assert sorted(back) == sorted(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
    ours = thf.load_state_dict(path)
    for k, t in tensors.items():
        assert torch.equal(ours[k], t), k


@in_fresh_interpreter
def test_sharded_safetensors_and_torch_bin_checkpoints(ckpts, tmp_path):
    """model.safetensors.index.json shards, pytorch_model.bin and its index:
    the same tensors as the single safetensors file (the JAX loader's order
    and formats)."""
    src = load_file(os.path.join(ckpts["llama"], "model.safetensors"))
    keys = sorted(src)
    half = {k: src[k] for k in keys[: len(keys) // 2]}, {k: src[k] for k in keys[len(keys) // 2:]}
    for kind in ("safetensors", "bin"):
        d = tmp_path / kind
        d.mkdir()
        weight_map = {}
        for i, part in enumerate(half):
            name = (f"model-{i + 1:05d}-of-00002.safetensors" if kind == "safetensors"
                    else f"pytorch_model-{i + 1:05d}-of-00002.bin")
            if kind == "safetensors":
                save_file(part, str(d / name))
            else:
                torch.save({k: torch.from_numpy(v) for k, v in part.items()}, str(d / name))
            weight_map.update({k: name for k in part})
        index = "model.safetensors.index.json" if kind == "safetensors" \
            else "pytorch_model.bin.index.json"
        (d / index).write_text(json.dumps({"weight_map": weight_map}))
        got = thf.load_state_dict(str(d))
        assert sorted(got) == keys
        for k in keys:
            np.testing.assert_array_equal(got[k].numpy(), src[k], err_msg=(kind, k))
    single = tmp_path / "single"
    single.mkdir()
    torch.save({k: torch.from_numpy(v).bfloat16() for k, v in src.items()},
               str(single / "pytorch_model.bin"))
    got = thf.load_state_dict(str(single))
    for k in keys:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], torch.from_numpy(src[k]).bfloat16()), k
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict(str(tmp_path))


# ---------------------------------------------------------------------------
# from_pretrained against the JAX package
# ---------------------------------------------------------------------------


def _vision_ids(model, qwen):
    n = model.count_image_tokens((56, 56) if qwen else (40, 40))
    start = [VISION_START] if qwen else []
    return np.asarray(list(range(10, 22)) + start + [IMAGE_TOKEN] * n + list(range(30, 48)),
                      np.int64)


CASES = [("llama", "draft", "vispec"), ("llama", "draft", "eagle"),
         ("llama", "medusa", "medusa"), ("llama", None, "vispec"),
         ("qwen2", "draft", "vispec"), ("mixtral", "draft", "vispec"),
         ("llava-1.5", "vdraft", "vispec"), ("llava-next", "vdraft", "vispec"),
         ("qwen2.5-vl", "vdraft_bias", "vispec")]


@in_fresh_interpreter
@pytest.mark.parametrize("target,draft,method", CASES,
                         ids=[f"{t}-{d or 'no_draft'}-{m}" for t, d, m in CASES])
def test_from_pretrained_matches_jax(ckpts, target, draft, method):
    kw = dict(LOAD, method=method)
    if target == "qwen2.5-vl":
        kw["min_pixels"] = 56 * 56
    dpath = ckpts[draft] if draft else None
    jm = JSpecModel.from_pretrained(ckpts[target], dpath, dtype=jnp.float32, **kw)
    tm = TSpecModel.from_pretrained(ckpts[target], dpath, dtype=torch.float32, device=CPU,
                                    **kw)
    assert tm.tcfg == type(tm.tcfg)(**jm.tcfg.__dict__)
    assert tm.dcfg == type(tm.dcfg)(**jm.dcfg.__dict__)
    assert tm.eos_token_id == jm.eos_token_id
    assert tm.image_token_index == jm.image_token_index
    assert_same_params(tm.tparams, jm.tparams, "target")
    assert_same_params(tm.dparams, jm.dparams, "draft")
    for name in ("vparams", "mparams"):
        if getattr(jm, name) is None:
            assert getattr(tm, name) is None, name
        else:
            assert_same_params(getattr(tm, name), getattr(jm, name), name)
    if target.startswith("llava"):
        assert tm.llava_cfg.anyres == jm.llava_cfg.anyres
        assert tm.llava_cfg.image_grid_pinpoints == jm.llava_cfg.image_grid_pinpoints
        assert tm.tcfg.max_position_embeddings == 8192
    if target == "qwen2.5-vl":
        assert tm.qwen_cfg == type(tm.qwen_cfg)(**jm.qwen_cfg.__dict__)
        assert (tm.video_token_index, tm.vision_start_token_id) == \
            (jm.video_token_index, jm.vision_start_token_id)
    if draft is None:
        got = tm.ar_generate(PROMPT, max_new_tokens=NEW).sequences
        np.testing.assert_array_equal(got, jm.ar_generate(PROMPT, max_new_tokens=NEW).sequences)
        return
    got = tm.specgenerate(PROMPT, max_new_tokens=NEW).sequences
    np.testing.assert_array_equal(got, jm.specgenerate(PROMPT, max_new_tokens=NEW).sequences)
    if target in ("llava-next", "qwen2.5-vl"):  # an image prompt: spec == AR
        qwen = target == "qwen2.5-vl"
        ids = _vision_ids(tm, qwen)
        size = (56, 56) if qwen else (40, 40)
        img = np.random.default_rng(1).uniform(0, 1, (*size, 3)).astype(np.float32)
        spec = tm.specgenerate(ids, max_new_tokens=NEW, pixel_values=img, image_size=size)
        ar = tm.ar_generate(ids, max_new_tokens=NEW, pixel_values=img, image_size=size)
        n = len(ids) + NEW
        np.testing.assert_array_equal(spec.sequences[:n], ar.sequences[:n])


@in_fresh_interpreter
def test_bf16_load_equals_jax_bf16_load(ckpts):
    """float32 checkpoint values rounded to bf16 on load as JAX rounds them;
    norms stay float32."""
    jm = JSpecModel.from_pretrained(ckpts["mixtral"], ckpts["draft"], dtype=jnp.bfloat16,
                                    **LOAD)
    tm = TSpecModel.from_pretrained(ckpts["mixtral"], ckpts["draft"], dtype=torch.bfloat16,
                                    device=CPU, **LOAD)
    assert_same_params(tm.tparams, jm.tparams, "target")
    assert_same_params(tm.dparams, jm.dparams, "draft")
    assert tm.tparams["final_norm"].dtype == torch.float32


@in_fresh_interpreter
def test_draft_without_embed_falls_back_to_the_target(ckpts, tmp_path):
    d = str(tmp_path / "draft")
    os.makedirs(d)
    sd = load_file(os.path.join(ckpts["draft"], "model.safetensors"))
    del sd["embed_tokens.weight"]
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(ckpts["draft"], "config.json")) as f:
        cfg = f.read()
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg)
    tm = TSpecModel.from_pretrained(ckpts["llama"], d, dtype=torch.float32, device=CPU, **LOAD)
    assert torch.equal(tm.dparams["embed"], tm.tparams["embed"])
    with pytest.raises(KeyError):
        thf.convert_draft(thf.load_state_dict(d), tm.dcfg, torch.float32, device=CPU)


@in_fresh_interpreter
def test_total_token_minus_one_autotunes(ckpts):
    tm = TSpecModel.from_pretrained(ckpts["llama"], ckpts["draft"], dtype=torch.float32,
                                    device=CPU, **dict(LOAD, total_token=-1, top_k=8))
    assert tm.spec.total_tokens in (40, 48, 50, 56, 60)
    assert set(tm.last_autotune_s) == {40, 48, 50, 56, 60}
    assert tm.specgenerate(PROMPT, max_new_tokens=8).new_tokens >= 4


@in_fresh_interpreter
def test_quantize_flags_and_the_mesh_refusal(ckpts):
    tm = TSpecModel.from_pretrained(ckpts["mixtral"], ckpts["draft"], dtype=torch.float32,
                                    device=CPU, quantize_draft="int4", quantize_kv=True, **LOAD)
    assert isinstance(tm.dparams["layer"]["wq"], Q4Tensor) and tm.quantize_kv
    spec = tm.specgenerate(PROMPT, max_new_tokens=NEW).sequences
    ar = tm.ar_generate(PROMPT, max_new_tokens=NEW).sequences
    np.testing.assert_array_equal(spec[:len(PROMPT) + NEW], ar[:len(PROMPT) + NEW])
    # a mesh is no longer refused (multi-device inference against JAX:
    # tests/test_torch_parallel.py): a one-rank mesh loads the unsharded
    # model's tokens, and quantizing after sharding is refused
    from vispec_tpu_torch.parallel.mesh import AXES, Mesh

    one = Mesh({a: 1 for a in AXES}, 0, {a: 0 for a in AXES}, {a: None for a in AXES},
               {a: [0] for a in AXES}, CPU, "gloo", False)
    sm = TSpecModel.from_pretrained(ckpts["llama"], ckpts["draft"], dtype=torch.float32,
                                    device=CPU, mesh=one, **LOAD)
    ref = TSpecModel.from_pretrained(ckpts["llama"], ckpts["draft"], dtype=torch.float32,
                                     device=CPU, **LOAD)
    np.testing.assert_array_equal(sm.specgenerate(PROMPT, max_new_tokens=NEW).sequences,
                                  ref.specgenerate(PROMPT, max_new_tokens=NEW).sequences)
    with pytest.raises(ValueError, match="quantize first"):
        sm.quantize_target_inplace()


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


@in_fresh_interpreter
def test_export_round_trip_matches_jax(ckpts, tmp_path):
    """The port's HF state dict of a draft equals JAX's export of the same
    draft; ``save_draft`` writes files the port and the safetensors package
    read back to the same parameters."""
    jm = JSpecModel.from_pretrained(ckpts["llama"], ckpts["vdraft"], dtype=jnp.float32, **LOAD)
    tm = TSpecModel.from_pretrained(ckpts["llama"], ckpts["vdraft"], dtype=torch.float32,
                                    device=CPU, **LOAD)
    want = jexport.draft_to_hf_state_dict(jm.dparams)
    got = texport.draft_to_hf_state_dict(tm.dparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(t2n(got[k]), w, err_msg=k)
    with open(os.path.join(ckpts["vdraft"], "config.json")) as f:
        cfg = json.load(f)
    out = str(tmp_path / "exported")
    path = texport.save_draft(tm.dparams, out, cfg)
    for k, w in load_file(path).items():
        np.testing.assert_array_equal(w, want[k], err_msg=k)
    again = TSpecModel.from_pretrained(ckpts["llama"], out, dtype=torch.float32, device=CPU,
                                       **LOAD)
    for k, w in _leaves(tm.dparams):
        assert torch.equal(dict(_leaves(again.dparams))[k], w), k
