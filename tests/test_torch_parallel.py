"""Multi-device inference of the port (``vispec_tpu_torch/parallel``) against
the JAX package's single-device tokens, in float32 on the CPU.

The module spawns, once, a JAX reference process and two gloo worlds of the
port (``tests/torch_parallel_world.py``): four ranks run every model case
(tp 2, sp 2, pp 2, pp 2 x tp 2, pp 2 x sp 2, Mixtral at ep 2 and pp 2 x
tp 2, qkv bias, int8 and int4 drafts, an int8 target (also batched),
Medusa, a batch, a LLaVA image request and ``from_pretrained(mesh=)``), and
two ranks run
``gen_answer --tp 2``, ``ge_data --tp 2`` and the ``mesh_from_args``
contract.  The JAX package's own tests prove its meshes equal its single
device, so the JAX side runs unsharded only.  The tests then read the
results; the split tables, ``shard_cache``'s warnings and ``local_shard``'s
arithmetic are checked here against the JAX package's functions.
"""

import json
import os
import pickle
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding

from tests import torch_parallel_world as world
from tests.torch_parity import CPU, once_per_session
from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.ops import quant as jquant
from vispec_tpu.parallel import sharding as jsharding
from vispec_tpu_torch.configs import DraftConfig, LlamaConfig
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.ops import kv_cache as kv
from vispec_tpu_torch.ops import quant as tquant
from vispec_tpu_torch.parallel import mesh as tmesh
from vispec_tpu_torch.parallel import multihost as tmultihost
from vispec_tpu_torch.parallel import sharding as tsharding

pytest.importorskip("safetensors.numpy")

TIMEOUT = 600
MODEL_NAMES = [name for name, _, _ in world.MODEL_CASES]


def _spawn(args, log, env):
    return subprocess.Popen([sys.executable, world.__file__] + args, cwd=world.ROOT,
                            env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Outputs of the JAX reference and of every rank of both worlds, or the
    failure logs of a process that failed; spawned once per test session
    (``once_per_session``), whichever worker asks first."""
    return once_per_session("test_torch_parallel.runs", _spawn_worlds,
                            lambda: tmp_path_factory.mktemp("parallel"))


def _spawn_worlds(tmp):
    from tests.test_from_pretrained import write_draft_ckpt, write_llama_ckpt
    from tests.test_gen_answer_cli import _write_tokenizer
    from tests.vlm_fixtures import IMAGE_TOKEN, write_llava_ckpt, write_vision_draft_ckpt

    vt, vd, pt, pd = (str(tmp / n) for n in ("vt", "vd", "pt", "pd"))
    write_llava_ckpt(vt, anyres=True)
    write_vision_draft_ckpt(vd)
    write_llama_ckpt(pt)
    write_draft_ckpt(pd)
    _write_tokenizer(pt)
    bench = tmp / "data" / "mt_bench"
    bench.mkdir(parents=True)
    (bench / "question.jsonl").write_text(json.dumps(
        {"question_id": 81, "category": "writing",
         "turns": ["write a story about robots", "make it shorter"]}) + "\n")
    conv = {"conversations": [
        {"from": "human", "value": "write a story about robots"},
        {"from": "gpt", "value": "the robots make a story"},
        {"from": "human", "value": "make it shorter"},
        {"from": "gpt", "value": "robots story"}]}
    (tmp / "sharegpt.json").write_text(json.dumps([conv, conv, conv]))
    image = np.random.default_rng(0).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    inputs = {
        "vision": {"target": vt, "draft": vd, "image": image, "image_token": IMAGE_TOKEN},
        "pretrained": {"target": pt, "draft": pd},
        "cli": {"target": pt, "draft": pd, "data_root": str(tmp / "data"),
                "sharegpt": str(tmp / "sharegpt.json"),
                "answers_tp1": str(tmp / "answers_tp1.jsonl"),
                "answers_tp2": str(tmp / "answers_tp2.jsonl"),
                "data_tp1": str(tmp / "data_tp1"), "data_tp2": str(tmp / "data_tp2")},
    }
    inputs_path = str(tmp / "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)

    env = {**os.environ, "PYTHONPATH": world.ROOT, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    jobs = {"jax": (["jax", inputs_path, str(tmp / "jax.pkl")], str(tmp / "jax.pkl"))}
    for name, size, extra in (("model", 4, []), ("cli", 2, ["cli"])):
        for r in range(size):
            out = str(tmp / f"{name}{r}.pkl")
            jobs[f"{name}{r}"] = (["rank", str(r), str(size), str(tmp / f"{name}.init"),
                                   inputs_path, out] + extra, out)
    procs = {}
    for key, (args, _) in jobs.items():
        procs[key] = _spawn(args, open(tmp / f"{key}.log", "w"), env)
    results, failures = {}, {}
    for key, proc in procs.items():
        try:
            proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            proc.wait()
        out = jobs[key][1]
        if proc.returncode == 0 and os.path.exists(out):
            with open(out, "rb") as f:
                results[key] = pickle.load(f)
        else:
            failures[key] = (tmp / f"{key}.log").read_text()[-4000:]
    return results, failures, inputs


def _get(runs, *keys):
    results, failures, _ = runs
    missing = [k for k in keys if k not in results]
    if missing:
        pytest.fail("\n".join(f"{k} failed:\n{failures.get(k, '')}" for k in missing))
    return [results[k] for k in keys]


def _ranks(runs, world_name, size):
    return _get(runs, *(f"{world_name}{r}" for r in range(size)))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_sharded_tokens_equal_jax_single_device(runs, name):
    """Spec and AR tokens of every rank equal the JAX package's single
    device, token for token over the whole budget."""
    (ref,) = _get(runs, "jax")
    j_spec, j_ar = ref[name]
    n = len(world.PROMPT) + world.NEW
    assert len(j_spec) >= n and j_spec[:n] == j_ar[:n]
    (tp, pp, sp), opts = [(m, o) for nm, m, o in world.MODEL_CASES if nm == name][0]
    for r, out in enumerate(_ranks(runs, "model", 4)):
        spec, ar, info = out[name]
        assert spec[:n] == j_spec[:n], f"rank {r} spec"
        assert ar[:n] == j_ar[:n], f"rank {r} AR"
        # the rank really held its shard and went through the collectives
        heads = world.TARGET["num_attention_heads"] // tp * (world.TARGET["hidden_size"]
                                                             // world.TARGET["num_attention_heads"])
        assert info["wq"] == (world.TARGET["num_hidden_layers"] // pp,
                              world.TARGET["hidden_size"], heads)
        assert info["cache_k"][:2] == (world.TARGET["num_hidden_layers"] // pp,
                                       world.TARGET["num_key_value_heads"] // tp)
        assert info["embed"][0] == world.TARGET["vocab_size"] // tp
        assert sum(info["collectives"].values()) > 0
        if opts.get("mixtral"):
            assert info["we_down"][1] == world.EXPERTS["num_local_experts"] // tp
        assert info["int8_target"] == bool(opts.get("quantize_target"))
        assert all(info.get("batch_equal", [True])), info.get("batch_equal")


def test_shard_over_keeps_caches_lazy_and_the_embed_alias(runs):
    """shard_over allocates no cache (the first touch does, at the rank's
    size) and the draft keeps sharing the target's sharded embed."""
    for out in _ranks(runs, "model", 4):
        for name in MODEL_NAMES:
            info = out[name][2]
            assert info["lazy_after_shard"], name
            assert info["embed_alias"], name


def test_batched_tp_equals_jax_unsharded(runs):
    """generate_batch over rank-local parameters (the JAX package's
    test_batched_tp_matches_unsharded) equals JAX's unsharded batch."""
    (ref,) = _get(runs, "jax")
    for out in _ranks(runs, "model", 4):
        for got, want in zip(out["batch_tp2"], ref["batch_tp2"]):
            assert len(want) >= world.NEW
            assert got[:world.NEW] == want[:world.NEW]


@pytest.mark.parametrize("name", ["vision_tp2", "from_pretrained_tp2"])
def test_from_pretrained_mesh_equals_jax(runs, name):
    """from_pretrained(mesh=) at tp 2 (a LLaVA-1.6 checkpoint with an image
    request, and a text checkpoint) gives JAX's unsharded tokens."""
    (ref,) = _get(runs, "jax")
    j_spec, j_ar = ref[name]
    prompt = len(ref["vision_ids"]) if name == "vision_tp2" else 30
    for out in _ranks(runs, "model", 4):
        spec, ar, info = out[name]
        if name == "vision_tp2":
            assert out["vision_ids"] == ref["vision_ids"]
        n = min(len(j_spec), len(spec), len(j_ar), len(ar))
        assert n >= prompt + 5
        assert spec[:n] == j_spec[:n] and ar[:n] == j_ar[:n]
        assert info["embed"][0] * 2 == info["lm_head"][1] * 2 == 160


def test_gen_answer_tp2_writes_the_tp1_answers(runs):
    _ranks(runs, "cli", 2)
    c = runs[2]["cli"]

    def records(path):
        return [json.loads(line) for line in open(path) if line.strip()]

    one, two = records(c["answers_tp1"]), records(c["answers_tp2"])
    assert len(one) == len(two) == 1
    assert one[0]["turns"] == two[0]["turns"]
    assert one[0]["new_tokens"] == two[0]["new_tokens"]


def test_ge_data_tp2_writes_the_tp1_data(runs):
    """ids and loss masks equal; bfloat16 hiddens within 2 bf16 ulps of the
    unsharded run's (the tp sum is taken in another order)."""
    _ranks(runs, "cli", 2)
    c = runs[2]["cli"]
    files = sorted(f for f in os.listdir(c["data_tp1"]) if f.endswith(".npz"))
    assert len(files) == 2 and files == sorted(os.listdir(c["data_tp2"]))
    for f in files:
        a, b = np.load(os.path.join(c["data_tp1"], f)), np.load(os.path.join(c["data_tp2"], f))
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_array_equal(a["loss_mask"], b["loss_mask"])
        ah, bh = a["hidden_state"], b["hidden_state"]
        np.testing.assert_allclose(ah, bh, rtol=2 ** -7, atol=2 ** -7)


def test_mesh_from_args_contract(runs):
    """None when every axis is 1, JAX's ValueErrors for --dp / --sp, and a
    tp 2 mesh over gloo in a world of two."""
    for out in _ranks(runs, "cli", 2):
        assert out["mesh_from_args_none"]
        assert "--dp" in out["mesh_from_args_errors"][0]
        assert "--sp" in out["mesh_from_args_errors"][1]
        assert out["mesh_from_args_shape"] == {"dp": 1, "pp": 1, "sp": 1, "tp": 2}
        assert "over gloo on cpu" in out["mesh_from_args_backend"]
    with pytest.raises(ValueError, match="--dp"):
        tmesh.mesh_from_args(dp=2, bs=3)
    with pytest.raises(ValueError, match="--sp"):
        tmesh.mesh_from_args(sp=2, max_len=65)
    assert tmesh.mesh_from_args() is None


@pytest.mark.parametrize("size", [2, 4])
def test_local_shard_has_the_jax_arithmetic(runs, size):
    import vispec_tpu.parallel.multihost as jmh

    outs = _ranks(runs, "cli" if size == 2 else "model", size)
    real = jmh.jax
    try:
        for r, out in enumerate(outs):
            class _Fake:
                process_count = staticmethod(lambda: size)
                process_index = staticmethod(lambda r=r: r)

            jmh.jax = _Fake()
            assert out["local_shard"] == list(jmh.local_shard(10))
    finally:
        jmh.jax = real


def test_init_distributed_single_process():
    """Without a launcher's variables: a no-op that returns 0, and the
    eval shard covers everything."""
    assert tmultihost.init_distributed() == 0
    assert list(tmultihost.local_shard(7)) == list(range(7))


# ---------------------------------------------------------------------------
# Split tables against the JAX package's PartitionSpecs, leaf by leaf
# ---------------------------------------------------------------------------


def _jax_mesh(pp: int, tp: int) -> JMesh:
    return JMesh(np.asarray(jax.devices()[:pp * tp]).reshape(1, pp, 1, tp),
                 ("dp", "pp", "sp", "tp"))


def _blocks_equal(jx, jspec, tx, tspec, jm: JMesh, key: str):
    """Every device's block of the JAX leaf under its spec equals the port's
    local part of the port leaf (Mixtral's gate / up in the port layout)."""
    shape = dict(jm.shape)
    for dev, index in NamedSharding(jm, jspec).devices_indices_map(jx.shape).items():
        pos = np.argwhere(jm.devices == dev)[0]
        coords = dict(zip(jm.axis_names, (int(p) for p in pos)))
        want = np.asarray(jx)[index]
        if key in ("we_gate", "we_up"):
            want = want.transpose(0, 2, 1, 3).reshape(want.shape[0], want.shape[2], -1)
        got = tsharding.local_part(tx, tspec, shape, coords).numpy()
        np.testing.assert_array_equal(got, want, err_msg=key)


def _walk(jtree, jspecs, ttree, tspecs, jm, key="", count=None):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree) == set(jspecs) == set(tspecs), key
        for k in jtree:
            _walk(jtree[k], jspecs[k], ttree[k], tspecs[k], jm, k, count)
        return
    if isinstance(jtree, tuple) and hasattr(jtree, "_fields"):  # a JAX QTensor / Q4Tensor
        for f in jtree._fields:
            _walk(getattr(jtree, f), getattr(jspecs, f), getattr(ttree, f),
                  getattr(tspecs, f), jm, f"{key}.{f}", count)
        return
    _blocks_equal(jtree, jspecs, ttree, tspecs, jm, key)
    count.append(key)


def _to_jax_quant(x):
    """A port quantized leaf as the JAX package's container of numpy arrays
    (the quantizers are bit-identical)."""
    if isinstance(x, tquant.QTensor):
        return jquant.QTensor(q=x.q.numpy(), s=x.s.numpy())
    if isinstance(x, tquant.Q4Tensor):
        return jquant.Q4Tensor(packed=x.packed.numpy(), s=x.s.numpy())
    if isinstance(x, dict):
        return {k: _to_jax_quant(v) for k, v in x.items()}
    return x.numpy()


def _table_case(name):
    """(JAX tree, JAX specs, port tree, port specs, (pp, tp))."""
    t = world.target_tree(0, bias="bias" in name, mixtral="mixtral" in name)
    jt_cfg = JLlamaConfig(**world.TARGET, qkv_bias="bias" in name)
    tt_cfg = LlamaConfig(**world.TARGET, qkv_bias="bias" in name)
    if name in ("llama", "llama_bias", "llama_pp", "mixtral", "mixtral_pp"):
        pp = "pp" in name
        if "mixtral" in name:
            jf = jsharding.mixtral_param_specs_pp if pp else jsharding.mixtral_param_specs
            tf = tsharding.mixtral_param_specs_pp if pp else tsharding.mixtral_param_specs
        else:
            jf = jsharding.llama_param_specs_pp if pp else jsharding.llama_param_specs
            tf = tsharding.llama_param_specs_pp if pp else tsharding.llama_param_specs
        return t, jf(jt_cfg), from_numpy(t, CPU), tf(tt_cfg), (2 if pp else 1, 2)
    if name == "target_int8":
        tt = from_numpy(t, CPU)
        tquant.quantize_target_params(tt, inplace=True)
        jt = _to_jax_quant(tt)
        return (jt, jsharding.quantize_aware_specs(jsharding.llama_param_specs(jt_cfg), jt),
                tt, tsharding.quantize_aware_specs(tsharding.llama_param_specs(tt_cfg), tt),
                (2, 2))
    bias, vision = "bias" in name, "text_only" not in name
    jd_cfg = JDraftConfig(**world.DRAFT, qkv_bias=bias, vision=vision)
    td_cfg = DraftConfig(**world.DRAFT, qkv_bias=bias, vision=vision)
    d = world.draft_tree(1, bias=bias, vision=vision)
    td = from_numpy(d, CPU)
    if name in ("draft", "draft_bias"):
        return d, jsharding.draft_param_specs(jd_cfg), td, tsharding.draft_param_specs(td_cfg), \
            (1, 2)
    mode = {"draft_int8": "int8", "draft_int4": "int4", "text_only_draft": "int8"}[name]
    tq = tquant.quantize_draft_params(td, from_numpy(t, CPU)["lm_head"], mode=mode)
    tq = {k: v for k, v in tq.items()}
    jq = _to_jax_quant(tq)
    return (jq, jsharding.quantized_draft_specs(jd_cfg, jq), tq,
            tsharding.quantized_draft_specs(td_cfg, tq), (1, 2))


TABLES = ["llama", "llama_bias", "llama_pp", "mixtral", "mixtral_pp", "target_int8", "draft",
          "draft_bias", "draft_int8", "draft_int4", "text_only_draft"]


@pytest.mark.parametrize("name", TABLES)
def test_split_table_matches_jax_partition_specs(name):
    """Each rank's block of every leaf under the port's table equals the
    block JAX's PartitionSpec gives the device at the same coordinates (a
    text-only draft's table pairs with its tree, as in the JAX package)."""
    jt, js, tt, ts, (pp, tp) = _table_case(name)
    seen = []
    _walk(jt, js, tt, ts, _jax_mesh(pp, tp), count=seen)
    assert seen


def test_kv_cache_split_table_matches_jax():
    cache = kv.init_cache(2, 2, 64, 16, torch.float32, CPU, quantized=True)
    for buf in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        buf.copy_(torch.randn(buf.shape).to(buf.dtype) if buf.is_floating_point()
                  else torch.randint(-100, 100, buf.shape, dtype=buf.dtype))
    jm = _jax_mesh(2, 2)
    js = jsharding.kv_cache_specs(pp=True, quantized=True)
    ts = tsharding.kv_cache_specs(pp=True, quantized=True)
    for f in ("k", "v", "k_scale", "v_scale"):
        _blocks_equal(getattr(cache, f).numpy(), getattr(js, f), getattr(cache, f),
                      getattr(ts, f), jm, f)


def _fake_mesh(tp=1, pp=1) -> tmesh.Mesh:
    """Rank 0 of a tp x pp mesh, for placement only (no process group)."""
    shape = {"dp": 1, "pp": pp, "sp": 1, "tp": tp}
    return tmesh.Mesh(shape, 0, {a: 0 for a in tmesh.AXES}, {a: None for a in tmesh.AXES},
                      {a: [0] for a in tmesh.AXES}, CPU, "gloo", False)


@pytest.mark.parametrize("axis", ["tp", "pp"])
def test_shard_cache_warns_like_jax(axis):
    """A multi-head (multi-layer) cache that does not divide tp (pp) is
    replicated with JAX's warning; a one-head (one-layer) draft cache stays
    quiet; a dividing cache is cut."""
    if axis == "tp":
        mesh, bad, quiet, kw = _fake_mesh(tp=2), (2, 3), (1, 1), {}
    else:
        mesh, bad, quiet, kw = _fake_mesh(pp=2), (3, 2), (1, 2), {"pp": True}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = tsharding.shard_cache(mesh, kv.init_cache(*bad, 64, 16, torch.float32, CPU),
                                    **kw)
    assert any(f"does not divide {axis}" in str(x.message) for x in w)
    assert tuple(out.k.shape[:2]) == bad
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tsharding.shard_cache(mesh, kv.init_cache(*quiet, 64, 16, torch.float32, CPU), **kw)
    assert not w
    cut = tsharding.shard_cache(mesh, kv.init_cache(2, 2, 64, 16, torch.float32, CPU), **kw)
    assert tuple(cut.k.shape[:2]) == ((1, 2) if axis == "pp" else (2, 1))


def test_make_mesh_defaults_to_the_gpu():
    import inspect

    assert inspect.signature(tmesh.make_mesh).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh(tp=2)


def test_profiling_helpers_on_the_cpu(tmp_path):
    """utils/profiling: the timer times its block (no device to synchronize
    on the CPU), the trace writes a Chrome trace of the ops it saw, and
    the memory statistics are empty without CUDA."""
    from vispec_tpu_torch.utils import profiling

    with profiling.Timer("matmul", silent=True) as t:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert t.elapsed > 0
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones((8, 8)).sum()
    assert any("aten::sum" in e.key for e in prof.key_averages())
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert profiling.device_memory_stats("cpu") == {}
