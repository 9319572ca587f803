"""Parallel draft training, the sharded checkpoint backend and the engine on a
sharded model (``vispec_tpu_torch``: ``train(mesh=)``, the training CLIs'
mesh flags, ``ckpt_backend="orbax"``, ``SpecModel.serving_engine`` after
``shard_over``) against the JAX package's single device and the port's one
process, in float32 on the CPU.

The module spawns, once, a JAX reference process (the unsharded training
step and the JAX engine; the JAX package's own tests prove its meshes equal
its single device) and two gloo worlds of the port
(``tests/torch_parallel_world.py``): four ranks run the dp 2 x sp 2 step
with an image span across the sp boundary, the dp 2 x tp 2 ``train()``
loop with both checkpoint backends, a tp 2 orbax save of a quantized
draft, the stage-1 CLI at ``--dp 2 --sp 2`` and the engine at tp 2; two
ranks run the Medusa CLI at ``--dp 2``.  While they run, this process makes
the port's one-process references.  The tests then read the results.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_parallel_world as world
from tests.torch_parity import CPU, once_per_session
from vispec_tpu_torch.configs import DraftConfig
from vispec_tpu_torch.train import data_gen, trainer
from vispec_tpu_torch.train.step import leaves

pytest.importorskip("safetensors.numpy")

TIMEOUT = 600
CLI = ["--bs", "2", "--max-len", "64", "--num-epochs", "1", "--device", "cpu"]


def _samples(path, hidden, vocab, n, seed):
    """``n`` stage-2 samples of 40 rows (an image span at rows 10-19 in every
    other one), hiddens ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        s = 40
        mask = np.zeros(s, np.float32)
        mask[6:] = 1
        image = np.zeros(s, bool)
        if i % 2 == 0:
            image[10:20] = True
        data_gen.save_sample(path, i, {
            "input_ids": rng.integers(0, vocab, s).astype(np.int32),
            "hidden_state": rng.normal(0, 1, (s, hidden)).astype(np.float32),
            "inputs_embeds": rng.normal(0, 1, (s, hidden)).astype(np.float32),
            "loss_mask": mask, "image_mask": image})


def _cli_main(module, argv):
    sys.argv = argv
    module.main()


def _references(tmp, inputs) -> dict:
    """The port's one-process runs of every world case."""
    from vispec_tpu_torch.train import main as stage1_cli
    from vispec_tpu_torch.train import main_medusa, main_mtp

    refs = {}
    c, cli = inputs["train"], inputs["cli"]
    dcfg, head = DraftConfig(**world.LOOP_DRAFT), torch.from_numpy(world.loop_head())
    refs["loop_pickle"] = trainer.train(c["data"], str(tmp / "one_pickle"), dcfg, head,
                                        trainer.TrainConfig(**world.LOOP_CFG), log_every=1)
    refs["loop_orbax"] = [trainer.train(
        c["data"], str(tmp / "one_orbax"), dcfg, head,
        trainer.TrainConfig(**dict(world.LOOP_CFG, num_epochs=e, ckpt_backend="orbax")),
        log_every=1) for e in (1, 2)]
    base = ["--basepath", cli["target"], "--tmpdir", cli["data"]] + CLI
    _cli_main(stage1_cli, ["main", "--configpath", cli["draft_cfg"], "--cpdir",
                           str(tmp / "one_stage1")] + base)
    _cli_main(main_medusa, ["main_medusa", "--cpdir", str(tmp / "one_medusa")] + base)
    # stage 1 with the orbax backend, then stage 2 warm-started from its params
    _cli_main(stage1_cli, ["main", "--configpath", cli["draft_cfg"], "--cpdir",
                           str(tmp / "stage1_orbax"), "--ckpt-backend", "orbax"] + base)
    _cli_main(main_mtp, ["main_mtp", "--configpath", cli["draft_cfg"], "--cpdir",
                         str(tmp / "warm"), "--mtp-steps", "1", "--loadpath",
                         str(tmp / "stage1_orbax" / "state_0.orbax")] + base)
    refs["engine"] = {name: world.engine_tokens(world.engine_model(True, opts))
                      for name, opts in world.ENGINE_MODES.items()}
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(results by process, failure logs, the one-process references, the
    inputs, the tmp dir); made once per test session (``once_per_session``),
    whichever worker asks first."""
    return once_per_session("test_torch_parallel_train.runs", _spawn_worlds,
                            lambda: tmp_path_factory.mktemp("parallel_train"))


def _spawn_worlds(tmp):
    from tests.test_from_pretrained import H, V, write_llama_ckpt

    _samples(str(tmp / "loop_data"), world.LOOP_DRAFT["hidden_size"],
             world.LOOP_DRAFT["vocab_size"], 4, seed=0)
    _samples(str(tmp / "cli_data"), H, V, 4, seed=1)
    write_llama_ckpt(str(tmp / "target"))
    with open(tmp / "draft.json", "w") as f:
        json.dump(dict(vocab_size=V, hidden_size=H, intermediate_size=96,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=256), f)
    inputs = {
        "train": {"data": str(tmp / "loop_data"), "world_pickle": str(tmp / "world_pickle"),
                  "world_orbax": str(tmp / "world_orbax"),
                  "world_quant": str(tmp / "world_quant")},
        "cli": {"target": str(tmp / "target"), "draft_cfg": str(tmp / "draft.json"),
                "data": str(tmp / "cli_data"), "world_stage1": str(tmp / "world_stage1"),
                "world_medusa": str(tmp / "world_medusa")},
    }
    inputs_path = str(tmp / "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)

    env = {**os.environ, "PYTHONPATH": world.ROOT, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    jobs = {"jax": (["jax-train", inputs_path, str(tmp / "jax.pkl")], str(tmp / "jax.pkl"))}
    for name, size in (("train", 4), ("medusa", 2)):
        for r in range(size):
            out = str(tmp / f"{name}{r}.pkl")
            jobs[f"{name}{r}"] = (["rank", str(r), str(size), str(tmp / f"{name}.init"),
                                   inputs_path, out, name], out)
    procs = {key: subprocess.Popen([sys.executable, world.__file__] + args, cwd=world.ROOT,
                                   env=env, stdout=open(tmp / f"{key}.log", "w"),
                                   stderr=subprocess.STDOUT)
             for key, (args, _) in jobs.items()}
    try:
        refs = _references(tmp, inputs)
    finally:
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
    return results, failures, refs, inputs, tmp


def _get(runs, *keys):
    results, failures = runs[0], runs[1]
    missing = [k for k in keys if k not in results]
    if missing:
        pytest.fail("\n".join(f"{k} failed:\n{failures.get(k, '')}" for k in missing))
    return [results[k] for k in keys]


def _ranks(runs, name, size):
    return _get(runs, *(f"{name}{r}" for r in range(size)))


def _flat(tree, prefix=""):
    """path -> numpy array of a nested dict (numpy or tensor leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out


def _assert_trees_close(got, want, rtol, atol=0.0, what=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(set(g) ^ set(w)))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def _assert_trees_equal(got, want, what=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(set(g) ^ set(w)))
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {k}")


def _losses(cpdir):
    with open(os.path.join(cpdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r["loss"] for r in recs if "loss" in r], [r["getkacc"] for r in recs
                                                      if "getkacc" in r]


def test_shard_train_batch_matches_jax_shardings():
    """Each rank's part of a batch equals the block JAX's
    ``shard_train_batch`` shardings give the device at the same dp x sp
    coordinates (dense leaves P("dp", "sp", ...), plans P("dp", ...))."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train.step import TrainBatch

    x = world.step_inputs()
    s = x["hidden_states"].shape[1]
    plan, _ = draft_mod.make_prefill_plan(x["image_mask"], s, 2, s, max_images=1,
                                          max_span=8, device="cpu")
    plans = draft_mod.PrefillPlan(*(torch.stack([f, f + 1]) for f in plan))
    batch = TrainBatch(*(torch.from_numpy(x[k]) for k in ("hidden_states", "embeds",
                                                          "target", "loss_mask")), plans)
    jm = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 2, 1), ("dp", "pp", "sp", "tp"))
    for dev, pos in zip(jm.devices.reshape(-1), np.ndindex(*jm.devices.shape)):
        coords = dict(zip(jm.axis_names, pos))
        mesh = meshmod.Mesh(dict(jm.shape), 0, coords, {a: None for a in meshmod.AXES},
                            {a: [0] for a in meshmod.AXES}, CPU, "gloo", False)
        part = sharding.shard_train_batch(mesh, batch)
        for name, spec in (("hidden_states", JP("dp", "sp", None)),
                           ("loss_mask", JP("dp", "sp"))):
            full = getattr(batch, name).numpy()
            index = NamedSharding(jm, spec).devices_indices_map(full.shape)[dev]
            np.testing.assert_array_equal(getattr(part, name).numpy(), full[index])
        for got, full in zip(part.plans, batch.plans):
            spec = JP("dp", *(None,) * (full.dim() - 1))
            index = NamedSharding(jm, spec).devices_indices_map(tuple(full.shape))[dev]
            np.testing.assert_array_equal(got.numpy(), full.numpy()[index])


def test_dp2_sp2_step_matches_jax_unsharded(runs):
    """Two dp 2 x sp 2 steps with the image span (rows 4-9) across the sp
    boundary at row 8: every rank's loss equals JAX's unsharded step to
    rtol 1e-5, and every updated leaf and both Adam moments to rtol 1e-4,
    atol 1e-6."""
    (ref,) = _get(runs, "jax")
    image = world.step_inputs()["image_mask"]
    assert image[7] and image[8]  # the span crosses the boundary
    for r, out in enumerate(_ranks(runs, "train", 4)):
        for i, (got, want) in enumerate(zip(out["step_dp2_sp2"], ref["steps"])):
            assert got["local_rows"] == (1, 8, world.STEP_DRAFT["hidden_size"])
            np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5,
                                       err_msg=f"rank {r} step {i}")
            assert got["collectives"]["all_gather"] > 0 and got["collectives"]["all_reduce"] > 0
            for part in ("params", "mu", "nu"):
                _assert_trees_close(got[part], want[part], rtol=1e-4, atol=1e-6,
                                    what=f"rank {r} step {i} {part}")


def test_dp2_tp2_train_loop_equals_one_process(runs):
    """train(mesh=) at dp 2 x tp 2: rank 0's metrics.jsonl losses and every
    rank's returned whole params equal the one-process train() to rtol
    1e-4 (getkacc equal); the pickle it wrote round-trips to those params
    bit for bit."""
    refs, inputs = runs[2], runs[3]
    ranks = _ranks(runs, "train", 4)
    assert ranks[0]["mesh_dp2_tp2"].startswith("dp2xpp1xsp1xtp2 over gloo")
    want_losses, want_kacc = _losses(str(runs[4] / "one_pickle"))
    got_losses, got_kacc = _losses(inputs["train"]["world_pickle"])
    assert len(got_losses) == len(want_losses) == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_kacc == want_kacc
    for r, out in enumerate(ranks):
        _assert_trees_close(out["loop_pickle"], refs["loop_pickle"], rtol=1e-4, atol=1e-6,
                            what=f"rank {r}")
    _, saved, opt = trainer.load_state(
        os.path.join(inputs["train"]["world_pickle"], "state_0.pkl"), device=CPU)
    assert opt.count == 2
    _assert_trees_equal(saved, ranks[0]["loop_pickle"], "pickle round trip")


def test_stage1_and_medusa_clis_under_mesh(runs):
    """The stage-1 CLI at --dp 2 --sp 2 and the Medusa CLI at --dp 2 under
    gloo worlds write states equal to their one-process runs (rtol 1e-4),
    finite."""
    _ranks(runs, "train", 4)
    _ranks(runs, "medusa", 2)
    tmp, cli = runs[4], runs[3]["cli"]
    for got_dir, want_dir in ((cli["world_stage1"], tmp / "one_stage1"),
                              (cli["world_medusa"], tmp / "one_medusa")):
        got = trainer.load_state(trainer.latest_state(got_dir), device=CPU)
        want = trainer.load_state(trainer.latest_state(str(want_dir)), device=CPU)
        assert got[0] == want[0] == 0 and got[2].count == want[2].count == 2
        assert all(np.isfinite(v).all() for v in _flat(got[1]).values())
        _assert_trees_close(got[1], want[1], rtol=1e-4, atol=1e-6, what=got_dir)
        _assert_trees_close(got[2].mu, want[2].mu, rtol=1e-4, atol=1e-6, what=got_dir)


def test_orbax_backend_save_resume_and_loadpath(runs):
    """ckpt_backend="orbax" at dp 2 x tp 2: epoch 0 saved, the second run
    resumes it to epoch 1; both runs' params equal the one-process runs
    (rtol 1e-4); each state directory reloads whole, in this process, to
    the returned params bit for bit; the one-process stage-1 orbax state
    warm-starts main_mtp --loadpath (params only, equal to load_state's)."""
    refs, inputs, tmp = runs[2], runs[3], runs[4]
    ranks = _ranks(runs, "train", 4)
    cpdir = inputs["train"]["world_orbax"]
    assert trainer.latest_state(cpdir).endswith("state_1.orbax")
    for r, out in enumerate(ranks):
        for got, want in zip(out["loop_orbax"], refs["loop_orbax"]):
            _assert_trees_close(got, want, rtol=1e-4, atol=1e-6, what=f"rank {r}")
    first, second = ranks[0]["loop_orbax"]
    assert not np.allclose(first["fc_w"], second["fc_w"])  # the resume moved on
    for epoch, returned in ((0, first), (1, second)):
        got_epoch, params, opt = trainer.load_state(
            os.path.join(cpdir, f"state_{epoch}.orbax"), device=CPU)
        assert got_epoch == epoch and opt.count == 2 * (epoch + 1)
        _assert_trees_equal(params, returned, f"orbax epoch {epoch}")
    one = trainer.load_state(str(tmp / "one_orbax" / "state_0.orbax"), device=CPU)[1]
    _assert_trees_equal(one, refs["loop_orbax"][0], "one-process orbax")
    stage1 = str(tmp / "stage1_orbax" / "state_0.orbax")
    _assert_trees_equal(trainer.load_params(stage1, device=CPU),
                        trainer.load_state(stage1, device=CPU)[1], "params-only restore")
    assert trainer.latest_state(str(tmp / "warm")).endswith("state_0.pkl")


def test_orbax_tp2_quantized_save_reloads_exactly(runs):
    """A tp 2 orbax save of an int4-quantized draft (its split from
    quantized_draft_specs, Q4Tensor / QTensor leaves field by field) and of
    tp-sharded moments: every rank reloads its shards bit for bit, and the
    directory reloads whole in one process to the whole tree."""
    ranks = _ranks(runs, "train", 4)
    for r, out in enumerate(ranks):
        q = out["orbax_tp2"]
        assert q["epoch"] == 7 and q["count"] == 3, r
        assert q["params_equal"] and q["mu_equal"] and q["nu_equal"], r
    local = ranks[0]["orbax_tp2"]["local_leaves"]
    whole, mu, nu = world.quantized_trees()
    assert local["layer/wq:packed"][-1] * 2 == whole["layer"]["wq"].packed.shape[-1]
    assert local["layer/wo:packed"] == tuple(whole["layer"]["wo"].packed.shape)  # row-parallel
    assert local["embed"][0] * 2 == whole["embed"].shape[0]
    epoch, params, opt = trainer.load_state(ranks[0]["orbax_tp2"]["path"], device=CPU)
    assert epoch == 7 and opt.count == 3
    for got_tree, want_tree in ((params, whole), (opt.mu, mu), (opt.nu, nu)):
        got, want = dict(trainer._items(got_tree)), dict(trainer._items(want_tree))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("mode", list(world.ENGINE_MODES))
def test_engine_tp2_equals_unsharded_and_jax(runs, mode):
    """SpecModel.serving_engine on a tp 2 model (3 prompts, batch 2, 16
    tokens, chunk_rounds 4; plain, and int8 KV with an int4 draft): every
    rank's tokens equal the unsharded port engine's and JAX's engine's, and
    its slot caches hold the rank's heads."""
    (ref,) = _get(runs, "jax")
    want = runs[2]["engine"][mode]
    assert want == ref["engine"][mode]
    assert all(len(t) == 16 for t in want)
    for r, out in enumerate(_ranks(runs, "train", 4)):
        got = out["engine"][mode]
        assert got["tokens"] == want, f"rank {r}"
        heads = world.TARGET["num_key_value_heads"] // 2
        assert tuple(got["cache_heads"][0]) == (world.TARGET["num_hidden_layers"], heads)
        assert got["cache_heads"][1] == world.DRAFT["num_key_value_heads"] // 2


def test_train_returns_whole_params_on_every_rank(runs):
    """train(mesh=) returns whole params that one device can use: every
    rank's equal the others' and have the unsharded shapes."""
    ranks = _ranks(runs, "train", 4)
    dcfg = DraftConfig(**world.LOOP_DRAFT)
    shapes = {p: tuple(t.shape) for p, t in leaves(
        trainer.draft_mod.init_params(dcfg, torch.Generator().manual_seed(0), CPU,
                                      torch.float32))}
    for out in ranks:
        flat = _flat(out["loop_pickle"])
        assert {k: v.shape for k, v in flat.items()} == shapes
        _assert_trees_equal(out["loop_pickle"], ranks[0]["loop_pickle"], "ranks agree")
