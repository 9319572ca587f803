"""The processes behind tests/test_torch_parallel.py.

``python tests/torch_parallel_world.py jax <inputs.pkl> <out.pkl>`` runs the
JAX package's single-device reference of every case; ``python
tests/torch_parallel_world.py rank <rank> <world> <init file> <inputs.pkl>
<out.pkl> [cli]`` is one rank of a gloo world of the port (no JAX in these
processes): the model cases in a world of four ranks, the CLI cases
(``gen_answer --tp 2``, ``ge_data --tp 2``, ``mesh_from_args``) in a world
of two.  The inputs (numpy weights in the JAX package's layout, made from
seeds, and the paths of fabricated checkpoints) come from the test module.
"""

import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TARGET = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
DRAFT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512, num_q=2)
SPEC = dict(total_tokens=12, depth=3, top_k=4)
EXPERTS = dict(num_local_experts=4, num_experts_per_tok=2)
PROMPT = list(range(30, 60))
BATCH_PROMPTS = [list(range(30, 60)), list(range(50, 75)), list(range(5, 45))]
NEW = 16
NEVER = 10 ** 6  # an eos id no token reaches: every run takes its whole budget

# (name, mesh (tp, pp, sp), options): the model cases of the four-rank world
MODEL_CASES = [
    ("tp2", (2, 1, 1), {}),
    ("sp2", (1, 1, 2), {}),
    ("pp2", (1, 2, 1), {}),
    ("pp2_tp2", (2, 2, 1), {}),
    ("pp2_sp2", (1, 2, 2), {}),
    ("mixtral_ep2", (2, 1, 1), {"mixtral": True}),
    ("mixtral_pp2_tp2", (2, 2, 1), {"mixtral": True}),
    ("qkv_bias_tp2", (2, 1, 1), {"bias": True}),
    ("int8_draft_tp2", (2, 1, 1), {"quantize_draft": "int8"}),
    ("int4_draft_int8_kv_tp2", (2, 1, 1), {"quantize_draft": "int4", "quantize_kv": True}),
    ("int8_target_tp2", (2, 1, 1), {"quantize_target": True, "quantize_draft": "int8"}),
    ("medusa_tp2", (2, 1, 1), {"medusa": True}),
]
OTHER_CASES = ["batch_tp2", "vision_tp2", "from_pretrained_tp2"]


# ---------------------------------------------------------------------------
# Weights (numpy, the JAX package's layout)
# ---------------------------------------------------------------------------


def target_tree(seed: int, bias: bool = False, mixtral: bool = False) -> dict:
    """A target in the JAX layout, N(0, 0.02) matrices; wq / wk x5 (and the
    router x20, the experts x5) so that attention and routing vary."""
    rng = np.random.default_rng(seed)
    c = TARGET
    l, d, i, v = (c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"],
                  c["vocab_size"])
    hd = d // c["num_attention_heads"]
    hq, hkv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd

    def w(*shape, scale=1.0):
        return (rng.normal(0, 0.02, shape) * scale).astype(np.float32)

    layers = {"input_norm": np.ones((l, d), np.float32),
              "post_norm": np.ones((l, d), np.float32),
              "wq": w(l, d, hq, scale=5), "wk": w(l, d, hkv, scale=5), "wv": w(l, d, hkv),
              "wo": w(l, hq, d)}
    if mixtral:
        e = EXPERTS["num_local_experts"]
        layers.update(router=w(l, d, e, scale=20), we_gate=w(l, e, d, i, scale=5),
                      we_up=w(l, e, d, i, scale=5), we_down=w(l, e, i, d, scale=5))
    else:
        layers.update(w_gate=w(l, d, i), w_up=w(l, d, i), w_down=w(l, i, d))
    if bias:
        layers.update(bq=w(l, hq, scale=10), bk=w(l, hkv, scale=10), bv=w(l, hkv, scale=10))
    return {"embed": w(v, d), "layers": layers, "final_norm": np.ones((d,), np.float32),
            "lm_head": w(d, v)}


def draft_tree(seed: int, bias: bool = False, vision: bool = True) -> dict:
    """A ViSpec draft in the JAX layout (adaptor and img_fc with vision),
    random fuse weights and biases."""
    rng = np.random.default_rng(seed)
    c = DRAFT
    d, i, v, h = c["hidden_size"], c["intermediate_size"], c["vocab_size"], \
        c["num_attention_heads"]
    hd = d // h
    hq, hkv = h * hd, c["num_key_value_heads"] * hd

    def w(*shape, scale=1.0):
        return (rng.normal(0, 0.02, shape) * scale).astype(np.float32)

    layer = {"post_norm": np.ones((d,), np.float32), "wq": w(d, hq, scale=5),
             "wk": w(d, hkv, scale=5), "wv": w(d, hkv), "wo": w(hq, d), "w_gate": w(d, i),
             "w_up": w(d, i), "w_down": w(i, d)}
    if bias:
        layer.update(bq=w(hq, scale=10), bk=w(hkv, scale=10), bv=w(hkv, scale=10))
    tree = {"embed": w(v, d), "layer": layer, "fc_w": w(2 * d, d, scale=20),
            "fc_b": w(d, scale=10)}
    if vision:
        tree["adaptor"] = {"q": w(c["num_q"], h, hd, scale=10), "wk": w(d, hq),
                           "wv": w(d, hq), "wo": w(hq, d)}
        if bias:
            tree["adaptor"].update(bk=w(hq, scale=10), bv=w(hq, scale=10))
        tree["img_fc_w"] = w(2 * d, d, scale=20)
        tree["img_fc_b"] = w(d, scale=10)
    return tree


def medusa_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d = TARGET["hidden_size"]
    return {"heads_w": rng.normal(0, 0.05, (5, d, d)).astype(np.float32),
            "heads_b": rng.normal(0, 0.05, (5, d)).astype(np.float32)}


def case_weights(index: int, opts: dict):
    """(target, draft, medusa heads or None) of a model case, seeded by its
    index."""
    t = target_tree(100 + index, bias=opts.get("bias", False),
                    mixtral=opts.get("mixtral", False))
    d = draft_tree(200 + index, bias=opts.get("bias", False))
    d["embed"] = t["embed"]
    return t, d, (medusa_tree(300 + index) if opts.get("medusa") else None)


# ---------------------------------------------------------------------------
# The JAX reference (single device)
# ---------------------------------------------------------------------------


def jax_main(inputs_path: str, out_path: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from vispec_tpu.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu.models import mixtral
    from vispec_tpu.spec.batch import generate_batch
    from vispec_tpu.spec.spec_model import SpecModel

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {}
    dcfg, spec = DraftConfig(**DRAFT), SpecConfig(**SPEC)
    for index, (name, _, opts) in enumerate(MODEL_CASES):
        t, d, m = case_weights(index, opts)
        if opts.get("mixtral"):
            tcfg = mixtral.MixtralConfig(**TARGET, **EXPERTS)
        else:
            tcfg = LlamaConfig(**TARGET, qkv_bias=opts.get("bias", False))
        dc = DraftConfig(**DRAFT, qkv_bias=opts.get("bias", False))
        tp = jax.tree.map(jnp.asarray, t)
        dp = jax.tree.map(jnp.asarray, d)
        dp["embed"] = tp["embed"]
        model = SpecModel(tcfg, dc, spec, tp, dp, max_len=512, dtype=jnp.float32,
                          eos_token_id=NEVER, quantize_kv=opts.get("quantize_kv", False),
                          mparams=None if m is None else jax.tree.map(jnp.asarray, m))
        if opts.get("quantize_target"):
            model.quantize_target_inplace()
        if opts.get("quantize_draft"):
            model.quantize_draft_inplace(opts["quantize_draft"])
        out[name] = (model.specgenerate(PROMPT, max_new_tokens=NEW).sequences.tolist(),
                     model.ar_generate(PROMPT, max_new_tokens=NEW).sequences.tolist())

    t, d, _ = case_weights(len(MODEL_CASES), {})
    tp = jax.tree.map(jnp.asarray, t)
    dp = jax.tree.map(jnp.asarray, d)
    dp["embed"] = tp["embed"]
    outs = generate_batch(tp, dp, LlamaConfig(**TARGET), dcfg, spec, BATCH_PROMPTS,
                          max_new_tokens=NEW, max_len=256, eos_id=NEVER, dtype=jnp.float32)
    out["batch_tp2"] = [np.asarray(o).tolist() for o in outs]

    v = inputs["vision"]
    model = SpecModel.from_pretrained(v["target"], v["draft"], total_token=12, depth=3,
                                      top_k=4, max_len=512, dtype=jnp.float32)
    n = model.count_image_tokens(tuple(v["image"].shape[:2]))
    ids = list(range(10, 22)) + [v["image_token"]] * n + list(range(30, 48))
    kw = dict(max_new_tokens=10, pixel_values=jnp.asarray(v["image"]),
              image_size=tuple(v["image"].shape[:2]))
    out["vision_ids"] = ids
    out["vision_tp2"] = (model.specgenerate(ids, **kw).sequences.tolist(),
                         model.ar_generate(ids, **kw).sequences.tolist())

    p = inputs["pretrained"]
    model = SpecModel.from_pretrained(p["target"], p["draft"], total_token=12, depth=3,
                                      top_k=4, max_len=512, dtype=jnp.float32)
    prompt = list(range(10, 40))
    out["from_pretrained_tp2"] = (
        model.specgenerate(prompt, max_new_tokens=15).sequences.tolist(),
        model.ar_generate(prompt, max_new_tokens=15).sequences.tolist())
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# One rank of the port's gloo world
# ---------------------------------------------------------------------------


def _port_model(index: int, opts: dict):
    import torch

    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.models import mixtral
    from vispec_tpu_torch.spec.spec_model import SpecModel

    t, d, m = case_weights(index, opts)
    if opts.get("mixtral"):
        tcfg = mixtral.MixtralConfig(**TARGET, **EXPERTS)
    else:
        tcfg = LlamaConfig(**TARGET, qkv_bias=opts.get("bias", False))
    tp, dp = from_numpy(t, "cpu"), from_numpy(d, "cpu")
    dp["embed"] = tp["embed"]
    model = SpecModel(tcfg, DraftConfig(**DRAFT, qkv_bias=opts.get("bias", False)),
                      SpecConfig(**SPEC), tp, dp, max_len=512, dtype=torch.float32,
                      eos_token_id=NEVER, quantize_kv=opts.get("quantize_kv", False),
                      mparams=None if m is None else from_numpy(m, "cpu"), device="cpu")
    if opts.get("quantize_target"):
        model.quantize_target_inplace()
    if opts.get("quantize_draft"):
        model.quantize_draft_inplace(opts["quantize_draft"])
    return model


def _layout(model) -> dict:
    """Local shapes and facts a test checks about a sharded model."""
    from vispec_tpu_torch.ops.quant import QTensor

    lay = model.tparams["layers"]
    return {"wq": tuple(lay["wq"].shape), "wo": tuple(lay["wo"].shape),
            "embed": tuple(model.tparams["embed"].shape),
            "lm_head": tuple(model.tparams["lm_head"].shape),
            "we_down": tuple(lay["we_down"].shape) if "we_down" in lay else None,
            "draft_wq": (tuple(model.dparams["layer"]["wq"].shape)
                         if model.dparams.get("layer") else None),
            "int8_target": isinstance(lay["wq"], QTensor),
            "embed_alias": model.dparams["embed"] is model.tparams["embed"]}


def _model_cases(mesh_for) -> dict:
    from vispec_tpu_torch.parallel import sharding

    out = {}
    for index, (name, (tp, pp, sp), opts) in enumerate(MODEL_CASES):
        mesh = mesh_for(tp, pp, sp)
        model = _port_model(index, opts)
        lazy = model._target_cache is None and model._draft_cache is None
        model.shard_over(mesh, pp=pp > 1, sp=sp > 1)
        info = {"lazy_after_shard": lazy and model._target_cache is None
                and model._draft_cache is None}
        cache = model.target_cache  # the first touch, at this rank's size
        info["cache_k"] = tuple(cache.k.shape)
        sharding.COLLECTIVES.reset()
        spec = model.specgenerate(PROMPT, max_new_tokens=NEW).sequences.tolist()
        info["collectives"] = dict(sharding.COLLECTIVES.calls)
        ar = model.ar_generate(PROMPT, max_new_tokens=NEW).sequences.tolist()
        if opts.get("quantize_target"):  # the batch over the rank's int8 shards
            got = model.specgenerate_batch([{"input_ids": p} for p in BATCH_PROMPTS],
                                           max_new_tokens=NEW)
            info["batch_equal"] = [
                g.sequences.tolist() == model.specgenerate(p, max_new_tokens=NEW)
                .sequences[:len(g.sequences)].tolist() for p, g in zip(BATCH_PROMPTS, got)]
        info.update(_layout(model))
        out[name] = (spec, ar, info)
    return out


def _batch_case(mesh) -> list:
    import torch

    from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.spec.batch import generate_batch

    tcfg, dcfg = LlamaConfig(**TARGET), DraftConfig(**DRAFT)
    t, d, _ = case_weights(len(MODEL_CASES), {})
    d["embed"] = t["embed"]
    tp = sharding.apply_specs(mesh, from_numpy(t, "cpu"), sharding.llama_param_specs(tcfg))
    dp = sharding.apply_specs(mesh, from_numpy(d, "cpu"), sharding.draft_param_specs(dcfg))
    outs = generate_batch(tp, dp, tcfg, dcfg, SpecConfig(**SPEC), BATCH_PROMPTS,
                          max_new_tokens=NEW, max_len=256, eos_id=NEVER,
                          dtype=torch.float32, device="cpu", mesh=mesh)
    return [np.asarray(o).tolist() for o in outs]


def _checkpoint_cases(mesh, inputs) -> dict:
    import torch

    from vispec_tpu_torch.spec.spec_model import SpecModel

    out = {}
    v = inputs["vision"]
    model = SpecModel.from_pretrained(v["target"], v["draft"], total_token=12, depth=3,
                                      top_k=4, max_len=512, dtype=torch.float32, mesh=mesh)
    n = model.count_image_tokens(tuple(v["image"].shape[:2]))
    ids = list(range(10, 22)) + [v["image_token"]] * n + list(range(30, 48))
    out["vision_ids"] = ids
    kw = dict(max_new_tokens=10, pixel_values=v["image"], image_size=v["image"].shape[:2])
    out["vision_tp2"] = (model.specgenerate(ids, **kw).sequences.tolist(),
                         model.ar_generate(ids, **kw).sequences.tolist(), _layout(model))
    p = inputs["pretrained"]
    model = SpecModel.from_pretrained(p["target"], p["draft"], total_token=12, depth=3,
                                      top_k=4, max_len=512, dtype=torch.float32, mesh=mesh)
    prompt = list(range(10, 40))
    out["from_pretrained_tp2"] = (
        model.specgenerate(prompt, max_new_tokens=15).sequences.tolist(),
        model.ar_generate(prompt, max_new_tokens=15).sequences.tolist(), _layout(model))
    return out


def _cli_cases(rank: int, inputs: dict) -> dict:
    """gen_answer and ge_data at --tp 1 (rank 0 and rank 1 alone) and --tp 2
    (both ranks), the mesh_from_args contract and local_shard."""
    import torch.distributed as dist

    from vispec_tpu_torch.evaluation import gen_answer
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.parallel.multihost import local_shard
    from vispec_tpu_torch.train import ge_data

    c = inputs["cli"]

    def run(mod, argv):
        sys.argv = argv
        mod.main()

    def answers(extra, path):
        run(gen_answer, ["gen_answer", "--bench", "vicuna", "--model", c["target"],
                         "--spec-model", c["draft"], "--data-root", c["data_root"],
                         "--total-token", "12", "--depth", "3", "--top-k", "4",
                         "--max-len", "512", "--max-new-tokens", "12", "--device", "cpu",
                         "--answer-file", path] + extra)

    def data(extra, outdir):
        run(ge_data, ["ge_data", "--basepath", c["target"], "--dataset", "sharegpt",
                      "--data-file", c["sharegpt"], "--outdir", outdir, "--max-len", "64",
                      "--max-new-tokens", "16", "--shard-id", "0", "--num-shards", "2",
                      "--device", "cpu"] + extra)

    out = {}
    # --tp 1 in one process each: rank 0 answers, rank 1 generates data
    if rank == 0:
        answers([], c["answers_tp1"])
    else:
        data([], c["data_tp1"])
    dist.barrier()
    answers(["--tp", "2"], c["answers_tp2"])
    data(["--tp", "2"], c["data_tp2"])
    out["mesh_from_args_none"] = meshmod.mesh_from_args() is None
    errors = []
    for kw in (dict(dp=2, bs=3), dict(sp=2, max_len=65)):
        try:
            meshmod.mesh_from_args(**kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["mesh_from_args_errors"] = errors
    mesh = meshmod.mesh_from_args(tp=2, bs=4, max_len=64, device="cpu")
    out["mesh_from_args_shape"] = dict(mesh.shape)
    out["mesh_from_args_backend"] = mesh.describe()
    out["local_shard"] = list(local_shard(10))
    return out


def rank_main(rank: int, world: int, init_file: str, inputs_path: str, out_path: str,
              cli: bool) -> None:
    import torch

    torch.set_num_threads(1)
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.parallel import multihost

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    assert multihost.init_distributed(init_method="file://" + init_file,
                                      num_processes=world, process_id=rank) == rank
    if cli:
        out = _cli_cases(rank, inputs)
    else:
        def mesh_for(tp, pp, sp):
            return meshmod.make_mesh(tp=tp, pp=pp, sp=sp, device="cpu")

        out = _model_cases(mesh_for)
        mesh = mesh_for(2, 1, 1)
        out["batch_tp2"] = _batch_case(mesh)
        out.update(_checkpoint_cases(mesh, inputs))
        out["local_shard"] = list(multihost.local_shard(10))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2], sys.argv[3])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
                  len(sys.argv) > 7 and sys.argv[7] == "cli")
