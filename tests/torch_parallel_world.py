"""The processes behind tests/test_torch_parallel.py and
tests/test_torch_parallel_train.py.

``python tests/torch_parallel_world.py jax <inputs.pkl> <out.pkl>`` runs the
JAX package's single-device reference of every inference case (``jax-train``:
of the training step and the engine); ``python tests/torch_parallel_world.py
rank <rank> <world> <init file> <inputs.pkl> <out.pkl> [cli|train|medusa]``
is one rank of a gloo world of the port (no JAX in these processes): the
model cases in a world of four ranks, the CLI cases (``gen_answer --tp 2``,
``ge_data --tp 2``, ``mesh_from_args``) in a world of two; the training
cases (dp x sp and dp x tp steps, ``train()``, the stage-1 CLI, the orbax
backend, the engine at tp 2) in a world of four, the Medusa CLI at dp 2 in
a world of two.  The inputs (numpy weights in the JAX package's layout, made
from seeds, and the paths of fabricated checkpoints and data) come from the
test modules.
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


def draft_tree(seed: int, bias: bool = False, vision: bool = True, c: dict = DRAFT) -> dict:
    """A ViSpec draft in the JAX layout (adaptor and img_fc with vision),
    random fuse weights and biases, at the geometry ``c``."""
    rng = np.random.default_rng(seed)
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


# ---------------------------------------------------------------------------
# Parallel training and the sharded engine (tests/test_torch_parallel_train.py)
# ---------------------------------------------------------------------------

# tests/test_tp_inference.py's dp x sp step geometry, and tests/test_training.py's
# for the train() loop
STEP_DRAFT = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=64, num_q=2)
LOOP_DRAFT = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256, num_q=2)
LOOP_CFG = dict(lr=2e-3, bs=2, num_epochs=1, max_len=64, mtp_steps=1, warmup_steps=2,
                total_steps=1000, max_images=1, max_span_bucket=8)
# the JAX oracle's optimizer (make_optimizer()'s defaults): at a learning
# rate of 2e-3 the port's one-process step already differs from JAX's by
# 5.3e-6 in one adaptor/wk element after the second step (Adam's update of a
# gradient near zero turns float32 rounding into its sign)
STEP_OPT = dict(lr=3e-5, warmup_steps=2000, total_steps=800_000, grad_clip=0.5)
STEPS = 2
ENGINE_PROMPTS = [list(range(10, 34)), list(range(40, 61)), list(range(5, 29))]
ENGINE_MODES = {"plain": {}, "int8_kv_int4_draft": {"quantize_kv": True,
                                                      "quantize_draft": "int4"}}


def step_inputs() -> dict:
    """The dp x sp step's inputs in numpy: a draft (every leaf random), a
    batch of 2 x 16 rows whose image span (rows 4-9) crosses the sp 2
    boundary at row 8, a frozen head."""
    rng = np.random.default_rng(40)
    b, s, d = 2, 16, STEP_DRAFT["hidden_size"]
    image_mask = np.zeros(s, bool)
    image_mask[4:10] = True
    return {"draft": draft_tree(41, c=STEP_DRAFT), "image_mask": image_mask,
            "hidden_states": rng.normal(0, 1, (b, s, d)).astype(np.float32),
            "embeds": rng.normal(0, 1, (b, s, d)).astype(np.float32),
            "target": rng.normal(0, 1, (b, s, d)).astype(np.float32),
            "loss_mask": (rng.uniform(0, 1, (b, s)) < 0.8).astype(np.float32),
            "head": (rng.normal(0, 0.02, (d, STEP_DRAFT["vocab_size"])) * 5).astype(
                np.float32)}


def loop_head() -> np.ndarray:
    return np.random.default_rng(42).normal(0, 0.05, (LOOP_DRAFT["hidden_size"],
                                                      LOOP_DRAFT["vocab_size"])).astype(
        np.float32)


def quantized_trees() -> tuple:
    """The tp 2 orbax save's contents, from seeds: an int4-quantized draft at
    LOOP_DRAFT and two trees of its structure in the moments' place (random
    float leaves quantized alike)."""
    import torch

    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.ops.quant import quantize_draft_params

    head = torch.from_numpy(loop_head())
    return tuple(quantize_draft_params(from_numpy(draft_tree(seed, c=LOOP_DRAFT), "cpu"), head,
                                       mode="int4") for seed in (44, 45, 46))


def engine_model(torch_side: bool, opts: dict):
    """The engine cases' model (the MODEL_CASES weights of index 0), on the
    port (CPU) or in the JAX package, quantized as ``opts`` says."""
    t, d, _ = case_weights(0, {})
    if torch_side:
        import torch

        from vispec_tpu_torch.configs import DraftConfig, LlamaConfig, SpecConfig
        from vispec_tpu_torch.convert.params import from_numpy
        from vispec_tpu_torch.spec.spec_model import SpecModel

        tp, dp = from_numpy(t, "cpu"), from_numpy(d, "cpu")
        extra = {"dtype": torch.float32, "device": "cpu"}
    else:
        import jax
        import jax.numpy as jnp

        from vispec_tpu.configs import DraftConfig, LlamaConfig, SpecConfig
        from vispec_tpu.spec.spec_model import SpecModel

        tp, dp = jax.tree.map(jnp.asarray, t), jax.tree.map(jnp.asarray, d)
        extra = {"dtype": jnp.float32}
    dp["embed"] = tp["embed"]
    model = SpecModel(LlamaConfig(**TARGET), DraftConfig(**DRAFT), SpecConfig(**SPEC), tp, dp,
                      max_len=512, eos_token_id=NEVER,
                      quantize_kv=opts.get("quantize_kv", False), **extra)
    if opts.get("quantize_draft"):
        model.quantize_draft_inplace(opts["quantize_draft"])
    return model


def engine_tokens(model) -> list:
    outs = model.serving_engine(batch_size=2, max_new_tokens=16, chunk_rounds=4).run_all(
        ENGINE_PROMPTS)
    return [np.asarray(o).tolist() for o in outs]


def jax_train_main(inputs_path: str, out_path: str) -> None:
    """The JAX package's unsharded training step (STEPS steps from one
    state) and its engine in both modes."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from vispec_tpu.configs import DraftConfig
    from vispec_tpu.models import draft as draft_mod
    from vispec_tpu.train.step import TrainBatch, make_optimizer, train_step

    x = step_inputs()
    dcfg = DraftConfig(**STEP_DRAFT)
    s = x["hidden_states"].shape[1]
    plan, max_span = draft_mod.make_prefill_plan(x["image_mask"], s, dcfg.num_q, s,
                                                 max_images=1, max_span=8)
    b = x["hidden_states"].shape[0]
    batch = TrainBatch(hidden_states=jnp.asarray(x["hidden_states"]),
                       embeds=jnp.asarray(x["embeds"]), target=jnp.asarray(x["target"]),
                       loss_mask=jnp.asarray(x["loss_mask"]),
                       plans=jax.tree.map(lambda a: jnp.broadcast_to(a, (b,) + a.shape), plan))
    params = jax.tree.map(jnp.asarray, x["draft"])
    opt = make_optimizer(**STEP_OPT)
    state = opt.init(params)
    steps = []
    for _ in range(STEPS):
        params, state, metrics = train_step(params, state, dcfg, jnp.asarray(x["head"]), batch,
                                            opt, mtp_steps=1, max_span=max_span)
        adam = state[1]
        steps.append({"loss": float(metrics["loss"]),
                      "params": jax.tree.map(np.array, params),
                      "mu": jax.tree.map(np.array, adam.mu),
                      "nu": jax.tree.map(np.array, adam.nu)})
    out = {"steps": steps, "engine": {name: engine_tokens(engine_model(False, opts))
                                      for name, opts in ENGINE_MODES.items()}}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _numpy(tree):
    from vispec_tpu_torch.ops.quant import Q4Tensor, QTensor

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (QTensor, Q4Tensor)):
        return {f: _numpy(getattr(tree, f)) for f in tree.__dataclass_fields__}
    return tree.detach().cpu().numpy().copy()  # not a view of a tensor updated in place


def _step_case(mesh) -> list:
    """STEPS dp x sp steps of the port from step_inputs(); each step's
    metrics and the (whole) params and moments."""
    import torch

    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.models import draft as draft_mod
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train.step import TrainBatch, make_optimizer, train_step

    x = step_inputs()
    dcfg = DraftConfig(**STEP_DRAFT)
    s = x["hidden_states"].shape[1]
    plan, max_span = draft_mod.make_prefill_plan(x["image_mask"], s, dcfg.num_q, s,
                                                 max_images=1, max_span=8, device="cpu")
    b = x["hidden_states"].shape[0]
    batch = TrainBatch(*(torch.from_numpy(x[k]) for k in ("hidden_states", "embeds", "target",
                                                          "loss_mask")),
                       plans=draft_mod.PrefillPlan(*(torch.stack([f] * b) for f in plan)))
    params = from_numpy(x["draft"], "cpu")
    specs = sharding.quantized_draft_specs(dcfg, params)
    params = sharding.apply_specs(mesh, params, specs)
    head = sharding.local_part(torch.from_numpy(x["head"]), (None, "tp"), mesh.shape,
                               mesh.coords).contiguous()
    opt = make_optimizer(**STEP_OPT)
    state = opt.init(params)
    batch = sharding.shard_train_batch(mesh, batch)
    steps = []
    for _ in range(STEPS):
        sharding.COLLECTIVES.reset()
        params, state, metrics = train_step(params, state, dcfg, head, batch, opt,
                                            mtp_steps=1, max_span=max_span, mesh=mesh)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "collectives": dict(sharding.COLLECTIVES.calls),
                      "params": _numpy(sharding.gather_params(mesh, params, specs)),
                      "mu": _numpy(sharding.gather_params(mesh, state.mu, specs)),
                      "nu": _numpy(sharding.gather_params(mesh, state.nu, specs)),
                      "local_rows": tuple(batch.hidden_states.shape)})
    return steps


def _orbax_tp2(mesh, cpdir: str) -> dict:
    """A tp 2 orbax save of an int4-quantized draft with its specs and
    moments, reloaded into the rank's shards: equal bit for bit."""
    import torch

    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.parallel import sharding
    from vispec_tpu_torch.train import trainer
    from vispec_tpu_torch.train.step import AdamState, leaves

    dcfg = DraftConfig(**LOOP_DRAFT)
    q, mu, nu = quantized_trees()
    qspecs = sharding.quantized_draft_specs(dcfg, q)
    local = sharding.apply_specs(mesh, q, qspecs)
    opt = AdamState(3, sharding.apply_specs(mesh, mu, qspecs),
                    sharding.apply_specs(mesh, nu, qspecs))
    path = trainer.save_state(cpdir, 7, local, opt, backend="orbax", mesh=mesh, specs=qspecs)
    epoch, got, got_opt = trainer.load_state(path, device="cpu", mesh=mesh)

    def same(a, b):
        fa, fb = dict(trainer._items(a)), dict(trainer._items(b))
        return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)

    return {"path": path, "epoch": epoch, "count": got_opt.count,
            "params_equal": same(local, got), "mu_equal": same(opt.mu, got_opt.mu),
            "nu_equal": same(opt.nu, got_opt.nu),
            "local_leaves": {k: tuple(v.shape) for k, v in trainer._items(got)},
            "n_leaves": len(leaves(local))}


def _train_cases(rank: int, inputs: dict) -> dict:
    """The four-rank training world: the dp 2 x sp 2 step, the dp 2 x tp 2
    train() loop (pickle), then two runs with the orbax backend (epoch 0,
    then a resume to epoch 1), the tp 2 orbax save of a quantized draft,
    the stage-1 CLI at --dp 2 --sp 2, the engine at tp 2 in both modes."""
    import torch

    from vispec_tpu_torch.configs import DraftConfig
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.train import main as stage1_cli
    from vispec_tpu_torch.train import trainer

    out = {}
    mesh = meshmod.make_mesh(dp=2, sp=2, device="cpu")
    out["step_dp2_sp2"] = _step_case(mesh)
    mesh = meshmod.make_mesh(dp=2, tp=2, device="cpu")
    out["mesh_dp2_tp2"] = mesh.describe()
    c = inputs["train"]
    dcfg, head = DraftConfig(**LOOP_DRAFT), torch.from_numpy(loop_head())
    out["loop_pickle"] = _numpy(trainer.train(c["data"], c["world_pickle"], dcfg, head,
                                              trainer.TrainConfig(**LOOP_CFG), log_every=1,
                                              mesh=mesh))
    runs = []
    for epochs in (1, 2):
        cfg = trainer.TrainConfig(**dict(LOOP_CFG, num_epochs=epochs, ckpt_backend="orbax"))
        runs.append(_numpy(trainer.train(c["data"], c["world_orbax"], dcfg, head, cfg,
                                         log_every=1, mesh=mesh)))
    out["loop_orbax"] = runs
    out["orbax_tp2"] = _orbax_tp2(mesh, c["world_quant"])
    cli = inputs["cli"]
    sys.argv = ["main", "--basepath", cli["target"], "--configpath", cli["draft_cfg"],
                "--tmpdir", cli["data"], "--cpdir", cli["world_stage1"], "--bs", "2",
                "--max-len", "64", "--num-epochs", "1", "--device", "cpu",
                "--dp", "2", "--sp", "2"]
    stage1_cli.main()
    engine = {}
    mesh = meshmod.make_mesh(tp=2, device="cpu")
    for name, opts in ENGINE_MODES.items():
        model = engine_model(True, opts)
        model.shard_over(mesh)
        engine[name] = {"tokens": engine_tokens(model),
                        "cache_heads": model.serving_engine(2)._cache_dims()}
    out["engine"] = engine
    return out


def _medusa_case(inputs: dict) -> dict:
    from vispec_tpu_torch.train import main_medusa

    cli = inputs["cli"]
    sys.argv = ["main_medusa", "--basepath", cli["target"], "--tmpdir", cli["data"],
                "--cpdir", cli["world_medusa"], "--bs", "2", "--max-len", "64",
                "--num-epochs", "1", "--device", "cpu", "--dp", "2"]
    main_medusa.main()
    return {}


def rank_main(rank: int, world: int, init_file: str, inputs_path: str, out_path: str,
              job: str) -> None:
    import torch

    torch.set_num_threads(1)
    from vispec_tpu_torch.parallel import mesh as meshmod
    from vispec_tpu_torch.parallel import multihost

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    assert multihost.init_distributed(init_method="file://" + init_file,
                                      num_processes=world, process_id=rank) == rank
    if job == "cli":
        out = _cli_cases(rank, inputs)
    elif job == "train":
        out = _train_cases(rank, inputs)
    elif job == "medusa":
        out = _medusa_case(inputs)
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
    elif sys.argv[1] == "jax-train":
        jax_train_main(sys.argv[2], sys.argv[3])
    else:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
                  sys.argv[7] if len(sys.argv) > 7 else "model")
