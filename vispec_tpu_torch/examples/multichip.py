"""Multi-device speculative decoding and draft training: the mesh recipes
of every split the port supports, one process per rank:

  torchrun --nproc-per-node 4 -m vispec_tpu_torch.examples.multichip [--device cuda]

``--device cpu`` runs the ranks on the CPU over gloo; on CUDA each rank
takes a card of its own over NCCL (ranks that must share a card fall back
to gloo).  Recipes (pick by model size and prompt length; an axis of size 1
is free):

  fits on one device           -> no mesh (no collective at all)
  weights too big for one card -> pp=2 layer stages (no weight traffic) or
                                  tp=2 (splits every product and the KV
                                  cache's heads; a collective per layer)
  very long prompts            -> sp=N sequence-parallel prefill
  training                     -> dp x tp (+ sp for long sequences)

With real checkpoints pass ``mesh=`` to ``SpecModel.from_pretrained``
(and ``pp=`` / ``sp=``).  Rank 0 prints the results; every rank checks
its tokens against its own single-device run.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..parallel import multihost, sharding
from ..parallel.mesh import make_mesh
from ..spec.spec_model import SpecModel

TCFG = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
DCFG = DraftConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
PROMPT = list(range(30, 60))


def build(device) -> SpecModel:
    """The same random float32 model on every rank (seeded)."""
    tparams = llama.init_params(TCFG, torch.Generator(device).manual_seed(0), device,
                                torch.float32)
    dparams = draft_mod.init_params(DCFG, torch.Generator(device).manual_seed(1), device,
                                    torch.float32)
    dparams["embed"] = tparams["embed"]
    return SpecModel(TCFG, DCFG, SpecConfig(total_tokens=12, depth=3, top_k=4), tparams,
                     dparams, max_len=512, dtype=torch.float32, eos_token_id=0,
                     device=device)


def train_step_recipe(mesh, device) -> tuple:
    """One draft training step on a dp x tp mesh and the same step in one
    process: (the sharded loss, the single-device loss)."""
    from ..train.step import TrainBatch, make_optimizer, train_step

    g = torch.Generator(device).manual_seed(2)
    b, s, d = 2, 32, DCFG.hidden_size
    plan, max_span = draft_mod.make_prefill_plan(None, s, DCFG.num_q, s, device=device)
    batch = TrainBatch(*(torch.randn((b, s, d), generator=g, device=device) for _ in range(3)),
                       loss_mask=torch.ones((b, s), device=device),
                       plans=draft_mod.PrefillPlan(*(torch.stack([f] * b) for f in plan)))
    head_w = torch.randn((d, DCFG.vocab_size), generator=g, device=device) * 0.02
    opt = make_optimizer(1e-3, 2, 100, 0.5)
    losses = []
    for m in (mesh, None):
        params = draft_mod.init_params(DCFG, torch.Generator(device).manual_seed(3), device,
                                       torch.float32)
        hw, bat = head_w, batch
        if m is not None:
            params = sharding.apply_specs(m, params, sharding.draft_param_specs(DCFG))
            hw = sharding.local_part(head_w, (None, "tp"), m.shape, m.coords).contiguous()
            bat = sharding.shard_train_batch(m, batch)
        _, _, metrics = train_step(params, opt.init(params), DCFG, hw, bat, opt,
                                   mtp_steps=1, max_span=max_span, mesh=m)
        losses.append(float(metrics["loss"]))
    return tuple(losses)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    multihost.init_distributed()
    if multihost.process_count() != 4:
        raise SystemExit("launch four ranks: torchrun --nproc-per-node 4 -m "
                         "vispec_tpu_torch.examples.multichip")
    torch.backends.cuda.matmul.allow_tf32 = False
    lead = multihost.process_index() == 0

    def say(text):
        if lead:
            print(text, flush=True)

    def check(model, name):
        out = model.specgenerate(PROMPT, max_new_tokens=24)
        same = out.sequences[:40].tolist() == ref.sequences[:40].tolist()
        if not same:
            raise SystemExit(f"{name}: rank {multihost.process_index()} differs from one "
                             "device")
        return out

    # every mesh is built by every rank, in the same order
    tp_mesh = make_mesh(tp=2, device=args.device)  # dp 2 x tp 2: replicas of a tp pair
    stage_mesh = make_mesh(pp=2, sp=2, device=args.device)
    device = tp_mesh.device
    ref = build(device).specgenerate(PROMPT, max_new_tokens=24)
    say(f"single-device   : {ref.new_tokens} tokens")

    # tensor parallel: heads and MLP columns split, the KV cache over heads
    model = build(device)
    model.shard_over(tp_mesh)
    out = check(model, "tp=2")
    say(f"tp=2            : {out.new_tokens} tokens (token-identical)")

    # layer-stage placement with a sequence-parallel prefill
    model = build(device)
    model.shard_over(stage_mesh, pp=True, sp=True)
    out = check(model, "pp=2 x sp=2")
    say(f"pp=2 x sp=2     : {out.new_tokens} tokens (token-identical)")

    # an int8 draft composes with tp (quantize first, then shard)
    model = build(device)
    model.quantize_draft_inplace("int8")
    model.shard_over(tp_mesh)
    out = model.specgenerate(PROMPT, max_new_tokens=24)
    say(f"int8 draft tp=2 : {out.new_tokens} tokens")

    # the sharded engine: every rank submits the same requests in order
    model = build(device)
    model.shard_over(tp_mesh)
    outs = model.serving_engine(batch_size=2, max_new_tokens=16).run_all(
        [PROMPT, PROMPT[5:], PROMPT[:20]])
    say(f"engine tp=2     : {sum(len(o) for o in outs)} tokens for 3 requests")

    # draft training: dp 2 x tp 2, the loss of one process's step
    sharded, single = train_step_recipe(tp_mesh, device)
    if abs(sharded - single) > 1e-5 * max(1.0, abs(single)):
        raise SystemExit(f"dp x tp train step: loss {sharded} != one process's {single}")
    say(f"train dp=2 x tp=2: loss {sharded:.6f} (one process {single:.6f})")
    say("multichip demo OK")


if __name__ == "__main__":
    main()
