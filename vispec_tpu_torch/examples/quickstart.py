"""Quickstart: speculative decoding end to end on random weights (no
downloads).

  python -m vispec_tpu_torch.examples.quickstart [--device cuda] [--epochs 30]

Builds a small target and draft, trains the draft briefly on the target's
own continuations (the ViSpec data recipe), and compares speculative with
autoregressive decoding: greedy spec output equals AR token for token.
With real checkpoints build the model with ``SpecModel.from_pretrained``
(README.md).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..ops import kv_cache as kv
from ..spec.spec_model import SpecModel
from ..train import data_gen, trainer
from ..train.step import make_optimizer, train_step

TCFG = LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
DCFG = DraftConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--samples", type=int, default=12)
    args = p.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    tparams = llama.init_params(TCFG, torch.Generator(dev).manual_seed(0), dev, torch.float32)

    with tempfile.TemporaryDirectory(prefix="vispec_data_") as datadir:
        dparams = _train_draft(args, tparams, datadir, dev)

    dparams["embed"] = tparams["embed"]
    model = SpecModel(TCFG, DCFG, SpecConfig(total_tokens=16, depth=3, top_k=4), tparams,
                      dparams, max_len=512, dtype=torch.float32, eos_token_id=999, device=dev)
    prompt = np.random.default_rng(1).integers(1, 90, 16).tolist()
    spec = model.specgenerate(prompt, max_new_tokens=48)
    ar = model.ar_generate(prompt, max_new_tokens=48)
    tau = np.mean([a + 1 for a in spec.acceptance_lengths])
    n = min(spec.new_tokens, ar.new_tokens)
    same = spec.sequences[:16 + n].tolist() == ar.sequences[:16 + n].tolist()
    print(f"spec: {spec.new_tokens} tokens in {spec.rounds} rounds "
          f"(tau={tau:.2f}); greedy-lossless vs AR: {same}")
    if not same:
        raise SystemExit("speculative output differs from autoregressive output")


def _train_draft(args, tparams, datadir, dev):
    """Steps 1 and 2: write the target's own greedy continuations as
    samples, then train the one-layer draft on them (MTP loss)."""
    cache = kv.init_cache(2, 2, 256, 16, torch.float32, dev)
    rng = np.random.default_rng(0)
    for i in range(args.samples):
        ids = rng.integers(1, 90, 16)
        embeds = llama.embed(tparams, torch.as_tensor(ids, device=dev))
        embeds = torch.cat([embeds, embeds.new_zeros((64 - len(ids), embeds.shape[1]))])
        sample, cache = data_gen.generate_sample(tparams, TCFG, embeds, len(ids), None, cache,
                                                 max_new_tokens=48, eos_token_id=999)
        data_gen.save_sample(datadir, i, sample)
    print(f"generated {args.samples} samples -> {datadir}")

    cfg = trainer.TrainConfig(lr=3e-3, bs=2, max_len=64, mtp_steps=1, warmup_steps=5,
                              total_steps=4000, max_images=1, max_span_bucket=8,
                              noise_std=0.05)
    dparams = draft_mod.init_params(DCFG, torch.Generator(dev).manual_seed(1), dev,
                                    torch.float32)
    dparams["embed"] = tparams["embed"].clone()
    head_w = tparams["lm_head"].float()
    opt = make_optimizer(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.grad_clip)
    ost = opt.init(dparams)
    t0 = time.time()
    steps = 0
    metrics = {"loss": float("nan")}
    for epoch in range(args.epochs):
        for batch, _ in trainer.data_iterator(datadir, cfg, DCFG, seed=epoch, device=dev):
            dparams, ost, metrics = train_step(dparams, ost, DCFG, head_w, batch, opt,
                                               mtp_steps=1, max_span=8)
            steps += 1
    print(f"trained {steps} steps in {time.time() - t0:.0f}s "
          f"(loss {float(metrics['loss']):.3f})")
    return dparams


if __name__ == "__main__":
    main()
