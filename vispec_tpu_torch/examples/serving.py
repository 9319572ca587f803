"""Continuous-batching serving demo: a random-weight model, fixed decode
slots, queued requests admitted mid-flight, an optional int8 draft and
prefix caching.

  python -m vispec_tpu_torch.examples.serving [--device cuda] [--int8] [--batch 4] \
      [--hidden 256] [--max-new-tokens 64]

With real checkpoints build the model with ``SpecModel.from_pretrained``
(``examples/quickstart.py``); the engine's API is the same.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import DraftConfig, LlamaConfig, SpecConfig
from ..models import draft as draft_mod
from ..models import llama
from ..spec.spec_model import SpecModel


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = torch.device(args.device)

    # head_dim 128 at the default width (the attention kernel takes 16 and 128)
    heads = max(1, args.hidden // 128)
    tcfg = LlamaConfig(vocab_size=1024, hidden_size=args.hidden,
                       intermediate_size=args.hidden * 2, num_hidden_layers=4,
                       num_attention_heads=heads, num_key_value_heads=heads,
                       max_position_embeddings=1024)
    dcfg = DraftConfig(vocab_size=1024, hidden_size=args.hidden,
                       intermediate_size=args.hidden * 2, num_attention_heads=heads,
                       num_key_value_heads=heads, max_position_embeddings=1024)
    # bfloat16 on the card, float32 on the CPU (whose bf16 products are slow)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    tparams = llama.init_params(tcfg, torch.Generator(dev).manual_seed(0), dev, dtype)
    dparams = draft_mod.init_params(dcfg, torch.Generator(dev).manual_seed(1), dev, dtype)
    dparams["embed"] = tparams["embed"]
    model = SpecModel(tcfg, dcfg, SpecConfig(total_tokens=30, depth=3, top_k=8), tparams,
                      dparams, max_len=1024, dtype=dtype, eos_token_id=10**6,
                      quantize_draft=args.int8, device=dev)

    rng = np.random.default_rng(0)
    system_prompt = rng.integers(5, 1000, 48).tolist()  # the shared prefix
    prompts = [system_prompt + rng.integers(5, 1000, rng.integers(8, 60)).tolist()
               for _ in range(args.requests)]

    engine = model.serving_engine(batch_size=args.batch, max_new_tokens=args.max_new_tokens,
                                  pad_bucket=256,
                                  prefix_ids=system_prompt, suffix_bucket=128)
    engine.run_all(prompts[:args.batch])  # warm-up
    t0 = time.perf_counter()
    outs = engine.run_all(prompts)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"served {len(prompts)} requests on {args.batch} slots "
          f"({'int8' if args.int8 else str(dtype).split('.')[-1]} draft, prefix-cached, "
          f"{dev}): {total} tokens in {dt:.2f}s = {total / dt:.1f} tok/s")
    mean_tau = np.mean([a + 1 for lens in engine.acceptance.values() for a in lens] or [1.0])
    print(f"mean accepted length (random draft ~1): {mean_tau:.2f}")


if __name__ == "__main__":
    main()
