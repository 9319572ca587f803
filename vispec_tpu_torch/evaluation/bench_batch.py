"""Batched-serving throughput benchmark (beyond the reference's bs=1 design).

  python -m vispec_tpu_torch.evaluation.bench_batch [--sizes 1,2,4] [--model 1B]

Builds a random-weight target+draft at the requested scale (weights drawn
from a seeded ``torch.Generator`` on the card), decodes a batch of prompts
through SpecModel.specgenerate_batch, and reports tokens/s per batch size
plus the scaling factor vs bs=1.

Arrival mode (``--arrival-rates 0.5,1,2``): requests arrive by a SEEDED
Poisson process (numpy) through the engine's online submit()/step() API.
Reports, per offered load: achieved tokens/s, p50/p90/p99 per-request
latency (completion - scheduled arrival, so queueing waits count), and the
share of wall time spent on mid-flight admission prefills.  The port's
own ``--device`` (default ``cuda``) picks where the model lives.
"""

from __future__ import annotations

import argparse
import json
import time

MODELS = {
    "7B": dict(num_hidden_layers=32, hidden_size=4096, intermediate_size=11008,
               num_attention_heads=32, num_key_value_heads=32),
    "3B": dict(num_hidden_layers=24, hidden_size=3072, intermediate_size=8192,
               num_attention_heads=24, num_key_value_heads=24),
    "1B": dict(num_hidden_layers=12, hidden_size=2048, intermediate_size=5504,
               num_attention_heads=16, num_key_value_heads=16),
}


def _wait(model) -> None:
    """Let the device finish what is queued (the engine's step returns with
    its last chunk read back, so this fences only stray work)."""
    if model.device.type == "cuda":
        import torch

        torch.cuda.synchronize(model.device)


def arrival_bench(model, b, new_tokens, rate, n_requests, seed=0,
                  vocab=32000, no_ladder=False):
    """Poisson open-loop serving benchmark through the ONLINE API.

    Requests arrive at ``rate``/s (seeded exponential interarrivals); the
    loop submits each request at its scheduled wall-clock time and steps the
    engine whenever work is pending.  Latency is completion - SCHEDULED
    arrival (queueing and admission stalls count against the engine, as a
    client would see them).  ``tokens`` holds each request's generated ids,
    in arrival order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(10, vocab - 10, 100).tolist() for _ in range(n_requests)]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))

    eng = model.serving_engine(batch_size=b, max_new_tokens=new_tokens)
    if no_ladder:
        # A/B control: every dispatch a full chunk, slots freed only at
        # chunk boundaries
        eng.chunk_ladder = (eng.chunk_rounds,)
    eng.run_all(prompts[:2 * b])  # warm every path, mid-flight admission too
    _wait(model)
    eng.start_session()

    done_at = {}
    rids = {}
    t0 = time.perf_counter()
    nxt = 0
    while len(done_at) < n_requests:
        now = time.perf_counter() - t0
        while nxt < n_requests and arrivals[nxt] <= now:
            rids[eng.submit(prompts[nxt])] = nxt
            nxt += 1
        if eng.pending():
            for rid in eng.step():
                done_at[rid] = time.perf_counter() - t0
        elif nxt < n_requests:
            time.sleep(min(0.002, max(arrivals[nxt] - (time.perf_counter() - t0), 0)))
    _wait(model)
    wall = time.perf_counter() - t0

    lats = np.array([done_at[r] - arrivals[rids[r]] for r in rids])
    toks = sum(len(eng.results[r]) for r in rids)
    by_arrival = sorted(rids, key=rids.get)
    return dict(
        offered_rate_per_s=rate, n_requests=n_requests, batch=b,
        tokens_per_s=round(toks / wall, 1), wall_s=round(wall, 2),
        latency_p50_s=round(float(np.percentile(lats, 50)), 3),
        latency_p90_s=round(float(np.percentile(lats, 90)), 3),
        latency_p99_s=round(float(np.percentile(lats, 99)), 3),
        latency_mean_s=round(float(lats.mean()), 3),
        admissions=eng.stats["admissions"],
        admit_stall_share=round(eng.stats["admit_dispatch_s"] / wall, 4),
        tokens=[np.asarray(eng.results[r]).tolist() for r in by_arrival],
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="1B", choices=sorted(MODELS))
    p.add_argument("--sizes", default="1,2,4")
    p.add_argument("--max-len", type=int, default=512)
    p.add_argument("--new-tokens", type=int, default=64)
    p.add_argument("--int8", action="store_true", help="int8 draft mode")
    p.add_argument("--int8-target", action="store_true",
                   help="int8 target weights (quantize_target_inplace)")
    p.add_argument("--int8-kv", action="store_true", help="int8 KV caches (quantize_kv)")
    p.add_argument("--engine", action="store_true",
                   help="continuous-batching engine (2x requests over the "
                        "slots, admission mid-flight) instead of a fixed batch")
    p.add_argument("--arrival-rates", default="",
                   help="Poisson open-loop mode: comma-separated offered "
                        "loads in requests/s (e.g. 0.5,1,2); implies the "
                        "online engine, uses the first --sizes entry as the "
                        "slot count")
    p.add_argument("--requests", type=int, default=24,
                   help="requests per arrival-mode leg")
    p.add_argument("--no-ladder", action="store_true",
                   help="arrival-mode A/B control: disable the chunk-size ladder")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from ..configs import DraftConfig, LlamaConfig, SpecConfig
    from ..models import draft as draft_mod
    from ..models import llama
    from ..spec.spec_model import SpecModel

    device = torch.device(args.device)
    dims = MODELS[args.model]
    tcfg = LlamaConfig(vocab_size=32000, max_position_embeddings=args.max_len, **dims)
    # drafts are 1-layer: the target's num_hidden_layers would allocate an
    # L-deep draft KV cache never used past layer 0
    ddims = {k: v for k, v in dims.items() if k != "num_hidden_layers"}
    dcfg = DraftConfig(vocab_size=32000, max_position_embeddings=args.max_len, **ddims)
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = torch.bfloat16
    tparams = llama.init_params(tcfg, gen, device, dtype)
    dparams = draft_mod.init_params(dcfg, gen, device, dtype)
    dparams["embed"] = tparams["embed"]
    model = SpecModel(tcfg, dcfg, SpecConfig(total_tokens=30, depth=3, top_k=8),
                      tparams, dparams, max_len=args.max_len, dtype=dtype,
                      eos_token_id=10**6, quantize_draft=args.int8,
                      quantize_kv=args.int8_kv, device=device)
    if args.int8_target:
        model.quantize_target_inplace("int8")

    quant_tag = "".join(["+int8" if args.int8 else "",
                         "+int8t" if args.int8_target else "",
                         "+int8kv" if args.int8_kv else ""])

    if args.arrival_rates:
        b = int(args.sizes.split(",")[0])
        rows = []
        for rate in [float(x) for x in args.arrival_rates.split(",")]:
            row = arrival_bench(model, b, args.new_tokens, rate, args.requests,
                                no_ladder=args.no_ladder)
            row.pop("tokens")
            row["mode"] = "arrival" + quant_tag + ("+noladder" if args.no_ladder else "")
            rows.append(row)
            print(json.dumps(row), flush=True)
        return rows

    rng = np.random.default_rng(0)
    rows = []
    base_tps = None
    for b in [int(x) for x in args.sizes.split(",")]:
        if args.engine:
            prompts = [rng.integers(10, 31990, 100).tolist() for _ in range(2 * b)]
            eng = model.serving_engine(batch_size=b, max_new_tokens=args.new_tokens)
            eng.run_all(prompts)  # warm: a full run admits mid-flight too
            _wait(model)
            t0 = time.perf_counter()
            outs = eng.run_all(prompts)
            _wait(model)
            dt = time.perf_counter() - t0
            toks = sum(len(o) for o in outs)
        else:
            reqs = [{"input_ids": rng.integers(10, 31990, 100).tolist()} for _ in range(b)]
            model.specgenerate_batch(reqs, max_new_tokens=args.new_tokens)  # warm
            _wait(model)
            t0 = time.perf_counter()
            results = model.specgenerate_batch(reqs, max_new_tokens=args.new_tokens)
            _wait(model)
            dt = time.perf_counter() - t0
            toks = sum(r.new_tokens for r in results)
        tps = toks / dt
        if base_tps is None:
            base_tps = tps
        rows.append(dict(batch=b, tokens_per_s=round(tps, 1),
                         scaling_vs_b1=round(tps / base_tps, 2), wall_s=round(dt, 3),
                         tokens=toks, mode=("engine" if args.engine else "fixed") + quant_tag))
        if args.engine:
            rows[-1]["admissions"] = eng.stats["admissions"]
            rows[-1]["admit_dispatch_s"] = round(eng.stats["admit_dispatch_s"], 3)
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
