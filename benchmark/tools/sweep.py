"""Find an open-loop cell's knee: one process, one model, one warm-up, then
a window at each offered rate.  A rate the system sustains keeps the
queue flat: the requests due in the window's last third wait no longer for
their first token than those of its first third, and the requests still
without a first token at the close are few.

  python3 benchmark/tools/sweep.py --workload <name> --seconds 30 --rates 0.8 1.2 1.6
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import cell as cell_mod
    from benchmark.lib import manifest, requests, stats, traffic
    from benchmark.lib.driver import run_window

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.load_cell(a.workload)
    prog = cell.module("program")
    model, engine, failed = cell_mod.prepare(cell, a.seed, "cuda:0")
    if failed:
        print(failed, file=sys.stderr)
        return 1
    for rate in a.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        plan = traffic.plan(mix, a.seconds)
        inputs = requests.make_inputs(cell.config, plan.requests, a.seed, "cuda:0")
        win = run_window(engine, plan, lambda e, i: prog.submit(e, inputs[i]), a.seconds,
                         sync=torch.cuda.synchronize, drain_s=0.0)
        tl = win.requests
        third = a.seconds / 3
        early = [t for t in tl if t.start_s < third]
        late = [t for t in tl if t.start_s >= 2 * third]
        run = cell_mod.Run(cell, plan, inputs, win, 0.0)
        print(json.dumps({
            "rate_per_s": rate, "submitted": len(tl),
            "completed_per_s": sum(1 for t in tl if t.done_s is not None) / win.window_s,
            "waiting_at_close": sum(1 for t in tl if t.first_s is None),
            "ttft_p50_ms": stats.percentile(stats.ttft_ms(tl), 50),
            "ttft_p90_ms": stats.percentile(stats.ttft_ms(tl), 90),
            "ttft_p50_first_third_ms": stats.percentile(stats.ttft_ms(early), 50),
            "ttft_p50_last_third_ms": stats.percentile(stats.ttft_ms(late), 50),
            "tpot_p90_ms": stats.percentile(stats.tpot_ms(tl, win.close_s), 90),
            "tokens_per_s": win.tokens_in_window / win.window_s,
            "round_ms": 1e3 * sum(s.t1 - s.t0 - s.admit_s for s in run.steps())
            / max(1, sum(s.rounds for s in run.steps())),
            "admissions": sum(1 for s in run.steps() for *_, adm in s.live if adm)}),
            flush=True)
        del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
