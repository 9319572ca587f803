"""Readings for a cell's correctness limits: in one process, for each seed,
one run of the cell as the benchmark makes it (the timed path at the
cell's load), then the reference over its sample and the fp8 control in
the program's place over the same prompts and tokens, held to the cell's
limits by the harness's own comparison.  Prints one JSON line a seed: the
program's verdict and numbers, the control's (its ``correct`` should be
false), and every sampled request's widest and median gap on both sides.

  python3 benchmark/tools/control.py --workload <name> --seconds <s> --seeds 11 12 13

``--fault <name>`` plants one of ``benchmark/tests/faults.py``'s faults
under the timed path first (the program's ``correct`` should be false);
``--witness`` also reads the reference's two bfloat16 witnesses.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--witness", action="store_true",
                   help="also the reference with bfloat16 products (bf16) and with "
                        "bfloat16 activations too (bf16act) over the same tokens")
    a = p.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from benchmark.lib import cell as cell_mod
    from benchmark.lib import check, manifest
    from benchmark.tests.faults import FAULTS

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if a.fault:
        FAULTS[a.fault](setattr)
    cell = manifest.load_cell(a.workload)

    def per_request(positions):
        return {str(i): [float(np.max(g)), float(np.median(g)), int(g.size)]
                for i, g in positions.items()}

    for seed in a.seeds:
        t0 = time.perf_counter()
        res = cell_mod.run_cell(cell, seed, a.seconds, False, "cuda:0", t0, control="fp8")
        v = res["verdict"]
        witness = {}
        if a.witness:
            ref = cell.module("reference")
            w = ref.make_weights(cell.config, seed, "cuda:0")
            inputs = res["run"].inputs
            for mode in ("bf16", "bf16act"):
                pos = {i: ref.gaps(cell.config, w, inputs[i], res["served"][i],
                                   control=mode)[1]
                       for i in v.sample if len(res["served"][i])}
                witness[mode] = {"numbers": check.gap_numbers(pos),
                                 "requests": per_request(pos)}
            del w
            torch.cuda.empty_cache()
        metrics = cell_mod.metrics_of(res["run"], cell.end_to_end)
        cv = v.control_verdict
        print(json.dumps({
            "workload": a.workload, "seed": seed, "fault": a.fault,
            "correct": v.correct, "numbers": v.numbers,
            "control_correct": cv.correct, "control_numbers": cv.numbers,
            "requests": per_request(v.positions),
            "control_requests": per_request(v.control_positions),
            "witness": witness, "check_s": v.seconds,
            "metrics": {k: m["value"] for k, m in metrics.items()},
            "diagnostics": {k: val for k, val in cell_mod.diagnostics(res).items()
                            if k in ("submitted", "completed_in_window", "rounds",
                                     "tokens_per_s", "admissions", "failure",
                                     "first_request_error")}}), flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
