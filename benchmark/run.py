"""Run one cell of the benchmark once and print its result as the last line
of standard output.

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
the same window under the device profiler and reports the per-layer
metrics, the device's busy time and a breakdown.  Every run checks the
served tokens against the configuration's plain reference (``correct``)
and prints each compared number beside its limit as its last lines on
standard error and under the result's last key, ``check``.

A run needs as many CUDA cards as the cell names; it exits non-zero and
prints no result without them, or when JAX, Flax or the JAX package
(``vispec_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vispec_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``vispec_tpu_torch`` is not ``vispec_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import cell as cell_mod
    from benchmark.lib import dist, manifest

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        return dist.run_ranks(args, cell, T_PROCESS0, forbidden_modules)
    res = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                            T_PROCESS0)
    return finish(cell, res, args, "cuda:0", 1)


def finish(cell, res, args, device, chips) -> int:
    """Print the diagnostics line, the check lines and the result line,
    unless a forbidden module was loaded."""
    from benchmark.lib import cell as cell_mod

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the result's process: {bad}", file=sys.stderr)
        return 3
    line = cell_mod.result_line(cell, res, bool(args.trace), device, chips)
    print(json.dumps({"diagnostics": cell_mod.diagnostics(res)}, default=str), flush=True)
    for text in res["verdict"].lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
