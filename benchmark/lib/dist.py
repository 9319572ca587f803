"""Cells on several cards: one rank process per card, the model sharded by
the configuration's ``mesh`` (``SpecModel.shard_over``), every rank making
the same calls (SPMD), rank 0 deciding each move of the window and
printing the result.

``run.py`` starts the ranks as ``python -m benchmark.lib.dist ...`` over
``tcp://localhost:<free port>`` (NCCL on the cards) and prints rank 0's
result line as its own.  The same entry over gloo on the CPU
(``--device cpu``) is the rehearsal the tests run.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


class Ranks:
    """SPMD moves: rank 0 computes each one and every rank receives it."""

    def __init__(self, rank: int, world: int, mesh):
        self.rank, self.world, self.mesh = rank, world, mesh

    def decide(self, move):
        import torch.distributed as dist

        box = [move() if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_command(manifest: str, workload: str, seed: int, seconds: float, trace: int,
                 rank: int, world: int, init: str, device: str, t0: float) -> list:
    return [sys.executable, "-m", "benchmark.lib.dist", "--manifest", manifest,
            "--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace), "--rank", str(rank), "--world", str(world),
            "--init", init, "--device", device, "--t0", repr(t0)]


def start(manifest: str, workload: str, seed: int, seconds: float, trace: int, world: int,
          device: str, t0: float, timeout_s: float = 900.0):
    """Run every rank; returns (rank 0's exit code, its standard output)."""
    init = f"tcp://localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        rank_command(manifest, workload, seed, seconds, trace, r, world, init, device, t0),
        cwd=ROOT, env=env, stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
        text=True) for r in range(world)]
    try:
        out, _ = procs[0].communicate(timeout=timeout_s)
        for p in procs[1:]:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [p.returncode for p in procs if p.returncode]
    return (bad[0] if bad else 0), out


def run_ranks(args, cell, t0: float, forbidden) -> int:
    """``run.py``'s path for a cell on several cards."""
    code, out = start(str(ROOT / "BENCHMARK.json"), cell.name, args.seed, args.seconds,
                      args.trace, cell.chips, "cuda", t0)
    bad = forbidden()
    if bad:
        print(f"forbidden modules loaded in the result's process: {bad}", file=sys.stderr)
        return 3
    if code:
        return code
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


def rank_main(argv=None) -> int:
    p = argparse.ArgumentParser()
    for flag in ("--manifest", "--workload", "--init", "--device"):
        p.add_argument(flag, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--t0", type=float, default=None)
    a = p.parse_args(argv)
    t0 = a.t0 if a.t0 is not None else time.perf_counter()
    import torch
    import torch.distributed as dist

    from benchmark import run
    from benchmark.lib import cell as cell_mod
    from benchmark.lib import manifest
    from vispec_tpu_torch.parallel import mesh as mesh_mod
    from vispec_tpu_torch.parallel import multihost

    man = Path(a.manifest)
    cell = manifest.load_cell(a.workload, man, man.parent / "benchmark")
    device = f"cuda:{a.rank}" if a.device == "cuda" else a.device
    if a.device == "cuda":
        torch.cuda.set_device(a.rank)
    multihost.init_distributed(init_method=a.init, num_processes=a.world, process_id=a.rank)
    try:
        mesh = mesh_mod.make_mesh(**cell.config.get("mesh", {"tp": a.world}),
                                  device=a.device)
        spmd = Ranks(a.rank, a.world, mesh)
        res = cell_mod.run_cell(cell, a.seed, a.seconds, bool(a.trace), device, t0,
                                spmd=spmd)
        peaks = [None] * a.world
        dist.all_gather_object(peaks, res["peak"])
        res["peak"] = max(peaks)
        trace = res["run"].trace
        busy = [None] * a.world
        dist.all_gather_object(busy, None if trace is None else trace.busy_s)
        if trace is not None:  # the device's busy time averaged over the cards
            trace.busy_s = sum(busy) / len(busy)
        if a.rank != 0:
            return 0
        args = argparse.Namespace(trace=a.trace)
        return run.finish(cell, res, args, device, a.world)
    finally:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(rank_main())
