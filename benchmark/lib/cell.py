"""One run of one cell: weights and inputs from the seed, the program built
over them, the cell's shapes warmed, the window, the check, the metrics.

Set-up is everything from the process start to the window's first
request: imports, the kernel libraries (built once into the checkout's
``build/kernels/`` by the program and loaded after that), weights made on
the card, inputs, and one warm-up session over every prompt bucket and
image size the cell's traffic sends.
"""

from __future__ import annotations

import gc
import math
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, flops, manifest, requests, stats, traffic
from .driver import OneProcess, Window, run_window
from .profile import Trace, WindowTrace, idle_gaps


@dataclass
class Run:
    """What a metric's reader reads."""

    cell: manifest.Cell
    plan: traffic.Plan
    inputs: List[requests.Input]
    window: Window
    setup_s: float
    trace: Optional[Trace] = None

    # -- spans and counts over the window's steps ------------------------
    def steps(self):
        return self.window.window_steps

    def _dims(self):
        cfg = self.cell.config
        return flops.Dims.of(cfg), flops.Dims.of(cfg["draft"], layers=1), cfg["spec"]

    def _lens(self, rid: int, tokens_before: int):
        inp = self.inputs[self.window.index[rid]]
        target = inp.prompt_len + max(tokens_before - 1, 0)
        return target, target - inp.image_tokens

    def window_flops(self) -> float:
        """Model operations the window's steps needed: admissions' prefills
        (and the tower over their images), every live slot's rounds."""
        t, dr, spec = self._dims()
        vc = self.cell.config.get("vision_config")
        total = 0.0
        for s in self.steps():
            live = []
            for rid, before, acc, admitted in s.live:
                inp = self.inputs[self.window.index[rid]]
                if admitted:
                    total += flops.prefill_flops(t, dr, inp.prompt_len,
                                                 inp.prompt_len - inp.image_tokens,
                                                 spec["top_k"], spec["depth"])
                    if inp.image is not None:
                        total += flops.tower_flops(vc, inp.image_tokens * unit(vc))
                live.append((*self._lens(rid, before), acc))
            total += flops.sum_rounds(
                lambda tl, dl, a: flops.round_flops(t, dr, spec["total_tokens"],
                                                    spec["depth"], spec["top_k"], tl, dl, a),
                live)
        return total

    def attention_bound_s(self) -> float:
        """Roofline seconds of the window's verify-attention calls."""
        t, dr, spec = self._dims()
        total = 0.0
        for s in self.steps():
            live = []
            for rid, before, acc, admitted in s.live:
                inp = self.inputs[self.window.index[rid]]
                if admitted:
                    total += flops.expansion_attention_bound_s(
                        dr, inp.prompt_len - inp.image_tokens, spec["top_k"], spec["depth"])
                live.append((*self._lens(rid, before), acc))
            total += flops.sum_rounds(
                lambda tl, dl, a: flops.round_attention_bound_s(
                    t, dr, spec["total_tokens"], spec["depth"], spec["top_k"], tl, dl, a),
                live)
        return total


def unit(vc: dict) -> int:
    return vc["spatial_merge_size"] ** 2


def warm_requests(cell: manifest.Cell) -> List[traffic.Request]:
    """One short request for every (image size, prompt bucket) the traffic
    can send: the longest text that still lands in each bucket."""
    mix, cfg = cell.traffic, cell.config
    spec = mix["prompt"]["text_tokens"]
    tmin, tmax = int(spec.get("min", spec.get("value", 1))), int(spec.get("max", spec.get(
        "value", 1)))
    buckets = cell.settings["engine"]["pad_bucket"]
    images = [tuple(s["size"]) for s in mix["prompt"].get("images", [])] or [None]
    cap = 2 * engine_settings(cell)["chunk_rounds"] + 1  # every chunk size of the ladder
    out = []
    for img in images:
        base = requests.image_tokens(cfg, img) + 2 if img else 0
        for j, b in enumerate(buckets):
            lo = buckets[j - 1] if j else 0
            t = min(tmax, b - 1 - base)
            if t >= tmin and base + t >= lo:
                out.append(traffic.Request(len(out), t, cap, img))
    return out


def engine_settings(cell: manifest.Cell) -> dict:
    """The engine's keyword arguments: the configuration's ``serve`` slots
    and the cell's ``engine`` settings (the chunk, the pad buckets, the
    span), each set in one place."""
    engine = cell.settings["engine"]
    if "batch_size" in engine:
        raise ValueError(f"{cell.name}: the slots are the configuration's serve.batch_size")
    return {"batch_size": cell.config["serve"]["batch_size"], **engine}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell: manifest.Cell, seed: int, device, spmd=None):
    """Weights from the seed, the program built over them, its engine with
    the cell's settings, and the warm-up session; returns (model, engine,
    the warm-up's failure or None)."""
    cfg = cell.config
    prog = cell.module("program")
    dev = torch.device(device)
    weights = cell.module("reference").make_weights(cfg, seed, dev)
    model = prog.build(cfg, weights, dev, getattr(spmd, "mesh", None))
    del weights
    cap = int(cell.traffic["output"].get("max", cell.traffic["output"].get("value", 1)))
    engine = model.serving_engine(max_new_tokens=cap, **engine_settings(cell))
    warm = requests.make_inputs(cfg, warm_requests(cell), seed + 1, dev)
    engine.start_session()
    try:
        for w in warm:
            prog.submit(engine, w)
        while engine.pending():
            engine.step()
    except Exception:  # the program failed on the cell's own shapes: not correct
        return model, engine, "warm-up: " + traceback.format_exc(limit=6)
    return model, engine, None


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             t_process0: float, spmd=None, control=None, drain_s: float = 60.0) -> dict:
    """One run: set-up, the window, the check.  ``control`` ("fp8") also
    runs the control over the sample (the tools do; the benchmark's own
    runs never do)."""
    spmd = spmd or OneProcess()
    cfg, settings = cell.config, cell.settings
    ref = cell.module("reference")
    prog = cell.module("program")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the allocator exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    model, engine, failed = prepare(cell, seed, dev, spmd)
    plan = traffic.plan(cell.traffic, seconds)
    inputs = requests.make_inputs(cfg, plan.requests, seed, dev)

    tracer = WindowTrace() if trace and not failed else None
    if failed:
        win = Window(seconds=seconds, failure=failed, perf0=time.perf_counter())
    else:
        win = run_window(engine, plan, lambda e, i: prog.submit(e, inputs[i]), seconds,
                         spmd=spmd, before_start=tracer.start if tracer else None,
                         at_close=tracer.stop if tracer else None,
                         sync=lambda: sync(dev), drain_s=drain_s)
    setup_s = win.perf0 - t_process0
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr = tracer.reduce(win.epoch0_ns, win.window_s) if tracer else None

    served = {win.index[rid]: np.asarray(engine.results[rid])
              for rid, t in win.timelines.items() if rid in engine.results}
    errors = len(engine.errors)
    first_error = next(iter(engine.errors.values()), None)
    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(cell, plan, inputs, win, setup_s, tr)
    lim = settings["check"]
    verdict = check.Verdict(correct=True)
    if spmd.rank == 0:
        sample = check.choose_sample(served, seed, int(lim["sample_requests"]))
        weights = ref.make_weights(cfg, seed, dev)
        t_check = time.perf_counter()
        verdict = check.judge(ref, cfg, weights, inputs, served, sample, lim, errors,
                              win.failure, cfg["eos_token_id"], control=control)
        verdict.seconds = time.perf_counter() - t_check
        del weights
        gc.collect()
    return {"run": run, "verdict": verdict, "peak": peak, "served": served,
            "errors": errors, "first_error": first_error}


def metrics_of(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    """Each metric's reader over the run; a reader that finds nothing to
    read returns None and the metric is left out."""
    readers = manifest.metric_readers(run.cell, metrics)
    out = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(cell: manifest.Cell, res: dict, trace: bool, device, chips: int) -> dict:
    """The object of the run's last line, ``check`` last."""
    run, verdict = res["run"], res["verdict"]
    dev = torch.device(device)
    metrics = metrics_of(run, cell.per_layer if trace else cell.end_to_end)
    out = {"correct": bool(verdict.correct), "attempted": run.window.submitted_in_window,
           "failed": int(res["errors"]), "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                               else "cpu"),
                      "count": chips, "memory_peak_bytes": int(res["peak"])}}
    if trace and run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {
            "device_ops": run.trace.top_kernels(10),
            "idle_gaps": idle_gaps(run.trace.intervals, run.trace.window_s, run.steps(),
                                   run.window.start_s)}
    out["check"] = verdict.numbers
    return out


def diagnostics(res: dict) -> dict:
    """Counts printed on an earlier line: what the window did."""
    run = res["run"]
    win = run.window
    steps = run.steps()
    d = {"window_s": win.window_s, "ramp_s": win.start_s + run.plan.ramp_s,
         "drain_s": win.end_s - win.close_s, "submitted": win.submitted_in_window,
         "completed_in_window": sum(1 for t in win.timelines.values() if t.done_s is not None
                                    and win.start_s <= t.done_s <= win.close_s),
         "tokens_in_window": win.tokens_in_window,
         "tokens_per_s": win.tokens_in_window / max(win.window_s, 1e-9),
         "steps": len(steps), "rounds": sum(s.rounds for s in steps),
         "admissions": sum(1 for s in steps for *_, a in s.live if a),
         "admit_dispatch_s": sum(s.admit_s for s in steps),
         "setup_s": run.setup_s, "sample": res["verdict"].sample,
         "check_s": res["verdict"].seconds,
         "sample_widest_gaps": res["verdict"].gaps,
         "sample_median_gaps": {i: float(np.median(g))
                                for i, g in res["verdict"].positions.items()},
         "ttft_ms": {f"p{q}": stats.percentile(stats.ttft_ms(win.requests), q)
                     for q in (50, 75, 90)},
         "tpot_ms": {f"p{q}": stats.percentile(stats.tpot_ms(
             list(win.timelines.values()), win.close_s, win.start_s), q) for q in (50, 75, 90)},
         "failure": win.failure, "ran_out": win.ran_out,
         "first_request_error": res.get("first_error")}
    if run.trace is not None:
        launches = sum(c for c, _ in run.trace.kernels.values())
        d["trace_notes"] = run.trace.notes
        d["attention_launches"] = [run.trace.attention_launches,
                                   run.trace.counted_launches]
        d["kernel_launches"] = launches
        d["launches_per_round"] = launches / max(1, d["rounds"])
        d["attention_device_s"] = run.trace.attention_s
    return d
