"""The device trace of a traced window (``--trace 1``).

After ``chip_smoke.py``'s ``_profile``: torch.profiler records the card's
kernels over the window; busy time is the union of their intervals without
NCCL's (a collective's kernel waits on its peer inside the kernel), idle is
the rest of the window, and the port's attention launches seen in the trace
must equal the launches its wrappers counted, or the trace lost events and
says nothing.  The window cannot be run again, so a trace that fails this
check is reported as lost (its readers return nothing).

Only CUDA activity is recorded, and the events are read from the
profiler's raw results rather than its per-event Python objects: a
window of some hundreds of rounds holds millions of launches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ATTENTION_KERNELS = ("partial_kernel", "combine_kernel")  # the port's verify attention
CALL_KERNEL = "partial_kernel"  # launched once a wrapper call (the combine only at D = 16)


def attention_launches() -> int:
    """Launches the port's verify-attention wrappers have counted."""
    from vispec_tpu_torch.ops import verify_attention as va

    return (va.verify_attention.launches + va.verify_attention.launches_int8
            + va.verify_attention_batched.launches
            + va.verify_attention_batched.launches_int8)


@dataclass
class Trace:
    """What the window's device trace says."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, device seconds)
    attention_s: float
    attention_launches: int
    counted_launches: int
    intervals: Optional[np.ndarray] = None  # merged busy [start, end] s from window start
    lost: bool = False
    notes: List[str] = field(default_factory=list)

    def top_kernels(self, n: int = 10) -> List[list]:
        items = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:96], s] for name, (_, s) in items]


class WindowTrace:
    """Start before the window's clock, stop at its close."""

    def __init__(self):
        self.prof = None
        self.count0 = 0
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.count0 = attention_launches()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.stop()
        self.counted = attention_launches() - self.count0

    def reduce(self, epoch0_ns: int, window_s: float) -> Trace:
        """Kernel totals, busy time and merged busy intervals of the part
        of the trace inside [window start, window start + window_s]."""
        from torch.autograd import DeviceType

        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                names.append(e.name())
                starts.append(e.start_ns())
                ends.append(e.start_ns() + e.duration_ns())
        st = (np.asarray(starts, np.float64) - epoch0_ns) / 1e9
        en = (np.asarray(ends, np.float64) - epoch0_ns) / 1e9
        keep = (en > 0) & (st < window_s)
        kernels: Dict[str, List[float]] = {}
        comm = np.zeros(len(names), bool)
        for i, name in enumerate(names):
            if not keep[i]:
                continue
            low = name.lower()
            if "nccl" in low:
                comm[i] = True
                continue
            c = kernels.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += float(min(en[i], window_s) - max(st[i], 0.0))
        sel = keep & ~comm
        merged = merge(np.clip(st[sel], 0, window_s), np.clip(en[sel], 0, window_s))
        busy = float((merged[:, 1] - merged[:, 0]).sum()) if len(merged) else 0.0
        att = [(c, s) for n, (c, s) in kernels.items()
               if any(k in n for k in ATTENTION_KERNELS)]
        launches = sum(c for n, (c, _) in kernels.items() if CALL_KERNEL in n)
        t = Trace(window_s=window_s, busy_s=busy,
                  kernels={k: (int(c), s) for k, (c, s) in kernels.items()},
                  attention_s=sum(s for _, s in att), attention_launches=launches,
                  counted_launches=self.counted, intervals=merged)
        if launches != self.counted or not kernels:
            t.lost = True
            t.notes.append(f"trace lost events: {launches} attention launches traced, "
                           f"{self.counted} counted by the wrappers, {len(kernels)} kernels")
        self.trace = t
        self.prof = None
        return t


def merge(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Union of [start, end] intervals as sorted disjoint [n, 2] rows."""
    if len(starts) == 0:
        return np.zeros((0, 2))
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1)
    return np.stack([s[first], e[last]], axis=1)


def idle_gaps(intervals: np.ndarray, window_s: float, steps, start_s: float = 0.0
              ) -> List[list]:
    """Idle device time by what the host was doing: inside a step that
    admitted a request, inside a decode-only step, or between steps (the
    harness's own bookkeeping and the open loop's waits); then the longest
    single gaps.  ``steps`` are the window's step records, their times
    ``start_s`` ahead of the trace's."""
    if intervals is None:
        return []
    bounds = np.concatenate([[0.0], intervals.ravel(), [window_s]]).reshape(-1, 2)
    gaps = [(a, b) for a, b in bounds if b > a]
    spans = [(s.t0 - start_s, s.t1 - start_s, any(adm for *_, adm in s.live))
             for s in steps]
    starts = np.array([a for a, _, _ in spans]) if spans else np.zeros(0)
    totals: Dict[str, float] = {}
    longest: List[Tuple[float, str]] = []
    for a, b in gaps:
        mid = (a + b) / 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        if j >= 0 and mid <= spans[j][1]:
            what = "host in an admitting step" if spans[j][2] else "host in a decode step"
        else:
            what = "host between steps"
        totals[what] = totals.get(what, 0.0) + (b - a)
        longest.append((b - a, what))
    longest.sort(reverse=True)
    out = [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
    out += [[f"longest gap: {w}", d] for d, w in longest[: 10 - len(out)]]
    return out
