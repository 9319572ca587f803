"""The program's own host spans over a traced window (``--trace 1``), on
the window's clock, and what they split.

While the profiler records, the port keeps spans in memory
(``vispec_tpu_torch.utils.profiling.SPANS``): ``engine.step`` around each
step; ``engine.admit`` around an admission, ``admit.tower`` inside it;
``engine.round`` around each round, ``round.draft`` inside it; and apart
from those, each request's ``engine.queue`` wait from its submission to
its admission.  Their stamps are unix-epoch ns, the clock of the
profiler's events and of the window's ``epoch0_ns``.

``of(run)`` reads them as seconds from the window's start.  A program
without the recorder gives None, and so does a record whose steps do not
line up with the harness's own step spans (fewer than 99% of the
window's steps hold a recorded ``engine.step`` within 1 ms at each end):
every reader built on them then returns None.

The joins: ``innermost`` takes a host time (a kernel's launch record) to
the innermost span that contains it; ``idle_s`` takes each stretch of the
device's idle time (the complement of the trace's merged busy intervals)
to the innermost span open during it, by overlap, split at every span's
boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

STEP, QUEUE, ADMIT, TOWER, ROUND, DRAFT = ("engine.step", "engine.queue", "engine.admit",
                                           "admit.tower", "engine.round", "round.draft")
MATCHED = 0.99  # the clock check: share of the window's steps that must line up
TOLERANCE_S = 1e-3


def record() -> Optional[tuple]:
    """(nested spans, waiting spans) of the program's recorder, each a list
    of ``profiling.Span``; None for a program that has no recorder."""
    try:
        from vispec_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "SPANS", None)
    return None if rec is None else (rec.records(), rec.records(waits=True))


@dataclass
class Spans:
    """Nested spans in the order they opened (so by start), window seconds;
    ``parent`` -1 for none.  ``waits``: rid -> (start, end) of its queue
    wait, end NaN while it still waits."""

    names: np.ndarray
    start: np.ndarray
    end: np.ndarray
    parent: np.ndarray
    waits: Dict[int, Tuple[float, float]]

    @classmethod
    def build(cls, spans: List, waits: List, epoch0_ns: int) -> "Spans":
        def sec(ns):
            return np.nan if ns is None else (ns - epoch0_ns) / 1e9

        return cls(names=np.array([s.name for s in spans], dtype=object),
                   start=np.array([sec(s.start_ns) for s in spans], np.float64),
                   end=np.array([sec(s.end_ns) for s in spans], np.float64),
                   parent=np.array([s.parent for s in spans], np.int64),
                   waits={s.rid: (sec(s.start_ns), sec(s.end_ns)) for s in waits
                          if s.name == QUEUE})

    def aligned(self, steps, start_s: float) -> bool:
        """The clock check against the harness's step records (host-clock
        seconds ``start_s`` ahead of the window's)."""
        mine = self.names == STEP
        st, en = self.start[mine], self.end[mine]
        if not steps:
            return False
        hit = 0
        for s in steps:
            t0, t1 = s.t0 - start_s, s.t1 - start_s
            i = int(np.searchsorted(st, t0 - TOLERANCE_S))
            hit += bool(i < len(st) and en[i] <= t1 + TOLERANCE_S)
        return hit >= MATCHED * len(steps)

    def within(self, name: str) -> np.ndarray:
        """Per span: it or a span around it is named ``name``."""
        named = self.names == name
        inside = named.copy()
        for _ in range(len(inside)):
            up = np.append(inside, False)[self.parent]  # parent -1 reads the False
            new = named | up
            if np.array_equal(new, inside):
                break
            inside = new
        return inside

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """Index of the innermost span with start <= t < end, -1 for none.
        Spans nest, so it is the last one opened at or before t, or one
        around it."""
        t = np.asarray(t, np.float64)
        j = np.searchsorted(self.start, t, side="right") - 1
        while True:
            ended = (j >= 0) & (self.end[np.maximum(j, 0)] <= t)
            if not ended.any():
                return j
            j = np.where(ended, self.parent[np.maximum(j, 0)], j)

    def host_s(self, name: str) -> Tuple[float, int]:
        """Host seconds inside the spans named ``name``, and their count."""
        mine = self.names == name
        return float((self.end[mine] - self.start[mine]).sum()), int(mine.sum())

    def idle_s(self, busy: np.ndarray, window_s: float, name: str) -> float:
        """Seconds of the window with no kernel on the device while the
        innermost host span open was ``name`` or a span inside one."""
        edges = np.concatenate([[0.0, window_s], busy.ravel(), self.start, self.end])
        edges = np.unique(edges[(edges >= 0.0) & (edges <= window_s)])
        a, b = edges[:-1], edges[1:]
        mid = (a + b) / 2
        idle = np.ones(len(mid), bool)
        if len(busy):
            k = np.searchsorted(busy[:, 0], mid, side="right") - 1
            idle = (k < 0) | (mid >= busy[np.maximum(k, 0), 1])
        j = self.innermost(mid)
        hit = idle & (j >= 0) & self.within(name)[np.maximum(j, 0)]
        return float((b - a)[hit].sum())

    def queue_waits_ms(self, window) -> List[float]:
        """The engine's queue wait of each of the window's requests whose
        submission was recorded; one still waiting at the window's close
        counts its wait to the close."""
        out = []
        for rid, counted in window.counted.items():
            if counted and rid in self.waits:
                t0, t1 = self.waits[rid]
                out.append(1e3 * ((window.window_s if np.isnan(t1) else t1) - t0))
        return out


def of(run) -> Optional[Spans]:
    """The run's spans, or None (no recorder, nothing recorded, or the
    record fails the clock check)."""
    rec = record()
    if rec is None or not rec[0]:
        return None
    sp = Spans.build(*rec, run.window.epoch0_ns)
    return sp if sp.aligned(run.steps(), run.window.start_s) else None


def idle_share(run, name: str) -> Optional[float]:
    """Percent of the window with the device idle inside spans ``name``;
    None without a sound trace or the spans."""
    t = run.trace
    if t is None or t.lost or t.intervals is None or t.window_s <= 0:
        return None
    sp = of(run)
    return None if sp is None else 100.0 * sp.idle_s(t.intervals, t.window_s, name) / t.window_s
