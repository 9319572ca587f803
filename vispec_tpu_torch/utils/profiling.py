"""Profiling helpers: a device-synchronized timer, a ``torch.profiler``
trace around a block, the serving engine's host spans, and the card's
memory statistics.

The JAX package brackets its timer with ``block_until_ready`` and traces
with ``jax.profiler``; here the timer synchronizes CUDA on both sides of
the block and the trace is a Chrome trace of ``torch.profiler``.

The span recorder (``SPANS``) is on exactly while a ``torch.profiler``
session records, which torch flags in ``_is_profiler_enabled`` "for fast
python checks": with no session, a span site reads that one flag and does
nothing else (no allocation, no CUDA event, no profiler range, no
synchronization).  Nothing is emitted into the profiler's own events: a
reader joins the spans to the device trace by the host time of each
kernel's launch record.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """``with Timer("verify", sync_on="cuda"):`` — wall time of the block
    with the device's queued work finished on both sides (``sync_on`` a
    device, or None for no synchronization)."""

    def __init__(self, name: str, sync_on=None, silent: bool = False):
        self.name = name
        self.sync_on = sync_on
        self.silent = silent
        self.elapsed = 0.0

    def __enter__(self):
        _sync(self.sync_on)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.sync_on)
        self.elapsed = time.perf_counter() - self.start
        if not self.silent:
            print(f"{self.name} took {self.elapsed:.6f} seconds")


class Span(NamedTuple):
    """One span on the profiler's clock (unix-epoch ns): ``end_ns`` None
    while it is open; ``parent`` the index of the span open around it (-1
    for none); ``rid`` the engine's request id, or None."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: int
    rid: Optional[int]


class SpanRecorder:
    """Host spans kept in memory as [name, start, end, parent, rid] with
    ``perf_counter_ns`` stamps.  Nested spans (``span``) follow one
    thread's stack; a waiting span (``start`` / ``stop``, keyed by name
    and request id) opens and closes at two separate sites, may overlap
    any other, and is kept apart.  One (``time_ns``, ``perf_counter_ns``)
    pair, taken at the first span of a record, converts the stamps to the
    profiler's clock."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self.spans: List[list] = []
        self.waits: List[list] = []
        self._stack: List[int] = []
        self._waiting = {}  # (name, rid) -> index of the open waiting span
        self.anchor: Optional[tuple] = None

    def _stamp(self) -> int:
        if self.anchor is None:
            self.anchor = (time.time_ns(), time.perf_counter_ns())
        return time.perf_counter_ns()

    def open(self, name: str, rid=None) -> int:
        parent = self._stack[-1] if self._stack else -1
        if rid is None and parent >= 0:
            rid = self.spans[parent][4]  # a span inside a request's span is the request's
        self.spans.append([name, self._stamp(), None, parent, rid])
        self._stack.append(len(self.spans) - 1)
        return len(self.spans) - 1

    def close(self, i: int) -> None:
        self.spans[i][2] = time.perf_counter_ns()
        self._stack.pop()

    def start(self, name: str, rid) -> None:
        self._waiting[(name, rid)] = len(self.waits)
        self.waits.append([name, self._stamp(), None, -1, rid])

    def stop(self, name: str, rid) -> None:
        i = self._waiting.pop((name, rid), None)
        if i is not None:
            self.waits[i][2] = time.perf_counter_ns()

    def records(self, waits: bool = False) -> List[Span]:
        """The nested spans (or with ``waits`` the waiting spans) on the
        profiler's clock."""
        if self.anchor is None:
            return []
        shift = self.anchor[0] - self.anchor[1]
        return [Span(n, t0 + shift, None if t1 is None else t1 + shift, p, r)
                for n, t0, t1, p, r in (self.waits if waits else self.spans)]

    def chrome_events(self, base_ns: int, pid: int) -> List[dict]:
        """The closed spans as Chrome trace events over ``base_ns`` (the
        trace's ``baseTimeNanoseconds``): nested spans as "X" events on a
        thread row of their own, waiting spans as async events of their
        request."""
        tid = "vispec_tpu_torch spans"
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tid}}]
        for waits in (False, True):
            for s in self.records(waits):
                if s.end_ns is None:
                    continue
                ev = {"cat": "engine", "name": s.name, "pid": pid, "tid": tid,
                      "ts": (s.start_ns - base_ns) / 1e3,
                      "args": {} if s.rid is None else {"rid": s.rid}}
                dur = (s.end_ns - s.start_ns) / 1e3
                if waits:
                    out += [dict(ev, ph="b", id=s.rid),
                            dict(ev, ph="e", id=s.rid, ts=ev["ts"] + dur)]
                else:
                    out.append(dict(ev, ph="X", dur=dur))
        return out


SPANS = SpanRecorder()


class _Open:
    __slots__ = ("i",)

    def __init__(self, name: str, rid):
        self.i = SPANS.open(name, rid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        SPANS.close(self.i)


_OFF = contextlib.nullcontext()


def span(name: str, rid=None):
    """``with span("engine.round"):`` records the block while a profiler
    session records; otherwise the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, rid)


def start(name: str, rid) -> None:
    """Open request ``rid``'s waiting span ``name`` while a session records."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.start(name, rid)


def stop(name: str, rid) -> None:
    """Close request ``rid``'s waiting span ``name`` while a session records."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.stop(name, rid)


@contextlib.contextmanager
def trace(logdir: str = "build/trace"):
    """Capture a ``torch.profiler`` trace of the block (the host's ops, and
    the card's kernels when there is one) into ``logdir/trace.json`` (open
    it in Perfetto or chrome://tracing), with the serving engine's spans
    on a row of their own; yields the profiler, whose ``key_averages()``
    sums them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    SPANS.clear()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += SPANS.chrome_events(doc.get("baseTimeNanoseconds", 0), os.getpid())
    with open(path, "w") as f:
        json.dump(doc, f)


def device_memory_stats(device="cuda") -> dict:
    """``torch.cuda.memory_stats`` of the device; empty without CUDA."""
    if not torch.cuda.is_available() or torch.device(device).type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
