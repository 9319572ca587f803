"""The measured window: requests offered to the serving engine through its
online API (``submit`` and ``step(on_tokens=...)``), open or closed loop,
with a host-clock span around every ``step`` and each request's timeline.

The open loop follows ``evaluation/bench_batch.arrival_bench``'s pattern:
each request is submitted once its scheduled arrival has passed, the engine
steps while anything is pending, and latency counts from the scheduled
arrival, so a long admission delays every request due during it.

The traffic runs for the mix's ``ramp_s`` before the window opens, so the
window sees the engine as a steady load keeps it, not filling from empty;
the ramp's requests are not among the window's, and its tokens are not
counted.  After the close no request is submitted; the engine steps on
until every request of the window has its first token (at most
``drain_s``), so the time-to-first-token tail is over all of them.

Times are host-clock seconds from the ramp's end; the window opens at the
first step boundary after it (``start_s``).

Under several ranks (one process per card, SPMD) every rank must submit and
step alike: rank 0 decides each move from its clock and ``spmd.decide``
hands the same move to every rank.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .stats import Timeline
from .traffic import Plan


class OneProcess:
    """The moves of a single-process run: rank 0's own."""

    rank = 0
    world = 1

    def decide(self, move):
        return move()


@dataclass
class StepRecord:
    """One ``engine.step()``: its host span, the rounds it dispatched, the
    host seconds of its mid-flight admissions (``stats['admit_dispatch_s']``),
    and per live request (rid, tokens before the step, the acceptance
    lengths of its rounds in this step, whether the step admitted it)."""

    t0: float
    t1: float
    rounds: int
    admit_s: float
    live: List[Tuple[int, int, List[int], bool]]
    completed: List[int]


@dataclass
class Window:
    seconds: float
    start_s: float = 0.0  # the window opens (the first step boundary after the ramp)
    close_s: float = 0.0  # end of the last step that began before the deadline
    end_s: float = 0.0  # end of the drain
    timelines: Dict[int, Timeline] = field(default_factory=dict)
    counted: Dict[int, bool] = field(default_factory=dict)  # rid -> a request of the window
    index: Dict[int, int] = field(default_factory=dict)  # rid -> input index
    steps: List[StepRecord] = field(default_factory=list)
    tokens_in_window: int = 0
    failure: Optional[str] = None
    ran_out: bool = False  # a closed loop's clients had no request left
    perf0: float = 0.0  # perf_counter() at time 0
    epoch0_ns: int = 0  # time.time_ns() at the window's start (the profiler's clock)

    @property
    def window_s(self) -> float:
        return self.close_s - self.start_s

    @property
    def window_steps(self) -> List[StepRecord]:
        return [s for s in self.steps if self.start_s <= s.t0 < self.close_s]

    @property
    def requests(self) -> List[Timeline]:
        """The window's own requests."""
        return [t for rid, t in self.timelines.items() if self.counted[rid]]

    @property
    def submitted_in_window(self) -> int:
        return len(self.requests)


def run_window(engine, plan: Plan, submit: Callable[[object, int], int], seconds: float,
               spmd=None, before_start: Optional[Callable[[], None]] = None,
               at_close: Optional[Callable[[], None]] = None, sync=None,
               drain_s: float = 60.0) -> Window:
    """Offer ``plan``'s requests through its ramp and then ``seconds`` of
    window; ``submit(engine, index)`` submits input ``index`` and returns
    its rid.  ``before_start`` runs as the window opens (the profiler),
    ``at_close`` just after its last step; ``sync`` waits for the device."""
    spmd = spmd or OneProcess()
    win = Window(seconds=seconds)
    engine.start_session()
    if sync:
        sync()
    perf0 = time.perf_counter() + plan.ramp_s
    win.perf0 = perf0
    opened = [False]
    tokens_at_start = [0]

    def now() -> float:
        return time.perf_counter() - perf0

    def on_tokens(rid, toks) -> None:
        t = win.timelines[rid]
        at = now()
        if t.first_s is None:
            t.first_s = at
            t.first_tokens = len(toks)
        t.last_s = at
        t.tokens += len(toks)

    def do_submit(indices, at: float) -> None:
        for i in indices:
            rid = submit(engine, i)
            r = plan.requests[i]
            start = r.arrival_s if plan.loop == "open" else at
            win.timelines[rid] = Timeline(start_s=start)
            win.counted[rid] = start >= 0.0 and (plan.loop == "open" or opened[0])
            win.index[rid] = i

    def open_window() -> None:
        if sync:
            sync()
        if before_start:
            before_start()
        win.start_s = now()
        win.epoch0_ns = time.time_ns()
        tokens_at_start[0] = sum(t.tokens for t in win.timelines.values())
        opened[0] = True

    def step() -> List[int]:
        inflight = [rid for rid, t in win.timelines.items() if t.done_s is None]
        acc_before = {rid: len(engine.acceptance.get(rid, ())) for rid in inflight}
        tok_before = {rid: win.timelines[rid].tokens for rid in inflight}
        rounds0 = engine.stats["rounds"]
        admit0 = engine.stats["admit_dispatch_s"]
        t0 = now()
        completed = engine.step(on_tokens=on_tokens)
        t1 = now()
        for rid in completed:
            if rid in win.timelines:
                win.timelines[rid].done_s = t1
        live = []
        for rid in inflight:
            acc = list(engine.acceptance.get(rid, ()))[acc_before[rid]:]
            got = win.timelines[rid].tokens - tok_before[rid]
            admitted = tok_before[rid] == 0 and got > 0
            if acc or admitted:
                live.append((rid, tok_before[rid], acc, admitted))
        win.steps.append(StepRecord(t0, t1, engine.stats["rounds"] - rounds0,
                                    engine.stats["admit_dispatch_s"] - admit0, live,
                                    list(completed)))
        return completed

    reqs = plan.requests
    nxt = 0  # open loop: next arrival
    queues = [list(q) for q in plan.queues]
    if plan.loop == "closed":
        do_submit([q.pop(0) for q in queues if q], now())

    def deadline() -> float:
        return win.start_s + seconds if opened[0] else float("inf")

    def open_move():
        t = now()
        if not opened[0] and t >= 0.0:
            return ("open", [], 0.0)
        if t >= deadline():
            return ("stop", [], 0.0)
        due = []
        j = nxt
        while j < len(reqs) and reqs[j].arrival_s <= t:
            due.append(j)
            j += 1
        if due or engine.pending():
            return ("step", due, 0.0)
        wait = (reqs[j].arrival_s if j < len(reqs) else deadline()) - t
        if not opened[0]:
            wait = min(wait, -t)
        return ("sleep", [], min(wait, 1.0))

    def closed_move():
        t = now()
        if not opened[0] and t >= 0.0:
            return "open"
        if t >= deadline() or not engine.pending():
            return "stop"
        return "step"

    try:
        while True:
            if plan.loop == "open":
                kind, due, wait = spmd.decide(open_move)
                if kind == "open":
                    open_window()
                    continue
                if kind == "stop":
                    break
                if kind == "sleep":
                    time.sleep(max(0.0, wait))
                    continue
                do_submit(due, now())
                nxt += len(due)
                step()
            else:
                kind = spmd.decide(closed_move)
                if kind == "open":
                    open_window()
                    continue
                if kind == "stop":
                    win.ran_out = not engine.pending()
                    break
                completed = step()
                refill = []
                for rid in completed:
                    c = reqs[win.index[rid]].client
                    if queues[c]:
                        refill.append(queues[c].pop(0))
                do_submit(refill, now())
    except Exception:  # the engine failed: the run is not correct
        win.failure = traceback.format_exc(limit=6)
    if not opened[0]:
        open_window()
    win.close_s = now()
    if at_close:
        at_close()
    # tokens streamed by the window's steps (the drain adds later ones)
    win.tokens_in_window = sum(t.tokens for t in win.timelines.values()) - tokens_at_start[0]
    if win.failure is None:
        try:
            limit = win.close_s + drain_s
            while spmd.decide(lambda: now() < limit and engine.pending() and any(
                    t.first_s is None and t.done_s is None for t in win.requests)):
                step()
        except Exception:
            win.failure = traceback.format_exc(limit=6)
    win.end_s = now()
    return win
