"""``graph_share``'s reader on synthetic spans: rounds inside and outside
the window, replayed or eager, and a program that records no replay."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import spans  # noqa: E402
from benchmark.metrics import graph_share  # noqa: E402
from vispec_tpu_torch.utils import profiling  # noqa: E402

E0 = 10**18  # the window's epoch0_ns
WINDOW_S = 10.0


def _span(name, t0, t1, parent=-1):
    return profiling.Span(name, E0 + int(t0 * 1e9), E0 + int(t1 * 1e9), parent, None)


def _run(nested):
    steps = [SimpleNamespace(t0=s.start_ns / 1e9 - E0 / 1e9, t1=s.end_ns / 1e9 - E0 / 1e9)
             for s in nested if s.name == spans.STEP]
    window = SimpleNamespace(epoch0_ns=E0, start_s=0.0, window_s=WINDOW_S)
    return SimpleNamespace(window=window, steps=lambda: steps)


def _rounds(step_t0, replayed, first):
    """One step holding a round a second, each replayed or not; spans
    indexed from ``first``."""
    out = [_span(spans.STEP, step_t0, step_t0 + len(replayed))]
    for j, rep in enumerate(replayed):
        out.append(_span(spans.ROUND, step_t0 + j, step_t0 + j + 0.9, first))
        if rep:
            out.append(_span(graph_share.REPLAY, step_t0 + j + 0.1, step_t0 + j + 0.8,
                             first + len(out) - 1))
        else:
            out.append(_span(spans.DRAFT, step_t0 + j + 0.1, step_t0 + j + 0.8,
                             first + len(out) - 1))
    return out


@pytest.mark.parametrize("case,want", [
    # before the window: an eager chunk (its rounds do not count); inside it
    # three of four rounds replayed; two rounds start past the close
    ("mixed", 75.0),
    ("all", 100.0),
    ("none", None),  # a program that records no replay gives nothing
])
def test_graph_share_counts_the_windows_replayed_rounds(monkeypatch, case, want):
    inside = {"mixed": [True, True, False, True], "all": [True] * 4,
              "none": [False] * 4}[case]
    nested = _rounds(-3.0, [False, False], 0)
    nested += _rounds(1.0, inside, len(nested))
    nested += _rounds(10.2, [case == "all", False], len(nested))
    monkeypatch.setattr(spans, "record", lambda: (nested, []))
    got = graph_share.read(_run(nested))
    assert got == (None if want is None else pytest.approx(want))
