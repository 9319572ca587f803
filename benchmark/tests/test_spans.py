"""The join of the program's spans to the window (``lib/spans.py``) on
synthetic spans and busy intervals, its clock check, and a traced run of
the tiny image cell on the CPU through the readers built on it."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import cell as cell_mod  # noqa: E402
from benchmark.lib import spans  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from vispec_tpu_torch.utils import profiling  # noqa: E402

E0 = 10**18  # the window's epoch0_ns


def _span(name, t0, t1, parent=-1, rid=None):
    return profiling.Span(name, E0 + int(t0 * 1e9), None if t1 is None else E0 + int(t1 * 1e9),
                          parent, rid)


# two steps: the first admits request 7 (its tower inside) and runs two
# rounds (a draft pass inside each); the second runs one round
NESTED = [_span("engine.step", 1.0, 5.0),
          _span("engine.admit", 1.0, 2.0, 0, 7), _span("admit.tower", 1.2, 1.6, 1, 7),
          _span("engine.round", 2.0, 3.0, 0), _span("round.draft", 2.5, 2.9, 3),
          _span("engine.round", 3.0, 4.0, 0), _span("round.draft", 3.5, 3.9, 5),
          _span("engine.step", 6.0, 7.0),
          _span("engine.round", 6.0, 7.0, 7), _span("round.draft", 6.5, 6.9, 8)]
WAITS = [_span("engine.queue", 0.5, 1.0, rid=7), _span("engine.queue", 6.5, None, rid=9)]


def _spans():
    return spans.Spans.build(NESTED, WAITS, E0)


def test_each_launch_goes_to_its_innermost_span():
    sp = _spans()
    launches = np.array([0.5, 1.1, 1.3, 2.2, 2.6, 3.0, 3.85, 4.5, 5.5, 6.7])
    assert sp.innermost(launches).tolist() == [-1, 1, 2, 3, 4, 5, 6, 0, -1, 9]
    tower, rounds = sp.within(spans.TOWER), sp.within(spans.ROUND)
    assert np.nonzero(sp.within(spans.ADMIT))[0].tolist() == [1, 2]
    assert np.nonzero(rounds)[0].tolist() == [3, 4, 5, 6, 8, 9]
    assert np.nonzero(tower)[0].tolist() == [2]
    assert sp.host_s(spans.ROUND) == (pytest.approx(3.0), 3)


def test_idle_time_is_split_by_overlap_with_the_spans():
    """Idle stretches that cross span boundaries go to each span by the
    part they overlap, whatever their midpoints."""
    sp = _spans()
    busy = np.array([[0.0, 1.1], [1.5, 2.4], [3.2, 6.2], [6.8, 8.0]])
    # idle: 1.1-1.5 (admit, tower 1.2-1.5), 2.4-3.2 (rounds: 2.4-3.0, 3.0-3.2),
    # 6.2-6.8 (round); every idle second of the window falls inside a step
    assert sp.idle_s(busy, 8.0, spans.ADMIT) == pytest.approx(0.4)
    assert sp.idle_s(busy, 8.0, spans.TOWER) == pytest.approx(0.3)
    assert sp.idle_s(busy, 8.0, spans.ROUND) == pytest.approx(0.8 + 0.6)
    assert sp.idle_s(busy, 8.0, spans.DRAFT) == pytest.approx(0.4 + 0.3)
    assert sp.idle_s(busy, 8.0, spans.STEP) == pytest.approx(0.4 + 0.8 + 0.6)
    assert sp.idle_s(np.zeros((0, 2)), 8.0, spans.ROUND) == pytest.approx(3.0)


def test_queue_waits_and_the_clock_check():
    sp = _spans()
    window = SimpleNamespace(counted={7: True, 9: True, 11: True}, window_s=8.0)
    assert sp.queue_waits_ms(window) == pytest.approx([500.0, 1500.0])  # 9 waits to the close

    def step(t0, t1):
        return SimpleNamespace(t0=t0 + 100.0, t1=t1 + 100.0)

    steps = [step(0.9995, 5.0005), step(5.9995, 7.0)]
    assert sp.aligned(steps, 100.0)
    assert not sp.aligned(steps + [step(8.0, 9.0)], 100.0)  # a step with no span: 2 of 3
    assert not sp.aligned([step(1.01, 5.0), steps[1]], 100.0)  # 10 ms off


@pytest.fixture(scope="module")
def traced_tiny_image(tmp_path_factory):
    """One traced window of the tiny image cell on the CPU: with no card,
    the harness's profiler records the host's ops and its stop has no
    device to wait for."""
    man = tiny.tree(tmp_path_factory.mktemp("spans"))
    c = tiny.load(man, "tiny-vl.image")
    real = torch.profiler.profile
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.profiler, "profile",
               lambda activities: real(activities=[torch.profiler.ProfilerActivity.CPU]))
    mp.setattr(torch.cuda, "synchronize", lambda *a: None)
    try:
        res = cell_mod.run_cell(c, 2**31 + 7, 4.0, True, "cpu", 0.0, drain_s=5.0)
    finally:
        mp.undo()
    return c, res


def test_a_traced_cpu_run_reads_the_spans_and_no_device_time(traced_tiny_image):
    c, res = traced_tiny_image
    line = cell_mod.result_line(c, res, True, "cpu", 1)
    got = line["metrics"]
    assert line["correct"], line["check"]
    assert res["run"].trace.lost  # no kernels on the CPU
    assert got["dispatch_ms.image"]["value"] > 0
    assert got["queue_wait_p90_ms.image"]["value"] >= 0
    for name in ("idle_dispatch_share.image", "idle_admit_share.image",
                 "device_idle.image", "attn_roofline.image"):
        assert name not in got
    sp = spans.of(res["run"])
    rounds = sum(s.rounds for s in res["run"].steps())
    assert sp.host_s(spans.ROUND)[1] == rounds


def test_a_program_without_the_recorder_gives_nothing(traced_tiny_image, monkeypatch):
    """The parent program has no ``SPANS``: every reader built on it
    returns None and the run's line leaves its metrics out."""
    c, res = traced_tiny_image
    monkeypatch.delattr(profiling, "SPANS")
    got = cell_mod.result_line(c, res, True, "cpu", 1)["metrics"]
    assert spans.of(res["run"]) is None
    assert not any(k.startswith(("dispatch_ms", "queue_wait", "idle_")) for k in got)
    assert "round_ms.image" in got
