"""The serving engine's host spans (``utils/profiling.py``): nothing is
recorded without a ``torch.profiler`` session; under one, the engine's
steps, queue waits, admissions, rounds, draft passes and the vision tower
are recorded where they happen, nested as the engine runs them, on the
profiler's clock.  Torch only, float32 on the CPU, toy widths."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vispec_tpu_torch import configs
from vispec_tpu_torch.models import draft as draft_mod
from vispec_tpu_torch.models import llama
from vispec_tpu_torch.models import qwen2_5_vl as qwen
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel
from vispec_tpu_torch.utils import profiling

CPU = torch.device("cpu")
WIDTHS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=512)
SPEC = configs.SpecConfig(total_tokens=12, depth=3, top_k=4)
VISION = qwen.QwenVisionConfig(hidden_size=32, out_hidden_size=64, intermediate_size=64,
                               depth=2, num_heads=4, window_size=56,
                               fullatt_block_indexes=(1,))
IMG, VID, VSTART = 250, 251, 252
NO_EOS = 10**6


def _model(vision: bool) -> SpecModel:
    gen = torch.Generator().manual_seed(0)
    tcfg = configs.LlamaConfig(num_hidden_layers=2, qkv_bias=vision,
                               mrope_section=(2, 2, 2) if vision else None, **WIDTHS)
    dcfg = configs.DraftConfig(num_q=2, qkv_bias=vision, **WIDTHS)
    tparams = llama.init_params(tcfg, gen, CPU, torch.float32)
    dparams = draft_mod.init_params(dcfg, gen, CPU, torch.float32)
    dparams["embed"] = tparams["embed"]
    kw = {}
    if vision:
        kw = dict(qwen_cfg=VISION, vparams=qwen.init_params(gen, VISION, CPU, torch.float32),
                  image_token_index=IMG, video_token_index=VID, vision_start_token_id=VSTART,
                  min_pixels=56 * 56, max_pixels=56 * 56)
    return SpecModel(tcfg, dcfg, SPEC, tparams, dparams, max_len=256, dtype=torch.float32,
                     device=CPU, eos_token_id=NO_EOS, **kw)


@pytest.fixture(scope="module")
def text_model():
    return _model(vision=False)


def _prompts(n):
    rng = np.random.default_rng(5)
    return [rng.integers(5, 200, rng.integers(8, 24)).tolist() for _ in range(n)]


def _serve(eng, requests, new_tokens=4):
    """Submit every request, then step until dry; returns (rids, steps)."""
    eng.start_session()
    rids = [eng.submit(r, max_new_tokens=new_tokens) for r in requests]
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
    return rids, steps


def _by_name(spans, name):
    return [(i, s) for i, s in enumerate(spans) if s.name == name]


def test_without_a_session_nothing_is_recorded(text_model):
    assert profiling.span("engine.round") is profiling.span("round.draft")  # one no-op
    eng = ServingEngine(text_model, batch_size=2, max_new_tokens=8, chunk_rounds=2)
    _serve(eng, _prompts(3))
    assert eng.stats["rounds"] > 0
    assert profiling.SPANS.spans == [] and profiling.SPANS.waits == []
    assert profiling.SPANS.anchor is None


@pytest.mark.parametrize("slots", [1, 2], ids=["unit-batch", "slot-stacked"])
def test_a_session_records_the_engine_spans(text_model, slots):
    """Every step, each request's queue wait and admission, each round
    under its step, each draft pass under its round; all between the
    profiler's start and stop."""
    eng = ServingEngine(text_model, batch_size=slots, max_new_tokens=8, chunk_rounds=2)
    eng.start_session()
    t_before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rids, steps = _serve(eng, _prompts(slots + 1))
    t_after = time.time_ns()
    spans = profiling.SPANS.records()
    waits = profiling.SPANS.records(waits=True)

    step_ids = {i for i, _ in _by_name(spans, "engine.step")}
    assert len(step_ids) == steps
    assert sorted(s.rid for s in waits) == rids
    assert all(s.name == "engine.queue" and s.end_ns >= s.start_ns for s in waits)
    admits = _by_name(spans, "engine.admit")
    assert sorted(s.rid for _, s in admits) == rids
    assert all(s.parent in step_ids for _, s in admits)
    for _, a in admits:  # the queue wait ends as the admission starts
        w = next(s for s in waits if s.rid == a.rid)
        assert w.end_ns <= a.start_ns
    rounds = _by_name(spans, "engine.round")
    assert len(rounds) == eng.stats["rounds"]
    assert all(s.parent in step_ids and s.rid is None for _, s in rounds)
    drafts = _by_name(spans, "round.draft")
    assert sorted(s.parent for _, s in drafts) == [i for i, _ in rounds]
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    start = prof.profiler.kineto_results.trace_start_ns()
    assert t_before <= start
    for s in spans + waits:
        assert start <= s.start_ns and s.end_ns <= t_after
    # the next session starts from an empty record
    eng.start_session()
    assert profiling.SPANS.spans == [] and profiling.SPANS.waits == []


def test_an_image_request_records_the_tower_inside_its_admission():
    model = _model(vision=True)
    ids = (list(range(10, 20)) + [VSTART] + [IMG] * model.count_image_tokens((56, 56))
           + list(range(30, 40)))
    pixels = np.random.default_rng(1).uniform(0, 1, (56, 56, 3)).astype(np.float32)
    eng = ServingEngine(model, batch_size=2, max_new_tokens=4, chunk_rounds=2, max_span=64)
    with profile(activities=[ProfilerActivity.CPU]):
        rids, _ = _serve(eng, [{"input_ids": ids, "pixel_values": pixels,
                                "image_size": (56, 56)}, list(range(40, 60))])
    spans = profiling.SPANS.records()
    towers = _by_name(spans, "admit.tower")
    assert len(towers) == 1
    parent = spans[towers[0][1].parent]
    assert parent.name == "engine.admit" and parent.rid == rids[0] == towers[0][1].rid


def test_the_gate_is_torchs_profiler_flag(monkeypatch):
    """The recorder is on exactly while torch flags a profiler session; a
    torch without that flag fails at the first span site."""
    from torch.autograd import profiler as autograd_profiler

    assert autograd_profiler._is_profiler_enabled is False
    profiling.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        with profiling.span("engine.step"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    assert [s.name for s in profiling.SPANS.records()] == ["engine.step"]
    monkeypatch.delattr(autograd_profiler, "_is_profiler_enabled")
    with pytest.raises(AttributeError):
        profiling.span("engine.step")


def test_trace_exports_the_spans_on_the_profilers_clock(text_model, tmp_path):
    """``trace()`` writes the spans into its Chrome trace: "X" events on a
    row of their own and each queue wait as an async pair, inside the span
    of the profiler's own events."""
    eng = ServingEngine(text_model, batch_size=2, max_new_tokens=8, chunk_rounds=2)
    with profiling.trace(str(tmp_path)):
        _, steps = _serve(eng, _prompts(2))
    doc = json.loads((tmp_path / "trace.json").read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "engine"]
    torch_ops = [e for e in doc["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") != "engine"]
    assert sum(e["name"] == "engine.step" for e in ours) == steps
    assert sum(e["ph"] == "b" for e in ours) == sum(e["ph"] == "e" for e in ours) == 2
    lo = min(e["ts"] for e in torch_ops)
    hi = max(e["ts"] + e["dur"] for e in torch_ops)
    rounds = [e for e in ours if e["name"] == "engine.round"]
    assert rounds and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in rounds)
