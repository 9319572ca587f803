"""The harness on the CPU: every cell loads from data, the generator
repeats by seed, the window arithmetic, the operation counts, a new cell,
mix and metric added as files alone, and the import rules."""

from __future__ import annotations

import ast
import json
import math
import re
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import cell as cell_mod  # noqa: E402
from benchmark.lib import check, flops, manifest, stats, traffic  # noqa: E402
from benchmark.tests import tiny  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_from_data(name):
    c = manifest.load_cell(name)
    assert c.chips in (1, 4)
    assert (c.bench_dir / "reference" / f"{c.config_name}.py").exists()
    assert (c.bench_dir / "program" / f"{c.config_name}.py").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert manifest.metric_file(c.bench_dir, m["name"]).exists()
    plan = traffic.plan(c.traffic, MANIFEST["run_seconds"])
    assert plan.requests and all(r.cap >= 1 for r in plan.requests)
    assert cell_mod.warm_requests(c)
    for r in plan.requests[:50]:
        if r.image:
            from benchmark.lib.requests import image_tokens

            n = image_tokens(c.config, r.image) + 2 + r.text_tokens
        else:
            n = r.text_tokens
        assert n < max(c.settings["engine"]["pad_bucket"])
        assert n + r.cap + 64 <= c.config["serve"]["max_len"]


def test_manifest_shapes():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in m[k]}) == len(m[k])
    assert len({x["name"] for x in m["end_to_end"] + m["per_layer"]}) == len(
        m["end_to_end"]) + len(m["per_layer"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["end_to_end"]:
        assert 0 < x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and x["layer"]
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert not re.search(r"(size|_dim|_rank|heads|experts_per_tok)$", k)
    for w in m["workloads"]:
        for x in m["end_to_end"]:
            if manifest.reports(x, w["name"]):
                break


def test_traffic_is_one_schedule():
    """The schedule is the mix's: every run sends the same sizes at the
    same offsets, which the mix's quantiles give; the seed draws the ids
    and pixels (test below)."""
    for name in CELLS:
        mix = manifest.load_cell(name).traffic
        a = traffic.plan(mix, 30)
        key = lambda p: [(r.text_tokens, r.cap, r.image, r.arrival_s, r.client)  # noqa: E731
                         for r in p.requests]
        assert key(a) == key(traffic.plan(mix, 30))
        other = traffic.plan(dict(mix, schedule_seed=mix["schedule_seed"] + 1), 30)
        assert key(a) != key(other)
        for f in (lambda r: r.text_tokens, lambda r: r.cap, lambda r: r.image):
            assert Counter(map(f, a.requests)) == Counter(map(f, other.requests))
        if a.loop == "open":
            assert a.requests[0].arrival_s == -mix.get("ramp_s", 0)
            assert a.requests[-1].arrival_s < 30
            assert len(a.requests) == math.floor(mix["rate_per_s"] * (30 + mix.get("ramp_s", 0)))


def test_inputs_repeat_by_seed():
    from benchmark.lib.requests import make_inputs

    for name in CELLS:
        c = manifest.load_cell(name)
        reqs = traffic.plan(c.traffic, 10).requests[:4]
        a, b, d = (make_inputs(c.config, reqs, s, "cpu") for s in (5, 5, 2 ** 31 + 5))
        for x, y, z in zip(a, b, d):
            assert np.array_equal(x.input_ids, y.input_ids)
            assert not np.array_equal(x.input_ids, z.input_ids)
            assert x.prompt_len == z.prompt_len
            if x.image is not None:
                assert torch.equal(x.image, y.image) and not torch.equal(x.image, z.image)


def test_quantiles_and_counts():
    q = traffic.quantiles({"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 10,
                           "max": 1000}, 101)
    assert q[50] == 100 and q.min() >= 10 and q.max() <= 1000 and list(q) == sorted(q)
    assert traffic.proportional_counts([0.5, 0.3, 0.15, 0.05], 40) == [20, 12, 6, 2]
    assert sum(traffic.proportional_counts([1, 1, 1], 10)) == 10


def test_percentile_and_window_arithmetic():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert stats.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    # a stall of 2 s at t = 1 delays every request due during it
    tl = []
    for i in range(10):
        arrive = 0.5 * i
        first = max(arrive, 3.0) + 0.1 if 1.0 <= arrive < 3.0 else arrive + 0.1
        tl.append(stats.Timeline(start_s=arrive, first_s=first, last_s=first + 0.9,
                                 tokens=10, first_tokens=1, done_s=first + 0.9))
    tt = stats.ttft_ms(tl)
    assert sorted(tt)[-1] == pytest.approx(2100.0)
    assert stats.percentile(tt, 90) == pytest.approx(1600.0 + 0.1 * 500.0)
    assert stats.tpot_ms(tl, close_s=5.0) == pytest.approx([100.0] * 9)
    # a request completed after the close is not in the window's TPOT
    assert len(stats.tpot_ms(tl, close_s=3.5)) == 2
    # a first delivery of a chunk's 4 tokens: 0.6 s for the 6 tokens after it;
    # a request streamed in one delivery has no time per token
    chunked = [stats.Timeline(0.0, 0.2, 0.8, tokens=10, first_tokens=4, done_s=0.8),
               stats.Timeline(0.0, 0.2, 0.2, tokens=4, first_tokens=4, done_s=0.2)]
    assert stats.tpot_ms(chunked, close_s=1.0) == pytest.approx([100.0])


def test_counts_against_hand_counts():
    cfg = json.loads((ROOT / "benchmark/configs/mixtral-8x7b.json").read_text())
    t = flops.Dims.of(cfg)
    per_layer = (2 * 2 * 4096 * 4096 + 2 * 2 * 4096 * 1024
                 + 2 * 4096 * 8 + 2 * 2 * 3 * 4096 * 14336)
    assert flops.layer_row_flops(t) == per_layer
    assert flops.attention_flops(32, 128, 30, 1000) == 4 * 32 * 128 * 30 * 1000
    ops, byts = flops.attention_call(32, 8, 128, 30, 1030, 1004)
    assert byts == 2 * 128 * (2 * 8 * 1030 + 2 * 32 * 30)
    assert ops == 4 * 32 * 128 * 30 * 1004
    assert flops.bound_s(ops, byts) == byts / 3.35e12  # memory bound at decode
    q = json.loads((ROOT / "benchmark/configs/qwen2.5-vl-7b.json").read_text())
    qt = flops.Dims.of(q)
    # 28 layers of 233.0M products and the 545M head: ~15.1 GFLOP a row
    assert 28 * flops.layer_row_flops(qt) + flops.head_flops(qt, 1) == pytest.approx(
        2 * (28 * (3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944) + 3584 * 152064))
    vc = q["vision_config"]
    one_block = 2 * 1024 * (1280 * 3840 + 1280 * 1280 + 3 * 1280 * 3420)
    f = flops.tower_flops(vc, 1024)
    assert f > 32 * one_block
    assert flops.sum_rounds(lambda tl, dl, a: tl, [(100, 90, [0, 2, 0])]) == 100 + 101 + 104


def test_one_wrong_request_moves_the_worst_median():
    """Sound requests' gaps are mostly small with a long tail; one request of
    ten read at a wrong token on every position moves the largest of the
    requests' medians past a limit that the pooled median stays under."""
    rng = np.random.default_rng(3)
    sound = {i: np.where(rng.random(300) < 0.35, 0.0, rng.exponential(0.6, 300))
             for i in range(9)}
    wrong = {**sound, 9: rng.uniform(2.0, 6.0, 300)}
    assert check.gap_numbers(sound)["worst_median_logit_gap"] < 1.2
    assert check.gap_numbers(wrong)["worst_median_logit_gap"] > 1.2
    assert np.median(np.concatenate(list(wrong.values()))) < 1.2
    assert check.gap_numbers(wrong)["widest_logit_gap"] == max(
        float(g.max()) for g in wrong.values())
    assert check.gap_numbers({})["worst_median_logit_gap"] == math.inf


def test_split_metric_falls_back_to_its_base_reader(tmp_path):
    (tmp_path / "metrics").mkdir()
    for name in ("mfu.py", "mfu.image.py"):
        (tmp_path / "metrics" / name).write_text("")
    assert manifest.metric_file(tmp_path, "mfu.chat").name == "mfu.py"
    assert manifest.metric_file(tmp_path, "mfu.image").name == "mfu.image.py"
    assert manifest.metric_file(tmp_path, "tpot_p90_ms").name == "tpot_p90_ms.py"


def test_new_cell_mix_and_metric_from_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and manifest entries, with no edit of a file already there."""
    man = tiny.tree(tmp_path)
    bench = man.parent / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = dict(tiny.TINY_MOE, num_hidden_layers=1)
    (bench / "configs" / "dummy.json").write_text(json.dumps(cfg))
    for kind in ("reference", "program"):
        (bench / kind / "dummy.py").write_text(
            (bench / kind / "tiny-moe.py").read_text())
    mix = dict(tiny.TINY_CHAT_MIX, clients=1)
    (bench / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (bench / "cells" / "dummy.dummy-mix.json").write_text(json.dumps(
        {"engine": {"pad_bucket": [128, 256], "chunk_rounds": 4}, "check": tiny.CHECK}))
    (bench / "metrics" / "dummy_rounds.py").write_text(
        "def read(run):\n    return float(sum(s.rounds for s in run.steps()))\n")
    m = json.loads(man.read_text())
    m["configs"].append({"name": "dummy", "source": "test", "file":
                         "benchmark/configs/dummy.json", "reduced": [], "why": "test"})
    m["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy",
                           "traffic": "dummy-mix", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "dummy_rounds", "unit": "rounds", "better": "higher",
                           "source": "program_span", "layer": "decode round",
                           "moves": "tokens_per_s", "workloads": ["dummy.dummy-mix"]})
    m["end_to_end"][0]["workloads"].append("dummy.dummy-mix")
    man.write_text(json.dumps(m))
    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file() and p in before}
    assert after == before
    c = tiny.load(man, "dummy.dummy-mix")
    assert [x["name"] for x in c.per_layer] == ["dummy_rounds"]
    res = cell_mod.run_cell(c, 31, 6.0, False, "cpu", 0.0, drain_s=5.0)
    line = cell_mod.result_line(c, res, True, "cpu", 1)
    assert line["correct"], line["check"]
    assert line["metrics"]["dummy_rounds"]["value"] > 0


BENCH_FILES = sorted((ROOT / "benchmark").rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = set(top_level_imports(path)) & {"jax", "jaxlib", "flax", "vispec_tpu"}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "vispec_tpu_torch" not in set(top_level_imports(path))


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "vispec_tpu_torch_fake", object())
    assert "vispec_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vispec_tpu.models", object())
    assert "vispec_tpu" in run.forbidden_modules()
