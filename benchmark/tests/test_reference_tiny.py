"""The references against the port's CPU path at tiny widths (float32 on
both sides), the fp8 control failing the limit, and the faults that the
check must catch, each planted under a run driven as the benchmark drives
one (only the look for a card is skipped)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.lib import cell as cell_mod  # noqa: E402
from benchmark.lib import manifest  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.tests.faults import FAULTS  # noqa: E402

CELLS = ("tiny-vl.image", "tiny-moe.chat")


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    return tiny.tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference_and_control_fails(man, name):
    c = tiny.load(man, name)
    res = cell_mod.run_cell(c, 2 ** 31 + 5, 3.0, False, "cpu", 0.0, control="fp8",
                            drain_s=10.0)
    v = res["verdict"]
    assert v.correct, v.numbers
    assert v.numbers["served_tokens_checked"]["value"] >= 20
    assert max(v.gaps.values()) <= 1e-4
    # the control (the reference through fp8 products) in the program's
    # place comes out as not correct under the same limits
    assert v.control_verdict is not None and not v.control_verdict.correct, \
        v.control_verdict.numbers


def test_reference_tower_against_the_port(man):
    """The reference tower (no window shuffle: windows as masks over the
    processor's own token order) against the port's windowed tower."""
    from vispec_tpu_torch.models import qwen2_5_vl as qv
    from vispec_tpu_torch.models.llava import resize_image

    c = tiny.load(man, "tiny-vl.image")
    cfg = c.config
    w = c.module("reference").make_weights(cfg, 3, "cpu")
    prog = c.module("program")
    model = prog.build(cfg, w, "cpu")
    from benchmark.reference import _plain

    img = torch.rand((112, 84, 3), generator=torch.Generator().manual_seed(1))
    with _plain.exact_float32():
        ref = _plain.vision_features(w["vision"], cfg["vision_config"], img)
    q = model.qwen_cfg
    patches = qv.patchify_image(resize_image(img, 112, 84), q)
    plan = qv.plan_vision([(1, 8, 6)], q, 64)
    pad = torch.cat([patches, patches.new_zeros((64 - patches.shape[0], patches.shape[1]))])
    got = qv.forward(model.vparams, q, pad, plan)[:plan.n_merged]
    assert torch.allclose(got, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(man, name, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    c = tiny.load(man, name)
    res = cell_mod.run_cell(c, 77, 2.0, False, "cpu", 0.0, drain_s=2.0)
    assert not res["verdict"].correct, res["verdict"].numbers


def test_dist_rehearsal_over_gloo(tmp_path):
    """A cell on four ranks (tp 4 over gloo on the CPU): the engine on a
    sharded model, rank 0 deciding the window's moves, its result line."""
    import json

    from benchmark.lib import dist

    man = tiny.tree(tmp_path, chips=4, mesh={"tp": 4})
    import time

    code, out = dist.start(str(man), "tiny-moe.chat", 2 ** 31 + 3, 20.0, 0, 4, "cpu",
                           time.perf_counter(), timeout_s=600)
    assert code == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["count"] == 4
    assert line["metrics"]["tokens_per_s"]["value"] > 0


@pytest.mark.gpu
def test_tiny_cells_on_the_card(man):
    """The tiny cells through the port's CUDA kernels (float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CELLS:
        c = tiny.load(man, name)
        res = cell_mod.run_cell(c, 11, 3.0, True, "cuda:0", 0.0, control="fp8", drain_s=10.0)
        v = res["verdict"]
        assert v.correct, v.numbers
        assert not v.control_verdict.correct, v.control_verdict.numbers
        line = cell_mod.result_line(c, res, True, "cuda:0", 1)
        assert line["device"]["busy_s"] > 0
        assert not res["run"].trace.lost, res["run"].trace.notes
