"""The manifest (``BENCHMARK.json``) and the files each of its names points to.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in files of its own, found by name:

  configs/<config>.json      sizes as run, source, reduced, assumed, serving
  reference/<config>.py      plain torch: the weight maker and the reference
  program/<config>.py        builds the system under test from those weights
  traffic/<mix>.json         the mix's parameters, read by ``lib.traffic``
  cells/<workload>.json      the cell's engine settings and its check limits
  metrics/<metric>.py        ``read(run) -> float | None``, one per metric;
                             ``<base>.<split>`` falls back to ``<base>.py``

so a later cell, mix, configuration or metric is new files and new manifest
entries, and no edit of a file that is already here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    settings: dict
    end_to_end: List[dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports
    bench_dir: Path

    def module(self, kind: str) -> ModuleType:
        """``reference`` or ``program`` module of this cell's configuration."""
        return load_module(self.bench_dir / kind / f"{self.config_name}.py")


def load_module(path: Path) -> ModuleType:
    """A module loaded from its file (names may hold dots and dashes), kept
    in ``sys.modules`` under a name made from its path."""
    key = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names_of_cell: Optional[set] = None) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or the metric has none (an end-to-end metric: every cell;
    a per-layer one: every cell that reports the metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names_of_cell is None:
        return True
    return metric.get("moves") in e2e_names_of_cell


def load_cell(name: str, manifest_path: Optional[Path] = None,
              bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of the manifest, with its configuration, traffic
    and settings read from their files."""
    bench_dir = Path(bench_dir or BENCH_DIR)
    manifest_path = Path(manifest_path or bench_dir.parent / "BENCHMARK.json")
    man = read_json(manifest_path)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg_entry = configs[w["config"]]
    config = read_json(bench_dir.parent / cfg_entry["file"])
    traffic = read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    settings = read_json(bench_dir / "cells" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                settings=settings, end_to_end=e2e, per_layer=per_layer,
                bench_dir=bench_dir)


def metric_file(bench_dir: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a metric
    split by the end-to-end metric it moves (``mfu.chat``) the reader of
    its base, ``metrics/<base>.py``, where the split has no file of its own."""
    path = bench_dir / "metrics" / f"{name}.py"
    base = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return path if path.exists() or "." not in name else base


def metric_readers(cell: Cell, metrics: List[dict]) -> Dict[str, ModuleType]:
    """name -> the reader module of each metric."""
    return {m["name"]: load_module(metric_file(cell.bench_dir, m["name"])) for m in metrics}
