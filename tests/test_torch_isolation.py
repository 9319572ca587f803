"""The port stands alone: no file of vispec_tpu_torch/, and not chip_smoke.py,
imports jax or vispec_tpu; importing the package loads neither; its entry
points default to the GPU."""

import ast
import inspect
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vispec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "vispec_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted("vispec_tpu_torch." + ".".join(p.relative_to(ROOT / "vispec_tpu_torch")
                                                 .with_suffix("").parts)
                  for p in (ROOT / "vispec_tpu_torch").rglob("*.py")
                  if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_gpu():
    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.models import draft, llama
    from vispec_tpu_torch.ops.kv_cache import init_cache
    from vispec_tpu_torch.spec.spec_model import SpecModel

    for fn in (SpecModel.__init__, init_cache, from_numpy, llama.init_params,
               draft.init_params, draft.init_draft_cache, draft.make_prefill_plan):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__qualname__
