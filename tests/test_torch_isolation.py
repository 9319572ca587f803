"""The port stands alone: no file of vispec_tpu_torch/ (its examples
included), and not chip_smoke.py, imports jax, vispec_tpu, safetensors or
optax; importing the package loads none of them; its entry points and
examples default to the GPU."""

import ast
import inspect
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vispec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the card's machine has no safetensors or optax package: the port reads and
# writes the format itself (convert/hf.py, convert/export.py) and writes its
# optimizer out on tensors (train/step.py)
FORBIDDEN = ("jax", "jaxlib", "vispec_tpu", "safetensors", "optax")


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
    from vispec_tpu_torch.convert import hf
    from vispec_tpu_torch.convert.params import from_numpy
    from vispec_tpu_torch.models import clip_vit, draft, llama, llava, medusa, mixtral
    from vispec_tpu_torch.models import qwen2_5_vl
    from vispec_tpu_torch.ops import rng, static_tree
    from vispec_tpu_torch.ops.kv_cache import init_cache
    from vispec_tpu_torch.spec import batch
    from vispec_tpu_torch.spec.spec_model import SpecModel
    from vispec_tpu_torch.train import main_mtp, trainer

    for fn in (SpecModel.__init__, init_cache, from_numpy, llama.init_params,
               draft.init_params, draft.init_draft_cache, draft.make_prefill_plan,
               clip_vit.init_params, llava.init_projector_params, qwen2_5_vl.init_params,
               batch.batched_prefill, batch.prepare_requests, batch.generate_batch,
               medusa.init_params, medusa.convert_medusa, static_tree.from_choices,
               rng.key, rng.keys, SpecModel.from_pretrained, mixtral.init_params,
               mixtral.convert_mixtral, hf.convert_llama, hf.convert_draft,
               hf.convert_clip_and_projector, hf.convert_qwen_vision,
               trainer.batch_examples, trainer.data_iterator, trainer.load_state,
               trainer.load_params,
               main_mtp.load_head_only):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__qualname__


EXAMPLES = ("quickstart", "serving", "serve_http", "multichip")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_stand_alone_and_default_to_the_gpu(name):
    """Each example of vispec_tpu_torch/examples/ is among the files the
    import checks above walk, runs as a module (``python -m``) and takes
    ``--device`` with cuda as its default."""
    path = ROOT / "vispec_tpu_torch" / "examples" / f"{name}.py"
    assert path in PORT_FILES
    tree = ast.parse(path.read_text(), str(path))
    devices = [call for call in ast.walk(tree) if isinstance(call, ast.Call)
               and getattr(call.func, "attr", None) == "add_argument"
               and call.args and getattr(call.args[0], "value", None) == "--device"]
    assert len(devices) == 1, name
    default = next(k.value.value for k in devices[0].keywords if k.arg == "default")
    assert default == "cuda", name
    assert 'if __name__ == "__main__":' in path.read_text()
