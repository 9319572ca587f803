"""Shared set-up of the port-vs-JAX parity tests (tests/test_torch_*.py): the
tests/test_spec_loop.py geometry, seeded JAX weights handed to the port as
numpy, the tests/test_vision.py CLIP geometry over that target, a
Qwen2.5-VL variant of that target (M-RoPE, qkv bias) with a toy windowed
ViT, and the CPU device.  Both sides run in float32 on the CPU unless a test says
otherwise."""

import fcntl
import functools
import glob
import inspect
import json
import os
import pathlib
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import traceback
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vispec_tpu.configs import DraftConfig as JDraftConfig
from vispec_tpu.configs import LlamaConfig as JLlamaConfig
from vispec_tpu.configs import SpecConfig as JSpecConfig
from vispec_tpu.models import clip_vit as jclip
from vispec_tpu.models import draft as jdraft
from vispec_tpu.models import llama as jllama
from vispec_tpu.models import llava as jllava
from vispec_tpu.models import qwen2_5_vl as jqwen
from vispec_tpu_torch import configs as tconfigs
from vispec_tpu_torch.convert.params import from_numpy
from vispec_tpu_torch.models import clip_vit as tclip
from vispec_tpu_torch.models import llava as tllava
from vispec_tpu_torch.models import qwen2_5_vl as tqwen

torch.set_num_threads(2)  # the suite runs several xdist workers

CPU = torch.device("cpu")

GEOMETRY = dict(
    target=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512),
    draft=dict(vocab_size=256, hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512, num_q=2),
    spec=dict(total_tokens=12, depth=3, top_k=4),
)
J_TCFG = JLlamaConfig(**GEOMETRY["target"])
J_DCFG = JDraftConfig(**GEOMETRY["draft"])
J_SPEC = JSpecConfig(**GEOMETRY["spec"])
T_TCFG = tconfigs.LlamaConfig(**GEOMETRY["target"])
T_DCFG = tconfigs.DraftConfig(**GEOMETRY["draft"])
T_SPEC = tconfigs.SpecConfig(**GEOMETRY["spec"])
MAX_LEN = 256

VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
              num_attention_heads=4, image_size=56, patch_size=14, feature_layer=-2)
PINPOINTS = ((56, 112), (112, 56), (112, 112))
J_VCFG = jclip.ClipVisionConfig(**VISION)
T_VCFG = tclip.ClipVisionConfig(**VISION)


def llava_cfgs(anyres=True, image_token_index=250):
    """(JAX, port) LlavaConfig over the target above."""
    kw = dict(image_token_index=image_token_index, anyres=anyres,
              image_grid_pinpoints=PINPOINTS)
    return (jllava.LlavaConfig(text=J_TCFG, vision=J_VCFG, **kw),
            tllava.LlavaConfig(text=T_TCFG, vision=T_VCFG, **kw))


def vision_params(dtype=jnp.float32, seed=0):
    """(JAX, port) vparams: the tower, projector and newline of the JAX
    initializers in ``dtype``, with random biases and LayerNorm affines and
    weights 5x wider than the initializer's, so the bias adds, the norms
    and the attention are not trivial."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = {"vision": jclip.init_params(J_VCFG, k1, dtype),
              **jllava.init_projector_params(k2, J_VCFG.hidden_size, J_TCFG.hidden_size,
                                             dtype)}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = jax.random.split(k3, len(leaves))
    out = []
    for (path, x), k in zip(leaves, keys):
        name = path[-1].key
        noise = jax.random.normal(k, x.shape, jnp.float32)
        if name.startswith(("b", "ln", "pre_norm", "proj_b")):
            x = (x.astype(jnp.float32) + 0.1 * noise).astype(x.dtype)
        else:
            x = (x.astype(jnp.float32) * 5).astype(x.dtype)
        out.append(x)
    jparams = jax.tree_util.tree_unflatten(treedef, out)
    return jparams, from_numpy(to_numpy_tree(jparams), CPU)


def to_numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def make_models(seed=0):
    """(JAX tparams, JAX dparams, port tparams, port dparams), float32, the
    draft sharing the target's embedding as tests/test_spec_loop.py does."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = jllama.init_params(J_TCFG, k1, jnp.float32)
    jd = jdraft.init_params(J_DCFG, k2, jnp.float32)
    jd["embed"] = jt["embed"]
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jt, jd, tt, td


def t2n(x):
    """Port tensor -> numpy."""
    return x.detach().cpu().numpy()


# Qwen2.5-VL: the target above with M-RoPE sections (2, 2, 2) (head_dim 16:
# slots 6 and 7 fall past the sections and clip to the w stream), qkv bias
# and rope_theta 100 (every slot turns by > 0.01 rad a position, so each
# stream shows), a draft with qkv bias, and the tests/test_vision.py tower
# widths with the target's hidden as its output (window 56 px: 2x2 merged
# units; full attention at block 1)
QWEN_TARGET = dict(GEOMETRY["target"], mrope_section=(2, 2, 2), qkv_bias=True,
                   rope_theta=100.0)
QWEN_DRAFT = dict(GEOMETRY["draft"], qkv_bias=True)
QWEN_VISION = dict(hidden_size=32, out_hidden_size=64, intermediate_size=64, depth=3,
                   num_heads=4, patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                   window_size=56, fullatt_block_indexes=(1,))


def qwen_vision_tree(cfg, key, dtype=jnp.float32):
    """A JAX Qwen2.5-VL tower tree (tests/test_vision.py's ``qwen_params``
    layout) with random biases and RMSNorm weights, so that every add and
    norm is live."""
    ks = iter(jax.random.split(key, 32))
    h, m, l = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    pin = 3 * cfg.temporal_patch_size * cfg.patch_size ** 2

    def w(shape, scale=0.05, dt=dtype):
        return (jax.random.normal(next(ks), shape, jnp.float32) * scale).astype(dt)

    def norm(shape):
        return 1.0 + w(shape, 0.1, jnp.float32)

    return {
        "patch_w": w((pin, h)),
        "blocks": {
            "norm1": norm((l, h)), "norm2": norm((l, h)),
            "wqkv": w((l, h, 3 * h)), "bqkv": w((l, 3 * h), 0.1),
            "wo": w((l, h, h)), "bo": w((l, h), 0.1),
            "w_gate": w((l, h, m)), "b_gate": w((l, m), 0.1),
            "w_up": w((l, h, m)), "b_up": w((l, m), 0.1),
            "w_down": w((l, m, h)), "b_down": w((l, h), 0.1),
        },
        "merger": {
            "ln_q": norm((h,)),
            "w1": w((4 * h, 4 * h)), "b1": w((4 * h,), 0.1),
            "w2": w((4 * h, cfg.out_hidden_size)), "b2": w((cfg.out_hidden_size,), 0.1),
        },
    }


def qwen_models(seed=0):
    """(JAX, port) configs and float32 weights of the Qwen2.5-VL geometry:
    returns (j_tcfg, j_dcfg, j_vcfg, t_tcfg, t_dcfg, t_vcfg, jt, jd, jv, tt,
    td, tv).  The qkv biases are random and the target's wq / wk are 10x
    the initializer's, so that its attention is sharp and every position
    counts; the draft shares the target's embedding."""
    jtc, jdc = JLlamaConfig(**QWEN_TARGET), JDraftConfig(**QWEN_DRAFT)
    jvc = jqwen.QwenVisionConfig(**QWEN_VISION)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    jt = jllama.init_params(jtc, k1, jnp.float32)
    jd = jdraft.init_params(jdc, k2, jnp.float32)
    for i, b in enumerate(("bq", "bk", "bv")):
        kb = jax.random.fold_in(k4, i)
        jt["layers"][b] = 0.1 * jax.random.normal(kb, jt["layers"][b].shape)
        jd["layer"][b] = 0.1 * jax.random.normal(jax.random.fold_in(kb, 7),
                                                 jd["layer"][b].shape)
    jt["layers"]["wq"] = jt["layers"]["wq"] * 10
    jt["layers"]["wk"] = jt["layers"]["wk"] * 10
    jd["embed"] = jt["embed"]
    jv = qwen_vision_tree(jvc, k3)
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return (jtc, jdc, jvc, tconfigs.LlamaConfig(**QWEN_TARGET),
            tconfigs.DraftConfig(**QWEN_DRAFT), tqwen.QwenVisionConfig(**QWEN_VISION),
            jt, jd, jv, tt, td, from_numpy(to_numpy_tree(jv), CPU))


# Mixtral: tests/test_mixtral.py's MoE geometry (4 experts, top-2) over the
# vocabulary and draft above.  The router is 20x the initializer's and the
# experts and wq / wk 5x, so that routing differs from token to token and
# the tokens do not settle into one repeated id.
MIXTRAL_TARGET = dict(GEOMETRY["target"], num_hidden_layers=2, intermediate_size=96,
                      num_local_experts=4, num_experts_per_tok=2)


def mixtral_models(seed=0):
    """(JAX config, port config, JAX tparams, JAX dparams, port tparams, port
    dparams), float32; the draft shares the target's embedding."""
    from vispec_tpu.models import mixtral as jmixtral
    from vispec_tpu_torch.models import mixtral as tmixtral

    jcfg = jmixtral.MixtralConfig(**MIXTRAL_TARGET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jt = jmixtral.init_params(jcfg, k1, jnp.float32)
    for name, scale in (("router", 20), ("we_gate", 5), ("we_up", 5), ("we_down", 5),
                        ("wq", 5), ("wk", 5)):
        jt["layers"][name] = jt["layers"][name] * scale
    jd = jdraft.init_params(J_DCFG, k2, jnp.float32)
    jd["embed"] = jt["embed"]
    tt = from_numpy(to_numpy_tree(jt), CPU)
    td = from_numpy(to_numpy_tree(jd), CPU)
    td["embed"] = tt["embed"]
    return jcfg, tmixtral.MixtralConfig(**MIXTRAL_TARGET), jt, jd, tt, td


# Running a test module in a fresh interpreter.  This jax build's XLA:CPU
# compiler segfaults after enough fresh compiles in one process (pytest.ini,
# tests/test_vlm_ingestion.subprocess_isolated), so a module whose tests
# compile many JAX graphs keeps them out of the worker that runs the suite:
# the module runs once in a child pytest process, and each test reports its
# own outcome from that run.
_CHILD = "VISPEC_TORCH_PARITY_CHILD"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD_TIMEOUT = 1200


_SESSION_PREFIX = "vispec-torch-session-"


def _session_root(uid: str) -> str:
    """The directory that the workers of xdist session ``uid`` share.  The
    worker that makes it writes the session's controller process (the
    workers' parent) into it and removes the directories of sessions whose
    controller has exited, so only the last session's outlives its run."""
    base = tempfile.gettempdir()
    root = os.path.join(base, _SESSION_PREFIX + uid)
    try:
        os.mkdir(root)
    except FileExistsError:
        return root
    with open(os.path.join(root, "controller"), "w") as f:
        f.write(str(os.getppid()))
    for other in glob.glob(os.path.join(base, _SESSION_PREFIX + "*")):
        if other != root and _session_ended(other):
            shutil.rmtree(other, ignore_errors=True)
    return root


def _session_ended(root: str) -> bool:
    """Whether the controller written in ``root`` has exited (False while it
    is not written yet)."""
    try:
        with open(os.path.join(root, "controller")) as f:
            os.kill(int(f.read()), 0)
    except (OSError, ValueError) as e:
        return isinstance(e, ProcessLookupError)
    return False


def _result_path(root: str, key: str, fmt: str) -> str:
    return os.path.join(root, re.sub(r"[^\w.-]", "_", key) + "." + fmt)


def _compute_once(root: str, key: str, compute, fmt: str, wait: bool) -> bool:
    """Take ``key``'s lock (waiting for it, or not) and, holding it, run
    ``compute`` and write its result unless a result is there; False when
    another worker holds the lock and ``wait`` is False."""
    result = _result_path(root, key, fmt)
    with open(result[:-len(fmt)] + "lock", "w") as lock:
        try:  # the lock goes with the file
            fcntl.flock(lock, fcntl.LOCK_EX | (0 if wait else fcntl.LOCK_NB))
        except BlockingIOError:
            return False
        if not os.path.exists(result):
            workdir = pathlib.Path(result[:-len(fmt) - 1])
            workdir.mkdir(exist_ok=True)
            try:
                record = {"value": compute(workdir)}
            except Exception:
                record = {"error": traceback.format_exc()}
            partial = f"{result}.{os.getpid()}.partial"
            with open(partial, "wb" if fmt == "pickle" else "w") as f:
                (pickle if fmt == "pickle" else json).dump(record, f)
            os.replace(partial, result)
    return True


def once_per_session(key: str, compute, local_dir=lambda: None, fmt: str = "pickle"):
    """``compute(workdir)`` once per pytest session, whatever the xdist
    distribution, and its result in every worker that asks.

    Under xdist (``PYTEST_XDIST_TESTRUNUID`` set, and not in a child run)
    the workers of one session share a directory under the temporary
    directory, keyed by the run uid: the first worker to take the key's
    ``flock`` runs ``compute`` with ``workdir`` a directory there that every
    worker can read, and writes the result (``fmt``: "pickle" or "json");
    the others read it.  While another worker holds the lock, a worker runs
    a child module that no worker has started (``_CHILD_MODULES``), then
    waits for the lock.  An exception of ``compute`` is written too, and
    every worker raises it as a RuntimeError.  With ``--dist load`` the
    tests of one module are spread over the workers, so a per-worker cache
    would run the work once per worker.  Without xdist
    ``compute(local_dir())`` runs in this process."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid or os.environ.get(_CHILD) == "1":
        return compute(local_dir())
    root = _session_root(uid)
    result = _result_path(root, key, fmt)
    while not _compute_once(root, key, compute, fmt, wait=False):
        idle = [p for p in _CHILD_MODULES
                if not os.path.exists(_result_path(root, _child_key(p), "json"))]
        if not any(_compute_once(root, _child_key(p), lambda _, p=p: _run_child(p), "json",
                                 wait=False) for p in idle):
            _compute_once(root, key, compute, fmt, wait=True)
    with open(result, "rb" if fmt == "pickle" else "r") as f:
        record = (pickle if fmt == "pickle" else json).load(f)
    if "error" in record:
        raise RuntimeError(f"{key} failed once in this session:\n{record['error']}")
    return record["value"]


def _run_child(path: str):
    """[{test name: None if passed, else the failure text}, the run's log
    tail] of the test module at ``path`` run by a child pytest process; a
    child that crashed or timed out leaves no results and says so in the
    log."""
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "report.xml")
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "pytest", path, "-q", "-n", "0", "-p",
                 "no:cacheprovider", "-p", "no:randomly", f"--junitxml={report}"],
                env={**os.environ, _CHILD: "1"}, cwd=_ROOT, capture_output=True, text=True,
                timeout=_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            out = [(s.decode(errors="replace") if isinstance(s, bytes) else s) or ""
                   for s in (e.stdout, e.stderr)]
            return [{}, f"the child run timed out after {_CHILD_TIMEOUT} s\n"
                        f"{out[0][-3000:]}{out[1][-2000:]}"]
        results = {}
        if os.path.exists(report):
            for case in ET.parse(report).iter("testcase"):
                bad = [e for e in case if e.tag in ("failure", "error", "skipped")]
                results[case.get("name")] = (None if not bad else
                                             f"{bad[0].tag}: {bad[0].get('message')}\n"
                                             f"{bad[0].text or ''}")
    log = proc.stdout[-3000:] + proc.stderr[-2000:]
    if proc.returncode != 0 and not results:
        log = f"the child run exited with {proc.returncode} and no report\n{log}"
    return [results, log]


# the modules of this session that run in a child process, registered as
# the workers import them
_CHILD_MODULES: list = []


def _child_key(path: str) -> str:
    return "child-" + os.path.relpath(path, _ROOT)


@functools.lru_cache(maxsize=None)
def _child_run(path: str):
    """``_run_child(path)`` once per test session (``once_per_session``)."""
    results, log = once_per_session(_child_key(path), lambda _: _run_child(path), fmt="json")
    return results, log


def in_fresh_interpreter(test):
    """Run ``test`` in the child pytest process of its module (see above);
    the decorator goes above ``pytest.mark.parametrize``.  In the child
    process the test runs as it is."""
    if os.environ.get(_CHILD) == "1":
        return test
    marks = getattr(test, "pytestmark", [])
    names = []
    for mark in marks:
        if mark.name == "parametrize":
            arg = mark.args[0]
            names += [a.strip() for a in (arg.split(",") if isinstance(arg, str) else arg)]
    path = inspect.getfile(test)

    def reported(**_params):
        name = os.environ["PYTEST_CURRENT_TEST"].split("::", 1)[1].rsplit(" (", 1)[0]
        results, log = _child_run(path)
        if name not in results:
            pytest.fail(f"{name}: no result from the child run of {path}\n{log}")
        if results[name] is not None:
            pytest.fail(results[name], pytrace=False)

    reported.__name__, reported.__doc__ = test.__name__, test.__doc__
    reported.__signature__ = inspect.Signature(
        [inspect.Parameter(n, inspect.Parameter.KEYWORD_ONLY) for n in names])
    reported.pytestmark = marks
    return reported


def in_fresh_interpreter_module(namespace: dict) -> None:
    """``in_fresh_interpreter`` on every test function of a module; call it
    last in the module with ``globals()``.  For the modules whose JAX
    references compile in the test process: in a six-worker xdist run their
    compiles, added to the JAX package's own in one worker, brought back
    pytest.ini's XLA:CPU crash, in a JAX test that passes alone
    (tests/test_from_pretrained.py's tp 2 compile aborted).  The child run
    happens once per session, however xdist spreads the module's tests
    (``once_per_session``)."""
    for name, obj in list(namespace.items()):
        if name.startswith("test_") and inspect.isfunction(obj):
            namespace[name] = in_fresh_interpreter(obj)
            path = inspect.getfile(obj)
            if os.environ.get(_CHILD) != "1" and path not in _CHILD_MODULES:
                _CHILD_MODULES.append(path)
