"""The port's examples (``vispec_tpu_torch/examples/``) run on the CPU as
subprocesses and print the success lines that ``tests/test_examples.py``
holds the JAX package's examples to; the multichip one runs as four
``torchrun`` ranks over gloo."""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def _module(name, *args):
    return _run(["-m", f"vispec_tpu_torch.examples.{name}", "--device", "cpu", *args])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_quickstart_example_runs():
    out = _module("quickstart", "--epochs", "3")
    assert "greedy-lossless vs AR: True" in out


def test_serving_example_runs():
    out = _module("serving", "--hidden", "64", "--max-new-tokens", "16")
    assert "served 12 requests" in out


@pytest.mark.parametrize("extra", [[], ["--per-request-sampling"]],
                         ids=["greedy", "per_request_sampling"])
def test_serve_http_example_runs(extra):
    """Concurrent HTTP clients over the engine's online API, each response
    equal to specgenerate's (with per-request sampling: mixed greedy and
    T = 1 top_k 1 clients in one engine)."""
    out = _module("serve_http", "--selftest", "--port", str(_free_port()), "--batch", "2",
                  *extra)
    assert "serve_http demo OK" in out
    assert "6/6 concurrent HTTP requests match" in out


def test_multichip_example_runs():
    out = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                "-m", "vispec_tpu_torch.examples.multichip", "--device", "cpu"])
    assert "multichip demo OK" in out
    assert "token-identical" in out
