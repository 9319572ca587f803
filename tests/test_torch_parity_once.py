"""``tests/torch_parity.once_per_session``: the child run of an
``in_fresh_interpreter_module`` module, and a parallel world, run once per
xdist session however the tests are spread.  Two worker processes with the
same run uid ask for the same key at once; the work runs once and both read
the same result, a crashed child and an exception included; a worker that
finds the key taken runs a child module that no worker has started."""

import json
import os
import subprocess
import sys
import time
import uuid

import pytest

from tests.torch_parity import _CHILD, _ROOT

# A worker: asks for the child run of the module in argv[1], or for a
# generic ``once_per_session`` key whose work counts itself in argv[2],
# raises if argv[3] says so and takes argv[4] seconds, or lasts until the
# file argv[4] names exists (a module named in VISPEC_ONCE_HELP is
# registered as a child module first), and prints what it got as one JSON
# line.
WORKER = """
import json, os, sys, time
from tests import torch_parity as tp
if os.environ.get("VISPEC_ONCE_HELP"):
    tp._CHILD_MODULES.append(os.environ["VISPEC_ONCE_HELP"])
if sys.argv[1] == "once":
    def work(workdir):
        with open(sys.argv[2], "a") as f:
            f.write("x")
        if sys.argv[4].replace(".", "").isdigit():
            time.sleep(float(sys.argv[4]))
        else:
            deadline = time.time() + 240
            while not os.path.exists(sys.argv[4]) and time.time() < deadline:
                time.sleep(0.1)
        if sys.argv[3] == "raise":
            raise ValueError("the work failed")
        (workdir / "made.txt").write_text("made")
        return {"workdir": str(workdir), "value": 42}
    try:
        print(json.dumps({"ok": tp.once_per_session("generic-key", work)}))
    except RuntimeError as e:
        print(json.dumps({"raised": str(e)}))
else:
    results, log = tp._child_run(sys.argv[1])
    print(json.dumps({"results": results, "crashed": "no report" in log}))
"""

# The module a child run runs: one test passes, one fails; each run of the
# module counts itself in the file that VISPEC_ONCE_COUNT names; CRASH
# ends the child process before pytest writes its report.
MODULE = """
import os

with open(os.environ["VISPEC_ONCE_COUNT"], "a") as f:
    f.write("x")


def test_passes():
    assert 1 + 1 == 2


def test_fails():
    if os.environ.get("VISPEC_ONCE_CRASH") == "1":
        os._exit(3)
    assert 1 + 1 == 3, "one and one"
"""


def _env(tmp_path, crash=False):
    env = {k: v for k, v in os.environ.items() if k != _CHILD}
    env.update(PYTEST_XDIST_TESTRUNUID=uuid.uuid4().hex, TMPDIR=str(tmp_path / "tmp"),
               VISPEC_ONCE_COUNT=str(tmp_path / "count"), PYTHONPATH=_ROOT,
               VISPEC_ONCE_CRASH="1" if crash else "0", JAX_PLATFORMS="cpu")
    (tmp_path / "tmp").mkdir(exist_ok=True)
    return env


def _start(env, args):
    return subprocess.Popen([sys.executable, "-c", WORKER, *args], cwd=_ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _out(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _two_workers(tmp_path, *args, crash=False):
    """Start two workers at once with one run uid; their JSON lines."""
    env = _env(tmp_path, crash)
    return [_out(p) for p in [_start(env, args) for _ in range(2)]]


def _count(tmp_path):
    return len((tmp_path / "count").read_text())


@pytest.mark.parametrize("crash", [False, True], ids=["fails_one_test", "crashes"])
def test_child_run_once_per_session(tmp_path, crash):
    module = tmp_path / "test_once_module.py"
    module.write_text(MODULE)
    a, b = _two_workers(tmp_path, str(module), crash=crash)
    assert _count(tmp_path) == 1  # the module ran in one child process only
    assert a == b
    if crash:
        assert a["results"] == {} and a["crashed"]
    else:
        assert a["results"]["test_passes"] is None
        assert "one and one" in a["results"]["test_fails"]


@pytest.mark.parametrize("fail", [False, True], ids=["returns", "raises"])
def test_generic_work_once_per_session(tmp_path, fail):
    a, b = _two_workers(tmp_path, "once", str(tmp_path / "count"),
                        "raise" if fail else "ok", "1")
    assert _count(tmp_path) == 1
    assert a == b
    if fail:
        assert "the work failed" in a["raised"]
    else:
        assert a["ok"]["value"] == 42
        # the work directory is shared: every worker reads what the first made
        assert open(os.path.join(a["ok"]["workdir"], "made.txt")).read() == "made"


def test_a_waiting_worker_runs_a_child_module_nobody_started(tmp_path):
    """While the first worker holds a key (its work lasts until the child
    module has run), the second runs the child module no worker has
    started, then reads the key's result: both ran once."""
    module = tmp_path / "test_once_module.py"
    module.write_text(MODULE)
    env = _env(tmp_path)
    env["VISPEC_ONCE_COUNT"] = str(tmp_path / "module_count")
    work = tmp_path / "count"
    args = ("once", str(work), "ok", str(tmp_path / "module_count"))
    first = _start(env, args)
    deadline = time.time() + 120
    while not work.exists():  # the first worker holds the key's lock
        assert time.time() < deadline and first.poll() is None
        time.sleep(0.1)
    second = _start({**env, "VISPEC_ONCE_HELP": str(module)}, args)
    a, b = _out(first), _out(second)
    assert a == b and a["ok"]["value"] == 42
    assert _count(tmp_path) == 1 and len((tmp_path / "module_count").read_text()) == 1
    session = tmp_path / "tmp" / f"vispec-torch-session-{env['PYTEST_XDIST_TESTRUNUID']}"
    (result,) = session.glob("child-*.json")
    assert json.loads(result.read_text())["value"][0]["test_passes"] is None


def test_a_new_session_removes_the_directories_of_ended_sessions(tmp_path):
    """The worker that makes a session's directory writes the controller
    (its parent) there and removes the directory of a session whose
    controller has exited; a live session's directory stays."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    done = subprocess.Popen([sys.executable, "-c", "pass"])
    done.wait()
    ended, live = tmp / "vispec-torch-session-ended", tmp / "vispec-torch-session-live"
    for root, pid in ((ended, done.pid), (live, os.getpid())):
        (root / "child-x").mkdir(parents=True)
        (root / "controller").write_text(str(pid))
    a, b = _two_workers(tmp_path, "once", str(tmp_path / "count"), "ok", "0")
    assert a == b and a["ok"]["value"] == 42
    assert not ended.exists() and (live / "child-x").is_dir()
    (session,) = set(tmp.glob("vispec-torch-session-*")) - {live}
    assert (session / "controller").read_text() == str(os.getpid())
