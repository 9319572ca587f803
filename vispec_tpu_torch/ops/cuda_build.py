"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` beside the package (git-ignored), and loaded with
``ctypes``.  A library's name carries a hash of its source and flags, so an
edited source is rebuilt and a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
# -split-compile=0: the device code's optimisation runs on every core (the
# attention source has twenty-three kernel instantiations)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    these flags exists; returns the ``.so`` path.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it in a
    ``.log`` file.  Builders of different sources may run at once."""
    source = CSRC / f"{name}.cu"
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]
