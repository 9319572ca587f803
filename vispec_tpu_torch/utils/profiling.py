"""Profiling helpers: a device-synchronized timer, a ``torch.profiler``
trace around a block, and the card's memory statistics.

The JAX package brackets its timer with ``block_until_ready`` and traces
with ``jax.profiler``; here the timer synchronizes CUDA on both sides of
the block and the trace is a Chrome trace of ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """``with Timer("verify", sync_on="cuda"):`` — wall time of the block
    with the device's queued work finished on both sides (``sync_on`` a
    device, or None for no synchronization)."""

    def __init__(self, name: str, sync_on=None, silent: bool = False):
        self.name = name
        self.sync_on = sync_on
        self.silent = silent
        self.elapsed = 0.0

    def __enter__(self):
        _sync(self.sync_on)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.sync_on)
        self.elapsed = time.perf_counter() - self.start
        if not self.silent:
            print(f"{self.name} took {self.elapsed:.6f} seconds")


@contextlib.contextmanager
def trace(logdir: str = "build/trace"):
    """Capture a ``torch.profiler`` trace of the block (the host's ops, and
    the card's kernels when there is one) into ``logdir/trace.json`` (open
    it in Perfetto or chrome://tracing); yields the profiler, whose
    ``key_averages()`` sums them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device="cuda") -> dict:
    """``torch.cuda.memory_stats`` of the device; empty without CUDA."""
    if not torch.cuda.is_available() or torch.device(device).type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(device))
