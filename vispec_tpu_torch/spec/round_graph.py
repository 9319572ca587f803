"""One slot-stacked decode round captured as a CUDA graph and replayed.

An eager round issues some thousands of kernel launches from Python, and on
the card the host's time to issue them exceeds the kernels' own.  A CUDA
graph of the round replays the same launches, in the same order, from one
host call, so the tokens are the same bits.

The round is functional (``states = round_fn(states, eos, caps)``): the
captured round ends by copying each new leaf back into the leaf it read
(tree, lengths, output, cursors, done, key, seen), so the state's buffers
are the graph's static inputs and outputs.  The K/V caches are written in
place already; ``eos`` and the per-slot caps are device buffers filled once
a chunk, outside the graph.  Whatever writes into the state between chunks
(``spec/serving.admit``, a cancel) writes into the buffers the graph reads.

A runner (``RoundGraph``) belongs to one owner of a state: a serving
engine, or one ``drain_batch`` call.  Its first chunk runs eagerly and
warms what a capture cannot do (the kernels' build, their attributes and
occupancy queries, cuBLAS's handles, cached weights); later chunks capture
once and replay.  The graph is keyed on the data pointers of every buffer
it reads: the state's leaves, the eos and caps buffer and the weights.  A
changed pointer captures again and drops the old graph and its memory
pool.  CPU tensors and a sharded model (``mesh``, whose rounds run
collectives) stay eager.

Replays run no Python, so each replay adds the captured round's launches
to the kernel wrappers' launch counters, and opens a ``round.replay`` span
inside ``engine.round``.  The runner reaches ``spec/batch._rounds_chunk``
through ``replaying(graph)``, so the chunk functions keep their signatures.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional

import torch

from ..ops import quant
from ..ops import verify_attention as va
from ..utils import profiling
from . import loop as spec_loop

# the wrappers whose ``launches*`` attributes count their kernels' launches
COUNTED = (va.verify_attention, va.verify_attention_batched, quant.q4_matmul)


def launch_counts() -> dict:
    """(wrapper, attribute) -> its launch counter."""
    return {(f, a): v for f in COUNTED for a, v in vars(f).items()
            if a.startswith("launches")}


def _leaves(states: spec_loop.SpecState) -> list:
    out = []
    spec_loop.map_states(out.append, states)
    return out


def _pointers(*trees, shapes: bool = False) -> tuple:
    """Data pointers (with ``shapes`` also shapes and strides) of every
    tensor in nested dicts, sequences and dataclasses (a quantized weight),
    in a fixed order."""
    out, stack = [], list(reversed(trees))
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append((x.data_ptr(), tuple(x.shape), x.stride()) if shapes else x.data_ptr())
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(reversed([getattr(x, f.name) for f in dataclasses.fields(x)]))
    return tuple(out)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The two tensors view the same elements (strides of unit dims aside)."""
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and all(x == y for x, y, n in zip(a.stride(), b.stride(), a.shape) if n > 1))


def cuda_graph(fn: Callable[[], None]):
    """``fn`` captured into a ``torch.cuda.CUDAGraph`` (``replay()``)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph


class RoundGraph:
    """Replays one captured round ``n`` times a chunk (see the module's
    docstring).  ``record(fn)`` captures ``fn`` and returns an object with
    ``replay()``; ``device`` is the device type it engages on."""

    def __init__(self, record: Callable = cuda_graph, device: str = "cuda"):
        self.record = record
        self.device = device
        self.warm = False  # an eager chunk has run
        self.graph = None
        self.key = None
        self.launches: dict = {}  # counter -> launches of one captured round
        self.captures = 0
        self.replayed = 0  # rounds replayed
        self._buf = None  # int32 [1 + caps]: eos, then the caps

    def engages(self, states: spec_loop.SpecState, mesh) -> bool:
        return mesh is None and states.done.device.type == self.device

    def _inputs(self, device, eos_id, max_new_tokens):
        """The eos and caps buffers, filled from the host by one copy."""
        caps = torch.as_tensor(max_new_tokens, dtype=torch.int32)
        host = torch.cat([torch.as_tensor(eos_id, dtype=torch.int32).reshape(1),
                          caps.reshape(-1)])
        if self._buf is None or self._buf.shape != host.shape or self._buf.device != device:
            self._buf = torch.empty(host.shape, dtype=torch.int32, device=device)
        self._buf.copy_(host.pin_memory() if device.type == "cuda" else host,
                        non_blocking=True)
        return self._buf[0], self._buf[1:].reshape(caps.shape)

    def _capture(self, round_fn, states, eos, caps) -> None:
        self.graph = None  # the old graph's pool goes before the new one is taken
        leaves = _leaves(states)
        storages = {t.untyped_storage().data_ptr() for t in leaves}

        def one_round():
            new = _leaves(round_fn(states, eos, caps))
            for old, upd in zip(leaves, new):
                if upd is old or _same_memory(upd, old):
                    continue  # written in place (the caches) or unchanged
                if upd.untyped_storage().data_ptr() in storages:
                    upd = upd.clone()  # a view of another buffer: read before any write
                old.copy_(upd)

        before = launch_counts()
        self.graph = self.record(one_round)
        after = launch_counts()
        self.launches = {k: after[k] - v for k, v in before.items() if after[k] != v}
        for (f, a), v in before.items():  # the capture launched nothing
            setattr(f, a, v)
        self.captures += 1

    def rounds(self, round_fn, states: spec_loop.SpecState, eos_id, max_new_tokens,
               n_rounds: int, weights=()):
        """``n_rounds`` replays over ``states``'s buffers; returns (the
        same state, cumulative counters ``[n_rounds, B]``)."""
        eos, caps = self._inputs(states.done.device, eos_id, max_new_tokens)
        key = (_pointers(states, shapes=True), self._buf.data_ptr(), _pointers(weights))
        if key != self.key or self.graph is None:
            self._capture(round_fn, states, eos, caps)
            self.key = key
        counts = []
        for _ in range(n_rounds):
            with profiling.span("engine.round"), profiling.span("round.replay"):
                self.graph.replay()
                for (f, a), d in self.launches.items():
                    setattr(f, a, getattr(f, a) + d)
            counts.append(states.new_token.clone())
        self.replayed += n_rounds
        return states, torch.stack(counts)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("round_graph", default=None)


@contextlib.contextmanager
def replaying(graph: Optional[RoundGraph]):
    """Rounds run inside the block (``spec/batch._rounds_chunk``) replay
    through ``graph`` where it engages."""
    token = _CURRENT.set(graph)
    try:
        yield graph
    finally:
        _CURRENT.reset(token)


def current() -> Optional[RoundGraph]:
    return _CURRENT.get()
