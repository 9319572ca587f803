"""Multi-process start-up: one process per rank under ``torch.distributed``.

The JAX package calls ``jax.distributed.initialize()`` once per host and
then sees every device of the pod from one program.  PyTorch's idiom is one
process per rank (``torchrun --nproc-per-node N``), each holding its own
shard and calling explicit collectives (``parallel/sharding.py``).
``init_distributed`` joins that world; ``parallel/mesh.make_mesh`` then lays
the ranks out over the ``dp / pp / sp / tp`` axes.

The default process group always runs gloo: it carries only start-up
traffic and the ``local_shard`` arithmetic needs no collective.  The mesh
picks the backend of its axis groups (NCCL when each rank has a card of its
own, gloo otherwise) when it is built.

Evaluation scale-out needs no collective at all: each process runs an
independent ``gen_answer`` over its ``local_shard`` of the questions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
) -> int:
    """Join the process group from the arguments or the environment and
    return this process's rank.

    - ``coordinator_address`` ("host:port") with ``num_processes`` and
      ``process_id``, or the JAX package's variables ``COORDINATOR_ADDRESS`` /
      ``NUM_PROCESSES`` / ``PROCESS_ID``;
    - ``init_method`` (any ``torch.distributed`` URL, e.g. ``file://...``)
      with ``num_processes`` and ``process_id``;
    - else torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
      ``RANK``.

    With none of these set it is a single-process no-op that returns 0.
    Already joined: returns the rank."""
    if dist.is_initialized():
        return dist.get_rank()
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address or init_method:
        world = int(num_processes if num_processes is not None
                    else os.environ["NUM_PROCESSES"])
        rank = int(process_id if process_id is not None else os.environ["PROCESS_ID"])
        url = init_method or f"tcp://{address}"
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        world, rank, url = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://"
    else:
        return 0
    dist.init_process_group("gloo", init_method=url, world_size=world, rank=rank)
    return rank


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``; the
    global rank when the launcher sets none, as on one host)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_world_size() -> int:
    """Processes on this host (torchrun's ``LOCAL_WORLD_SIZE``; the world
    size when the launcher sets none)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def local_shard(total: int) -> range:
    """This process's contiguous slice of ``total`` work items (eval
    sharding), with the JAX package's arithmetic: ``ceil(total / n)`` items
    each, the last slice shorter."""
    n, i = process_count(), process_index()
    per = (total + n - 1) // n
    return range(i * per, min((i + 1) * per, total))
