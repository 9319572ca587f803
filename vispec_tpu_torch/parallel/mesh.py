"""The rank mesh of multi-device inference.

The JAX package builds one ``jax.sharding.Mesh`` over the devices with the
named axes ``("dp", "pp", "sp", "tp")`` and lets GSPMD insert the
collectives.  The port runs one process per rank (``parallel/multihost.py``)
and lays the ranks out over the same axes in the same order (``tp`` varies
fastest): each rank knows its coordinate on every axis, holds one process
group per axis of size > 1, and calls the collectives of
``parallel/sharding.py`` on plain local tensors, as Megatron-LM does.

  dp — data parallel (replicas at inference)
  pp — layer-stage placement (each stage holds some of the target's layers)
  sp — sequence parallel (a prefill's prompt rows split over the ranks)
  tp — tensor parallel (heads, MLP columns, experts and vocab split)

The axis groups' backend is chosen when the mesh is built, and the mesh
says which it took (``backend``, ``describe``):

- NCCL when the ranks run on CUDA and each has a card of its own;
- gloo on the CPU;
- gloo with CUDA tensors when ranks share a card (NCCL refuses two ranks on
  one device).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import multihost

AXES = ("dp", "pp", "sp", "tp")


class Mesh:
    """This rank's place in a ``dp x pp x sp x tp`` world: ``shape`` (axis ->
    size, like the JAX mesh's), ``coords`` (axis -> this rank's index),
    ``groups`` (axis -> process group, None for a size-1 axis),
    ``members`` (axis -> the global ranks of this rank's group, in axis
    order), the ``device`` its tensors live on and the ``backend`` of its
    groups."""

    def __init__(self, shape: Dict[str, int], rank: int, coords: Dict[str, int],
                 groups: Dict[str, Optional[object]], members: Dict[str, list],
                 device: torch.device, backend: str, shared_card: bool):
        self.shape, self.rank, self.coords = shape, rank, coords
        self.groups, self.members = groups, members
        self.device, self.backend, self.shared_card = device, backend, shared_card

    def describe(self) -> str:
        dims = "x".join(f"{a}{self.shape[a]}" for a in AXES)
        where = (f"{self.device} shared by {self.world} ranks" if self.shared_card
                 else str(self.device))
        return f"{dims} over {self.backend} on {where}"

    @property
    def world(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))


def _backend(device: torch.device, world: int) -> tuple:
    """(backend, device, whether ranks share the card) for ranks on
    ``device``'s type."""
    if device.type != "cuda":
        return "gloo", device, False
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("a CUDA mesh on a machine without a CUDA device (pass "
                           "device='cpu' for gloo on the CPU)")
    if cards >= multihost.local_world_size():
        index = multihost.local_rank()
        torch.cuda.set_device(index)
        return "nccl", torch.device("cuda", index), False
    index = multihost.local_rank() % cards
    return "gloo", torch.device("cuda", index), world > 1


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1, pp: int = 1,
              device=None) -> Mesh:
    """Lay the joined world (``multihost.init_distributed``) out as
    ``dp x pp x sp x tp`` ranks; ``dp`` defaults to what the other axes
    leave.  ``device`` is the ranks' device type ("cuda" unless the caller
    asks for the CPU).  Every rank of the world calls this, in the same
    order of meshes, since each axis group is created collectively."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a joined process group: call "
                           "parallel.multihost.init_distributed first (or launch "
                           "under torchrun)")
    n, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = n // (tp * sp * pp)
    if dp * pp * sp * tp != n:
        raise ValueError(f"mesh {dp}x{pp}x{sp}x{tp} != {n} ranks")
    shape = dict(zip(AXES, (dp, pp, sp, tp)))
    backend, dev, shared = _backend(torch.device(device or "cuda"), n)
    grid = np.arange(n).reshape(dp, pp, sp, tp)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, grid.shape))))
    groups: Dict[str, Optional[object]] = {}
    members: Dict[str, list] = {}
    for ax, axis in enumerate(AXES):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[axis])
        groups[axis] = None
        members[axis] = [rank]
        for line in lines:
            ranks = [int(r) for r in line]
            # every rank creates every group, in the same order
            group = dist.new_group(ranks, backend=backend) if len(ranks) > 1 else None
            if rank in ranks:
                groups[axis], members[axis] = group, ranks
    return Mesh(shape, rank, coords, groups, members, dev, backend, shared)


def mesh_from_args(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1,
                   bs: Optional[int] = None, max_len: Optional[int] = None,
                   device=None) -> Optional[Mesh]:
    """The mesh a CLI's ``--dp/--tp/--sp/--pp`` flags describe, or None when
    every axis is 1 (single device: no collective anywhere).  Validates the
    quantities the flags split: ``bs`` must divide over dp and ``max_len``
    over sp.  The world (``torchrun --nproc-per-node N``) must hold exactly
    the flags' product of ranks."""
    n = dp * tp * sp * pp
    if n <= 1:
        return None
    if bs is not None and bs % dp:
        raise ValueError(f"--bs {bs} must be a multiple of --dp {dp}")
    if max_len is not None and max_len % sp:
        raise ValueError(f"--max-len {max_len} must be a multiple of --sp {sp}")
    multihost.init_distributed()
    world = multihost.process_count()
    if world != n:
        raise ValueError(f"--dp {dp} --tp {tp} --sp {sp} --pp {pp} need {n} ranks, the "
                         f"world has {world}: launch under torchrun --nproc-per-node {n}")
    return make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, device=device)
