"""Worlds-sharded placement over a torch.distributed process group.

Counterpart of `madrona_bots_tpu/parallel/mesh.py`. The scaling axis is the
batch of independent worlds: each rank of the process group holds one
contiguous range of worlds, `[lo, hi)`, in tensors it owns, and every rank
holds the same replicated parameters. Every env scatter and gather is
world-local, so the sim step runs on a shard with no communication; the
learners (`learn/a2c.py`, `learn/ppo.py` with `mesh=`) all-reduce the sums
that cross worlds (loss denominators, gradients, metrics), so a sharded run
computes the global program, as GSPMD does in the JAX package.

A `Mesh` is this process's place in the group: rank, size, device and
group. Its one collective is a sum (`all_reduce`), which gloo also runs on
CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.env.state import FIELDS, WorldState

WORLD_AXIS = "worlds"
SPLIT = (WORLD_AXIS,)
"""A field's placement: split on its leading (worlds) axis."""
REPLICATED = ()
"""A field's placement: the same on every rank."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    size: int
    device: torch.device
    group: Any = None                       # None: the default group

    def world_range(self, num_worlds: int) -> tuple[int, int]:
        """This rank's global worlds [lo, hi) of `num_worlds`."""
        if num_worlds % self.size:
            raise ValueError(f"{num_worlds} worlds do not split over {self.size} ranks")
        n = num_worlds // self.size
        return self.rank * n, (self.rank + 1) * n

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns `t`."""
        dist.all_reduce(t, group=self.group)
        return t

    def reduce_sum(self, tensors) -> list:
        """`tensors` summed over the ranks in one all-reduce of their values
        as one f32 vector, each returned in its shape and dtype (integer
        sums stay exact below 2^24)."""
        flat = self.all_reduce(torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]))
        return [x.view(t.shape).to(t.dtype)
                for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def local_rank() -> int:
    """This process's index on its host: the launcher's LOCAL_RANK, else
    the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(rank: int | None = None) -> torch.device:
    """`cuda:{rank % device_count}`, by default of `local_rank()`; raises
    without CUDA."""
    resolve("cuda")
    return torch.device("cuda", (local_rank() if rank is None else rank)
                        % torch.cuda.device_count())


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of this process in `group` (default: the initialised default
    group) on `device` (default: `local_device()`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.initialize)")
    dev = local_device() if device is None else resolve(device)
    return Mesh(dist.get_rank(group), dist.get_world_size(group), dev, group)


def state_sharding(mesh: Mesh) -> WorldState:
    """A WorldState of placements: every per-world field `SPLIT` on its
    worlds axis, `step_count` `REPLICATED`."""
    return WorldState(**{f: REPLICATED if f == "step_count" else SPLIT for f in FIELDS})


def shard_state(state: WorldState, mesh: Mesh) -> WorldState:
    """This rank's shard of a full state: each split field's worlds [lo, hi)
    as a fresh contiguous tensor on the mesh's device, which the rank owns
    (the systems kernel writes the state in place, so a shard is never a
    view of a shared state); replicated fields copied."""
    lo, hi = mesh.world_range(state.alive.shape[0])
    spec = state_sharding(mesh)
    out = {}
    for f in FIELDS:
        x = getattr(state, f)
        if getattr(spec, f) == SPLIT:
            x = x[lo:hi]
        out[f] = x.to(mesh.device, copy=True).contiguous()
    return WorldState(**out)


def replicated(mesh: Mesh):
    """The placement of parameters, optimizer state and keys."""
    return REPLICATED
