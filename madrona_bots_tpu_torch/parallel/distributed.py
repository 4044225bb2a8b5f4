"""Process-group bootstrap for worlds-sharded runs.

Counterpart of `madrona_bots_tpu/parallel/distributed.py`: `initialize`
starts this process's `torch.distributed` group and returns its `Mesh`.
One process per card, launched by `torchrun` (which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT) or given its coordinator address,
process count and id; with neither, a group of one process in this process.

Backend: NCCL when each process on a host has a card of its own; gloo when
processes share a card (NCCL refuses two ranks on one device) or run on the
CPU. The learners' one collective is `all_reduce`, which gloo also runs on
CUDA tensors.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from madrona_bots_tpu_torch.device import resolve
from madrona_bots_tpu_torch.parallel.mesh import Mesh, local_device, make_mesh

TIMEOUT_S = 600.0
_device: Optional[torch.device] = None      # the device `initialize` chose


def choose_backend(device: torch.device, procs_per_host: int) -> str:
    """'nccl' when every process on the host has a card of its own, else
    'gloo'."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and procs_per_host <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = TIMEOUT_S) -> Mesh:
    """Start the process group and return this process's mesh.

    `coordinator_address` is `host:port`, a `tcp://` or a `file://` URL;
    without it the launcher's environment is read, and without that this
    process is a group of one. `device` defaults to
    `cuda:{local_rank % device_count}` (raises without CUDA); the backend
    is `choose_backend`'s. The group times out after `timeout_s` and is
    destroyed at exit."""
    global _device
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = coordinator_address
        kwargs = dict(init_method=init if "://" in init else f"tcp://{init}",
                      world_size=num_processes, rank=process_id)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        local = int(os.environ.get("LOCAL_RANK", process_id))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        kwargs = dict(init_method="env://")
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    else:
        kwargs = dict(store=dist.HashStore(), world_size=1, rank=0)
        per_host, local = 1, 0
    dev = local_device(local) if device is None else resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(choose_backend(dev, per_host),
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    atexit.register(shutdown)
    _device = dev
    return global_mesh()


def global_mesh() -> Mesh:
    """The mesh over every process of the default group."""
    return make_mesh(_device if _device is not None else local_device())


def is_coordinator() -> bool:
    """True on rank 0, and without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Destroy the default group, if there is one."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None
