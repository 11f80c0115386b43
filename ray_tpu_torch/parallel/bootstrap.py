"""Multi-process bootstrap.

Port of `ray_tpu/parallel/bootstrap.py`: `jax.distributed.initialize`
becomes `torch.distributed.init_process_group`, with NCCL for CUDA
devices and gloo for the CPU, one process per device. Each worker calls
`initialize_distributed(coordinator, num_processes, process_id)`.

One deliberate difference: JAX skips initialisation for a one-process
world, while the port opens a process group of one rank, because a
`DeviceMesh` needs one and the train step's collectives run over it
(on NCCL, one rank's all-reduce is a copy). Without a coordinator
address a one-process world keeps its store in memory, so it needs no
port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class DistributedInfo:
    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    local_device_count: int
    global_device_count: int


_coordinator: Optional[str] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda") -> DistributedInfo:
    """Idempotent `init_process_group`: NCCL when ``device_type`` is
    "cuda" (this process then drives card ``process_id`` modulo the
    cards it sees), gloo when it is "cpu".

    ``coordinator_address`` is "host:port" (a TCP store served by
    process 0, ``tcp://host:port``) or a full init method such as
    ``file:///path``; None means ``env://`` (MASTER_ADDR/MASTER_PORT)
    in a world of several processes and an in-memory store in a world
    of one."""
    global _coordinator
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import resolve_device

    device = resolve_device(device_type)
    if not dist.is_initialized():
        world = num_processes or 1
        rank = process_id or 0
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        kw = dict(backend="nccl" if device.type == "cuda" else "gloo",
                  world_size=world, rank=rank)
        if coordinator_address is not None:
            kw["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
        elif world == 1:
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = "env://"
        dist.init_process_group(**kw)
        _coordinator = coordinator_address
    return distributed_info()


def distributed_info() -> DistributedInfo:
    """The world as this process sees it; one device per process."""
    import torch.distributed as dist

    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return DistributedInfo(
        coordinator_address=_coordinator if up else os.environ.get(
            "MASTER_ADDR"),
        num_processes=world,
        process_id=dist.get_rank() if up else 0,
        local_device_count=1,
        global_device_count=world,
    )
