"""Multi-process start-up on ``torch.distributed``.

Counterpart of ``revisit_anything_tpu/parallel/distributed.py``:
``initialize_multihost``, ``process_info`` and ``host_shard`` (:63-71).
One process a host (or a card) joins one process group by TCP: NCCL
where CUDA is present, gloo otherwise. Nothing tells a process of its
cluster, so the address, the process count and the rank are given, or
read from torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``). Multi-process extraction splits the image
list by :func:`host_shard`, then a mesh of the process's local devices
splits each share further.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         local_device_ids: Optional[Sequence[int]] = None
                         ) -> bool:
    """Join the process group (``coordinator_address`` "host:port").
    With CUDA, the process's card is ``local_device_ids[0]`` (default:
    the rank modulo the local card count). Returns True when it joined,
    False when the group was up already (safe to call from every entry
    point)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        card = (local_device_ids[0] if local_device_ids
                else process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _local_device_count() -> int:
    return max(1, torch.cuda.device_count())


def process_info():
    """(rank, process count, local device count, global device count).
    The CPU counts as one device; the global count assumes every process
    has as many devices as this one (as torchrun starts them)."""
    import torch.distributed as dist
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    local = _local_device_count()
    return rank, world, local, local * world


def host_shard(n_items: int) -> slice:
    """The contiguous [start, stop) slice of a length-``n_items`` work list
    that this process owns (⌈n/world⌉ items each, the last one short)."""
    rank, world = process_info()[:2]
    per = -(-n_items // world)
    return slice(rank * per, min((rank + 1) * per, n_items))
