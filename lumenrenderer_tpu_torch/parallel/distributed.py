"""Multi-process bootstrap: port of `lumenrenderer_tpu/parallel/distributed.py`.

JAX brings up `jax.distributed` for meshes that span hosts; here every
device is one process of a `torch.distributed` group, started by torchrun
(or any launcher that sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)
or by explicit arguments. The backend is NCCL on CUDA and gloo on the
CPU.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group: coordinator_address "host:port" (default
    MASTER_ADDR:MASTER_PORT), num_processes (WORLD_SIZE) and process_id
    (RANK). backend: "nccl" or "gloo" (default NCCL when CUDA is
    available, else gloo); with NCCL the process takes the CUDA device
    LOCAL_RANK (default its rank) modulo the devices it sees. Returns False,
    doing nothing, in a single process (no address known) or when the group
    is already up; True once joined."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def process_info() -> dict:
    """This process's place in the group, with JAX's four keys: one device
    a process, so the global devices are the processes."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": max(torch.cuda.device_count(), 1),
        "global_devices": dist.get_world_size() if up else 1,
    }
