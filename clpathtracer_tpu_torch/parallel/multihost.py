"""Process-group set-up (port of clpathtracer_tpu/parallel/multihost.py).

One process per device: every process runs the same program and
torch.distributed.init_process_group forms the group, NCCL between CUDA
devices and gloo on the host. The world comes from the arguments, else
from torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK); the JAX package's JAX_COORDINATOR_ADDRESS is not read. With
none of them the process forms a world of 1 through a FileStore in a
temporary directory, which needs no network.

Fail-fast policy: a failing init_process_group raises at once, after at
most initialization_timeout seconds of rendezvous; nothing falls back
from NCCL to gloo or from the card to the host.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from clpathtracer_tpu_torch.utils.device import pick_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None,
                     initialization_timeout: int = 300, *,
                     device=None) -> dict:
    """Form the process group (idempotent: with a group formed, only the
    summary). Returns topology_summary().

    coordinator_address: "host:port" (a TCP rendezvous) or an
    init_method URL ("tcp://...", "file://..."); default MASTER_ADDR and
    MASTER_PORT. num_processes, process_id: the world size and this
    process's rank; default WORLD_SIZE and RANK. device: the process's
    device, default the CUDA card LOCAL_RANK (pick_device raises without
    CUDA); a CUDA device is made current and the backend is NCCL, the CPU
    ("cpu") takes gloo."""
    if dist.is_initialized():
        return topology_summary()
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", 0))
    if device is None:
        device = pick_device("gpu", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else local_rank)
    rank = process_id if process_id is not None else env.get("RANK")
    world = num_processes if num_processes is not None \
        else env.get("WORLD_SIZE")
    address = coordinator_address
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
    timeout = timedelta(seconds=initialization_timeout)
    if address is None and rank is None and world is None:
        store_dir = tempfile.mkdtemp(prefix="clpt_dist_")
        atexit.register(shutil.rmtree, store_dir, True)
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        dist.init_process_group(_backend(device), store=store, rank=0,
                                world_size=1, timeout=timeout)
        return topology_summary()
    if address is None or rank is None or world is None:
        raise ValueError(
            "init_distributed: a world needs its address, size and rank "
            f"(got {address!r}, {world!r}, {rank!r}): pass them or run "
            "under torchrun")
    method = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(_backend(device), init_method=method,
                            rank=int(rank), world_size=int(world),
                            timeout=timeout)
    return topology_summary()


def topology_summary() -> dict:
    """The JAX summary's keys: process_index (rank), process_count (world
    size), local_devices (CUDA devices of this host under NCCL, else 1),
    global_devices (the world size: one device a process). Without a
    group: process 0 of 1."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1,
                "local_devices": 1, "global_devices": 1}
    nccl = dist.get_backend() == "nccl"
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_devices": torch.cuda.device_count() if nccl else 1,
            "global_devices": world}
