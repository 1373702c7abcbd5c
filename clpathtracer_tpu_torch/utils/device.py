"""Device discovery and placement policy (the port's counterpart of
clpathtracer_tpu/utils/device.py).

The reference enumerates OpenCL platforms and devices with printf
inventories and an interactive stdin picker (src/CLHandler.c:13-127).
Here: a structured inventory of the CUDA devices and the host, and a
non-interactive selection that never prompts and never falls back to the
CPU on its own.
"""

from __future__ import annotations

import torch

PLATFORMS = ("gpu", "cpu")


def device_inventory() -> list:
    """One dict per device, the CUDA cards and then the host CPU: the
    platform/device printout (src/CLHandler.c:13-38) as data."""
    out = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            out.append({"id": i, "platform": "gpu", "device_kind": p.name,
                        "memory_bytes": int(p.total_memory),
                        "capability": f"{p.major}.{p.minor}",
                        "multiprocessors": int(p.multi_processor_count)})
    out.append({"id": 0, "platform": "cpu", "device_kind": "cpu",
                "threads": torch.get_num_threads()})
    return out


def pick_device(platform: str = "gpu", index: int = 0) -> torch.device:
    """Deterministic device selection (replaces the stdin picker,
    src/CLHandler.c:43-53). platform "gpu" picks CUDA card `index` and
    raises RuntimeError when there is no such card; "cpu" the host."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform {platform!r} is not one of {PLATFORMS}")
    if platform == "cpu":
        if index != 0:
            raise RuntimeError(f"device index {index} out of range (1 cpu)")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False (pass "
            "--cpu, or platform 'cpu', to run on the host)")
    n = torch.cuda.device_count()
    if index >= n:
        raise RuntimeError(
            f"CUDA device index {index} out of range ({n} available)")
    return torch.device("cuda", index)


def host_cpu() -> torch.device:
    """The host CPU, where the host builds (kd-tree, grid, windows) run."""
    return torch.device("cpu")
