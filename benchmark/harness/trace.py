"""The device trace of a measured window: torch.profiler with device
activity only (no host operator events, whose recording slows the host
that paces these frames), reduced in memory (nothing is exported) to what
the per-layer readers need: each device operation's count and seconds by
name, the union of the device's busy intervals inside the window, and the
idle gaps labelled by what the host was doing in them: the harness's
phase of the frame (its own host clock) and the CUDA runtime call the
host was in, if any ("host code" otherwise: Python and the operators'
host side)."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from pathlib import Path

import torch

# a gap shorter than this is counted, not labelled
LABEL_GAP_NS = 20_000
TOP = 10


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    ops: dict             # device operation name -> [count, seconds]
    idle_gaps: list       # [[host label, seconds], ...], largest first
    port_kernels: tuple   # __global__ names of the port's CUDA sources

    def matching(self, pattern: str):
        """(count, seconds) of the device operations whose name holds
        `pattern` (a regular expression)."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.ops.items() if rx.search(k)]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def is_port_kernel(self, name: str) -> bool:
        return any(re.search(rf"\b{k}\b", name) for k in self.port_kernels)


def port_kernel_names(root: Path) -> tuple:
    """The names of the port's CUDA kernels, read from its sources."""
    names = set()
    for src in sorted((root / "clpathtracer_tpu_torch" / "ops" / "csrc")
                      .glob("*.cu")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", src.read_text())
        for m in re.finditer(r"__global__[^;{]*?\b(\w+)\s*\(", text, re.S):
            names.add(m.group(1))
    return tuple(sorted(names))


@contextlib.contextmanager
def profiled():
    """torch.profiler over the scope, device activity only."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _union(intervals):
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _gaps(intervals, t0, t1):
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        out.append((cur, t1))
    return out


def _covering(starts, events, t):
    """The name of the latest-starting event of `events` (sorted (start,
    end, name)) that holds time t, or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, e, name = events[j]
        if e >= t:
            return name
    return None


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def reduce(prof, t0_ns: int, t1_ns: int, port_kernels: tuple,
           phases=()) -> Trace:
    """The window [t0_ns, t1_ns] (the profiler's clock, time.time_ns) of a
    finished profile. phases: the harness's (start_ns, end_ns, name) of
    each frame's phases; time in none is "harness" (between frames)."""
    dev, host = [], []
    ops = {}
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _annotation(e) or end <= t0_ns or s >= t1_ns:
                continue
            s, end = max(s, t0_ns), min(end, t1_ns)
            dev.append((s, end))
            name = e.name()
            rec = ops.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += (end - s) * 1e-9
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((s, end, e.name()))
    host.sort()
    starts = [h[0] for h in host]
    phases = sorted(phases)
    phase_starts = [p[0] for p in phases]
    labels = {}
    for s, e in _gaps(dev, t0_ns, t1_ns):
        if e - s < LABEL_GAP_NS:
            key = "gaps under 20 us"
        else:
            mid = (s + e) // 2
            key = ((_covering(phase_starts, phases, mid) or "harness")
                   + ": " + (_covering(starts, host, mid) or "host code"))
        labels[key] = labels.get(key, 0.0) + (e - s) * 1e-9
    idle = sorted(([k, v] for k, v in labels.items()), key=lambda kv: -kv[1])
    return Trace(busy_s=_union(dev) * 1e-9, window_s=(t1_ns - t0_ns) * 1e-9,
                 ops=ops, idle_gaps=idle[:TOP], port_kernels=port_kernels)


def short_name(name: str) -> str:
    """A device operation's name without its argument list."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return (head[5:] if head.startswith("void ") else head)[:120]


def breakdown(trace: Trace) -> dict:
    top = {}
    for name, (_, sec) in trace.ops.items():
        k = short_name(name)
        top[k] = top.get(k, 0.0) + sec
    ops = sorted(([k, v] for k, v in top.items()), key=lambda kv: -kv[1])
    return {"device_ops": ops[:TOP], "idle_gaps": trace.idle_gaps}
