"""Tracing, profiling and metrics (the port's counterpart of
clpathtracer_tpu/utils/profiling.py).

The reference instruments with printf wall-timers (src/model.c:136-143)
and an unused in-kernel step counter (src/kernel.cl:319-331). Here:
structured stage timers, a torch.profiler trace exported for Chrome or
Perfetto, and JSON-line metric emission (the bench contract's format).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Optional

import torch


class StageTimer:
    """Named wall-clock stages, reportable as a dict or JSON line.

    >>> t = StageTimer()
    >>> with t.stage("build"): ...
    >>> t.report()  # {"build": 1.23}

    CUDA work is asynchronous: stage(name, device=d) synchronises the CUDA
    device d before the clock stops, so that a stage's time includes the
    device work it queued (and not the next stage's wait for it)."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)

    def report(self) -> dict:
        return dict(self.times)

    def emit(self, file=sys.stderr, **extra):
        print(json.dumps({**self.times, **extra}), file=file, flush=True)


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """torch.profiler over the scope (host and, where there is a CUDA
    device, device activity), exported as a Chrome trace to `path`
    (viewable in Perfetto). No-op when path is None. Yields the profiler
    (None when off) for key_averages()."""
    if path is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def emit_metric(metric: str, value: float, unit: str,
                vs_baseline: Optional[float] = None, file=None,
                **extra) -> dict:
    """One JSON metric line (the bench contract). `file` defaults to
    sys.stdout at call time."""
    rec = {"metric": metric, "value": value, "unit": unit}
    if vs_baseline is not None:
        rec["vs_baseline"] = vs_baseline
    rec.update(extra)
    print(json.dumps(rec), file=file if file is not None else sys.stdout,
          flush=True)
    return rec
