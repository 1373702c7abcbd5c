"""Stage timers and spans (the port's counterpart of
clpathtracer_tpu/utils/profiling.py).

The reference instruments with printf wall-timers (src/model.c:136-143)
and an unused in-kernel step counter (src/kernel.cl:319-331). Here:
structured stage timers, and spans inside a frame on the host clock that
torch.profiler stamps its events with (time.time_ns), so that a reader of
a device trace can give each device operation to the span that launched
it.

Spans: `with span(name, **attrs):` marks a scope of the frame. Recording
is off unless a caller turns it on for a scope (`with recording() as
log:`); off, span() returns one shared object whose scope does nothing.
On, each span closed appends a Span to the log: its name, its id, the id
of the innermost span open when it started (its parent), the id of the
frame it belongs to (the innermost open "frame" span's, a counter of
frames from 0), its start and end (time.time_ns) and its attributes.
Span code reads the host clock only: it launches no device operation and
waits for none, on or off. Recording is of one thread, the one that
renders.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import NamedTuple, Optional

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


class Span(NamedTuple):
    """One closed span of a recording."""
    name: str
    id: int
    parent: Optional[int]     # the innermost span open at its start
    frame: Optional[int]      # its frame's id (None outside a frame)
    start_ns: int             # time.time_ns
    end_ns: int
    attrs: dict


class _Off:
    """The scope of a span while recording is off: nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """A recording's log and its open spans (innermost last)."""

    def __init__(self):
        self.log = []
        self.open = []
        self.spans = 0
        self.frames = 0


_recorder: Optional[_Recorder] = None


class _On:
    """The scope of one span while recording is on."""
    __slots__ = ("rec", "name", "attrs", "id", "parent", "frame", "start")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        outer = rec.open[-1] if rec.open else None
        self.id = rec.spans
        rec.spans += 1
        self.parent = outer.id if outer else None
        if self.name == "frame":
            self.frame = rec.frames
            rec.frames += 1
        else:
            self.frame = outer.frame if outer else None
        rec.open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rec.open.pop()
        self.rec.log.append(Span(self.name, self.id, self.parent, self.frame,
                                 self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """The scope of a span `name` with attributes attrs (a context
    manager): recorded when recording() is on, else the shared no-op."""
    if _recorder is None:
        return _OFF
    return _On(_recorder, name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans over the scope; yields the log, a list of Span in the
    order the spans closed."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = _Recorder()
    try:
        yield _recorder.log
    finally:
        _recorder = None
