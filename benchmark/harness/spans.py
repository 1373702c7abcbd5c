"""The spans inside render_image against the device trace: which span
launched each device operation, how long the device idles while a frame
is open, and where the host waits for it.

The port records its spans (clpathtracer_tpu_torch/utils/profiling.py::
span) only inside profiling.recording(), on time.time_ns, the clock that
torch.profiler stamps its events with. The span segment runs frames under
both; reduce() then gives each device operation (a kernel, a copy, a set)
to the innermost span open when the host launched it: the CUDA runtime
event that launched it carries the same correlation id
(_KinetoEvent.correlation_id()), and that event's start lies inside the
span. A device operation whose id no runtime event of the profile carries
is unattributed, and the reduction counts it (`unlinked`): a profile
without the ids shows as every operation unlinked.

A span's device time is its self time: the operations launched while it
is the innermost open span, in the spans' tree (frame > rays, wave{kind,
b} > prepass and resolve, shade{b}, light{b} > the shadow wave)."""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
import time

import torch

from benchmark.harness import trace as traces

FRAMES = 32   # frames of the span segment
# the runtime calls in which the host waits for the device
SYNCS = ("cudaStreamSynchronize", "cudaMemcpy", "cudaDeviceSynchronize")
OUTSIDE = "unattributed"   # the key of what no span holds
# the per-layer quantities: span keys whose torch kernels they sum
LAYERS = {"rays_ms": ("rays",), "prepass_ms": ("prepass",),
          "shade_ms": ("resolve", "shade"), "light_ms": ("light",)}


@dataclasses.dataclass
class SpanTrace:
    frames: int           # frame spans in the segment
    device: dict          # span key -> [ops, torch s, port s, copy+set s]
    idle: dict            # span key -> device idle seconds in frame spans
    syncs: dict           # "<span key>: <call>" -> [count, host s]
    unlinked: int         # device operations no runtime event launched

    def per_frame_ms(self, keys) -> float:
        """Torch kernels' seconds of the spans under `keys` (a key or its
        "<key>.<kind>" parts), ms a frame; None where none ran."""
        got = [v[1] for k, v in self.device.items()
               if k.split(".")[0] in keys]
        return 1000.0 * sum(got) / self.frames if got and self.frames \
            else None

    def metrics(self) -> dict:
        """rays_ms, prepass_ms, shade_ms, light_ms and render_idle_ms,
        each a frame's; a quantity with nothing to read is left out."""
        out = {name: self.per_frame_ms(keys) for name, keys in
               LAYERS.items()}
        if self.frames:
            out["render_idle_ms"] = (1000.0 * sum(self.idle.values())
                                     / self.frames)
        return {k: v for k, v in out.items() if v is not None}

    def covered(self) -> float:
        """The share of the torch kernels' device time (the kernels that
        are not the port's, as torch_ops_ms counts them) that a span
        other than the frame holds."""
        total = sum(v[1] for v in self.device.values())
        loose = sum(self.device.get(k, [0, 0.0])[1]
                    for k in (OUTSIDE, "frame"))
        return 1.0 - loose / total if total > 0 else 0.0


def _key(s) -> str:
    kind = s.attrs.get("kind")
    return f"{s.name}.{kind}" if kind else s.name


class _Tree:
    """Innermost-span lookup over a recording's spans."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, s.id))
        self.starts = [s.start_ns for s in self.spans]
        self.by_id = {s.id: s for s in self.spans}

    def innermost(self, t):
        """The innermost span holding time t, or None. Spans nest, so it
        is the latest-starting span at or before t or an ancestor of it."""
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s.end_ns < t:
            s = self.by_id.get(s.parent)
        return s


class _Lag:
    """The device stamps' lag behind the host clock, from each frame's
    operations. A frame starts on an idle device (the last frame's image
    has reached the host), so its operation with the least lag from
    launch to start started as it was launched, give or take the launch
    latency (some microseconds): that lag at that launch is the frame's
    anchor. Between two anchors the lag is their line, before the first
    and after the last the line of the nearest two."""

    def __init__(self, frames):
        self.anchors = sorted(min(((at, s - at) for s, _, at in ops),
                                  key=lambda a: a[1])
                              for ops in frames if ops)

    def at(self, t) -> float:
        a = self.anchors
        if len(a) < 2:
            return a[0][1] if a else 0
        i = min(max(bisect.bisect_right(a, (t,)), 1), len(a) - 1)
        (x0, y0), (x1, y1) = a[i - 1], a[i]
        return y0 + (y1 - y0) * (t - x0) / (x1 - x0)

    def host(self, t_dev) -> float:
        """A device stamp on the host clock."""
        return t_dev - self.at(t_dev - self.at(t_dev))


def _port_rx(port_kernels):
    return re.compile(r"\b(" + "|".join(map(re.escape, port_kernels))
                      + r")\b") if port_kernels else None


def reduce(events, spans, t0_ns: int, t1_ns: int,
           port_kernels: tuple) -> SpanTrace:
    """The segment [t0_ns, t1_ns] of a finished profile's events
    (prof.profiler.kineto_results.events()) against the spans recorded
    over it (profiling.recording()'s log).

    The runtime events keep the host clock that the spans read; the
    device events' stamps drift from it, by up to a millisecond a frame
    and tens of milliseconds over a profile. So a device operation is in
    the segment when its launch is, and its whole duration counts; and
    idle time is read on the host clock, the device stamps moved back by
    their lag (_Lag)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        s = e.start_ns()
        rec = (s, s + e.duration_ns(), e.name(), e.correlation_id())
        if e.device_type() != cuda:
            host.append(rec)
        elif not traces._annotation(e):
            dev.append(rec)
    dev.sort()
    host.sort()
    launched = {c: s for s, _, _, c in host if c}
    starts = [launched.get(c) for _, _, _, c in dev]
    tree = _Tree(spans)
    port = _port_rx(port_kernels)
    device, by_frame, unlinked = {}, {}, 0
    for (s, end, name, _), at in zip(dev, starts):
        if at is None:   # launched by no runtime event of the profile
            if end <= t0_ns or s >= t1_ns:
                continue
            unlinked += 1
            span = None
        elif t0_ns <= at < t1_ns:
            span = tree.innermost(at)
        else:
            continue
        rec = device.setdefault(_key(span) if span else OUTSIDE,
                                [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        kind = (3 if name.startswith(("Memcpy", "Memset")) else
                2 if port is not None and port.search(name) else 1)
        rec[kind] += (end - s) * 1e-9
        if span is not None and span.frame is not None:
            by_frame.setdefault(span.frame, []).append((s, end, at))
    idle = {}
    frames = [s for s in spans if s.name == "frame"]
    lag = _Lag(by_frame.values())
    for f in frames:
        busy = [(max(lag.host(s), f.start_ns), min(lag.host(e), f.end_ns))
                for s, e, _ in by_frame.get(f.frame, [])]
        for a, b in traces._gaps([(s, e) for s, e in busy if e > s],
                                 f.start_ns, f.end_ns):
            span = tree.innermost((a + b) // 2)
            k = _key(span) if span else OUTSIDE
            idle[k] = idle.get(k, 0.0) + (b - a) * 1e-9
    syncs = {}
    for s, end, name, _ in host:
        if name in SYNCS and t0_ns <= s < t1_ns:
            span = tree.innermost(s)
            rec = syncs.setdefault(
                f"{_key(span) if span else OUTSIDE}: {name}", [0, 0.0])
            rec[0] += 1
            rec[1] += (end - s) * 1e-9
    return SpanTrace(frames=len(frames), device=device, idle=idle,
                     syncs=syncs, unlinked=unlinked)


def segment(system, k0: int, port_kernels: tuple, frames: int = FRAMES):
    """Frames k0 + 1 .. k0 + frames, each render_image and its image on
    the host, under profiling.recording() and the device-only profiler of
    the traced half: (SpanTrace, seconds of the frames); None where the
    program records no spans. The profile holds one frame more before
    them and two after, unrecorded: its first few device records and its
    last ones go missing (up to 5 of a frame's first and 147 of its last,
    on the H100), and a device operation counts by its launch."""
    from clpathtracer_tpu_torch.utils import profiling
    if not hasattr(profiling, "recording"):
        return None
    with traces.profiled() as prof:
        system.render(k0).cpu()
        with profiling.recording() as log:
            ns0, t0 = time.time_ns(), time.perf_counter()
            for k in range(k0 + 1, k0 + 1 + frames):
                system.render(k).cpu()
            ns1, t1 = time.time_ns(), time.perf_counter()
        for k in range(k0 + 1 + frames, k0 + 3 + frames):
            system.render(k).cpu()
    return reduce(prof.profiler.kineto_results.events(), log, ns0, ns1,
                  port_kernels), t1 - t0


def _ms(x, frames):
    return round(1000.0 * x / frames, 4)


def comment_lines(st: SpanTrace, span_frame_ms: float,
                  traced_frame_ms: float, traced_frames: int) -> list:
    """The span segment's four stderr lines: the spans' cost, device time
    by span, idle in render_image by span, syncs by span."""
    n = max(st.frames, 1)
    dev = {k: {"torch_ms": _ms(v[1], n), "port_ms": _ms(v[2], n),
               "copy_ms": _ms(v[3], n), "ops": round(v[0] / n, 2)}
           for k, v in sorted(st.device.items(), key=lambda kv: -kv[1][1])}
    idle = {k: _ms(v, n) for k, v in
            sorted(st.idle.items(), key=lambda kv: -kv[1])}
    syncs = {k: [round(v[0] / n, 2), _ms(v[1], n)] for k, v in
             sorted(st.syncs.items(), key=lambda kv: -kv[1][1])}
    return [
        f"# the spans' cost: {span_frame_ms} ms a frame with spans "
        f"recorded ({st.frames} frames), {traced_frame_ms} ms a frame "
        f"traced without ({traced_frames} frames)",
        f"# device time by span (a frame; ops matched by correlation id, "
        f"{st.unlinked} unlinked; {100.0 * st.covered():.3f}% of the torch "
        f"kernels' time in a span below the frame): " + json.dumps(dev),
        f"# idle in render_image by span (ms a frame, "
        f"{_ms(sum(st.idle.values()), n)} in all): " + json.dumps(idle),
        "# syncs by span (count and host ms a frame): " + json.dumps(syncs),
    ]
