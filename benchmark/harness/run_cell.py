"""One run of one cell: set-up, the measured window, the check, the
result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (its seconds are setup_s, from the process start to the first
timed frame): the CUDA context and the port's kernels (built into the
port's own build directory at a checkout's first run, which the result
line's `setup_stages` shows apart), the scene made from the seed, the
structures, the draws, and warm-up frames at poses spread over the camera
path. The window: frames back to back, one in flight, each render_image
and then the image on the host, until `seconds` have passed. With
--trace 1 its first half runs as with --trace 0 and gives the host-clock
metrics, and its second half runs under torch.profiler (device activity
only) and gives the device metrics. Then the program's state is freed and
the reference checks a sample of the window's frames."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from benchmark.harness import check as checks
from benchmark.harness import manifest, trace as traces
from benchmark.harness.system import System
from benchmark.reference import inputs

FORBIDDEN = ("jax", "jaxlib", "flax", "clpathtracer_tpu")


class Stages:
    """Named set-up stages on the host clock; a CUDA device is synchronised
    before a stage's clock stops."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name, device):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self.times[name] = (self.times.get(name, 0.0)
                                + time.perf_counter() - t0)


@dataclasses.dataclass
class Record:
    """What a run measured, as the metric readers see it. frames, frame_s,
    dispatch_s and window_s are the untraced window's (with --trace 1 its
    first half); trace and traced_frames the traced half's."""
    frames: int
    frame_s: list          # each frame, dispatch to image on the host
    dispatch_s: list       # each render_image call, to its return
    window_s: float
    setup_s: float
    builds: dict           # set-up stage -> seconds
    counters: dict         # "module:attr.path" -> change in the traced half
    trace: object = None   # trace.Trace of a --trace 1 run
    traced_frames: int = 0

    def device_ms(self, pattern: str):
        """A frame's device time of the operations whose name holds
        `pattern`; None without a trace or a match."""
        if self.trace is None or not self.traced_frames:
            return None
        n, sec = self.trace.matching(pattern)
        return 1000.0 * sec / self.traced_frames if n else None


@dataclasses.dataclass
class Window:
    """Frames back to back from frame k0 for `seconds`."""
    k0: int
    frame_s: list = dataclasses.field(default_factory=list)
    dispatch_s: list = dataclasses.field(default_factory=list)
    phases: list = dataclasses.field(default_factory=list)  # time_ns spans
    seconds: float = 0.0

    @property
    def frames(self):
        return len(self.frame_s)


def _frames(system, seconds, k0, take):
    """Frames k0, k0 + 1, ... until `seconds` have passed, each
    render_image and then its image on the host; take(k, image on the
    host) keeps what the check needs. The host clock marks each frame's
    phases (time.time_ns, the profiler's clock) for the trace's gaps."""
    w = Window(k0)
    w0 = time.perf_counter()
    k = k0
    while True:
        n0, t0 = time.time_ns(), time.perf_counter()
        img = system.render(k)
        n1, t1 = time.time_ns(), time.perf_counter()
        host = img.cpu()
        n2, t2 = time.time_ns(), time.perf_counter()
        w.frame_s.append(t2 - t0)
        w.dispatch_s.append(t1 - t0)
        w.phases += [(n0, n1, "render_image"), (n1, n2, "to_host")]
        take(k, host)
        k += 1
        if t2 - w0 >= seconds:
            break
    w.seconds = time.perf_counter() - w0
    del img
    return w


def _counter(path: str):
    mod, attrs = path.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return obj


def _forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False):
    """One run. Returns (result dict for the last line, check lines)."""
    timer = Stages()
    timer.times["imports"] = time.time() - t_start
    if device.type == "cuda":
        with timer.stage("cuda_context", device):
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)
        with timer.stage("kernels", device):
            from clpathtracer_tpu_torch.ops._cuda import load_kernels
            load_kernels()
        torch.cuda.reset_peak_memory_stats(device)
    with timer.stage("scene_arrays", device):
        arrays = inputs.make_scene(cell.config["scene"], seed)
    system = System(arrays, cell, seed, device, timer)
    warm = int(cell.traffic["warmup_frames"])
    with timer.stage("warmup", device):
        for j in range(warm):
            system.render(j).cpu()
    readers = {m["name"]: manifest.reader(cell.bench_dir, m["name"])
               for m in cell.end_to_end + cell.per_layer}
    counter_paths = sorted({r.COUNTER for r in readers.values()
                            if getattr(r, "COUNTER", None)})
    n_pix = cell.traffic["width"] * cell.traffic["height"]
    per_frame = int(cell.limits["pixels"])
    captured, failed = {}, [0]

    def take(k, host):
        pix = inputs.sample_pixels(seed, k, n_pix, per_frame)
        vals = host.reshape(-1, 3)[torch.from_numpy(pix)].numpy()
        captured[k] = (pix, vals)
        failed[0] += int(not np.isfinite(vals).all())

    gc.collect()
    gc.freeze()
    setup_s = time.time() - t_start
    win = _frames(system, seconds / 2 if traced else seconds, 0, take)
    prof_win, prof = None, None
    before = {p: _counter(p) for p in counter_paths}
    if traced:
        with traces.profiled() as prof:
            ns0 = time.time_ns()
            prof_win = _frames(system, seconds - win.seconds, win.frames,
                               take)
            ns1 = time.time_ns()
    k = win.frames + (prof_win.frames if prof_win else 0)
    failed = failed[0]
    counters = {p: _counter(p) - before[p] for p in counter_paths}
    forbidden = _forbidden_modules()
    if forbidden:
        raise SystemExit(f"the run loaded {', '.join(forbidden)}: the "
                         "benchmark's process imports no JAX and no JAX "
                         "package")
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": 1,
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                    device)) if device.type == "cuda" else 0)}
    trace = None
    if prof is not None:
        trace = traces.reduce(prof, ns0, ns1,
                              traces.port_kernel_names(manifest.ROOT),
                              prof_win.phases)
        dev_info["busy_s"] = trace.busy_s
        dev_info["window_s"] = trace.window_s
        print(f"# the profiler's cost: {1000 * win.seconds / win.frames} ms "
              f"a frame untraced ({win.frames} frames), "
              f"{1000 * prof_win.seconds / prof_win.frames} ms traced "
              f"({prof_win.frames} frames)", file=sys.stderr)
    print("# set-up stages (s): " + json.dumps(
        {name: round(sec, 3) for name, sec in timer.times.items()}),
        file=sys.stderr)
    rec = Record(frames=win.frames, frame_s=win.frame_s,
                 dispatch_s=win.dispatch_s, window_s=win.seconds,
                 setup_s=setup_s, builds=timer.times, counters=counters,
                 trace=trace,
                 traced_frames=prof_win.frames if prof_win else 0)
    del prof
    system.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = checks.check(cell, seed, arrays, system.draws, captured, device,
                       control=control)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        r = readers[m["name"]]
        value = r.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if traced and getattr(r, "PATTERN", None) and trace is not None:
            n_dev, _ = trace.matching(r.PATTERN)
            launches = counters.get(getattr(r, "COUNTER", None))
            print(f"# {m['name']}: {n_dev} device launches match "
                  f"{r.PATTERN!r}; the wrapper counted {launches}",
                  file=sys.stderr)
    numbers = {name: {"value": got[name], "limit": spec["limit"]}
               for name, spec in cell.limits["numbers"].items()}
    correct = (k > 0 and failed == 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    result = {"correct": correct, "attempted": k, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace is not None:
        result["breakdown"] = traces.breakdown(trace)
    result["setup_stages"] = dict(timer.times)
    if control:
        result.update({key: got[key] for key in ("control_bad_px", "bad",
                                                  "explained_bad")})
    result["check"] = numbers     # the compared numbers come last
    lines = [f"check {name}: {v['value']} limit {v['limit']} "
             f"({got['compared_px']} pixels of {got['compared_frames']} "
             "frames)" for name, v in numbers.items()]
    return result, lines


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root):
    """Kernel caches at fixed paths inside the checkout."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def main(argv, t_start: float) -> int:
    args = _args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    device = torch.device("cuda", 0)
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace),
                        device, t_start)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
