"""The spans inside render_image in one cell (not run by run.py):

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 10]

One process: the cell's set-up as run.py makes it, an untraced window of
`seconds` / 2, a traced window of `seconds` / 2 under the device-only
torch.profiler of run.py's traced half, then the span segment (32 frames
under the same profiler with the port's spans recorded; harness/
spans.py). Prints the segment's four comment lines on stderr and one JSON
line: the frame times of the three windows, the device operations a
frame of the traced window and of the segment (the same launches whether
spans record or not), the traced window's torch_ops_ms and
device_idle_pct as run.py's readers compute them, and the segment's
rays_ms, prepass_ms, shade_ms, light_ms and render_idle_ms. A program
without spans gives the first two windows alone. These are readings of a
diagnostic, not the benchmark's metrics: run.py does not run the segment.

The windows are run_cell._frames, run.py's own frame loop, with nothing
kept for the check. The set-up repeats run_cell.run's steps (cache_dirs,
load_kernels, make_scene, System, the warm-up frames): run_cell.run makes
the set-up, the window and the check in one function, and a file the
benchmark already has is not edited here to split it. Like run.py, the
script refuses to print a result from a process that loaded JAX or the
JAX package (run_cell._forbidden_modules)."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _nothing(k, host):
    """The windows keep no frame: the segment runs no check."""


def main(argv):
    import torch

    from benchmark.harness import manifest, run_cell
    from benchmark.harness import spans as spanlib
    from benchmark.harness import trace as traces
    from benchmark.harness.system import System
    from benchmark.reference import inputs

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    run_cell.cache_dirs(ROOT)
    if not torch.cuda.is_available():
        sys.exit("the span segment needs a CUDA device")
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    device = torch.device("cuda", 0)
    cell = manifest.load_cell(a.workload)
    timer = run_cell.Stages()
    torch.cuda.set_device(device)
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    load_kernels()
    arrays = inputs.make_scene(cell.config["scene"], a.seed)
    system = System(arrays, cell, a.seed, device, timer)
    for j in range(int(cell.traffic["warmup_frames"])):
        system.render(j).cpu()
    ports = traces.port_kernel_names(manifest.ROOT)
    plain = run_cell._frames(system, a.seconds / 2, 0, _nothing)
    with traces.profiled() as prof:
        ns0 = time.time_ns()
        traced = run_cell._frames(system, a.seconds / 2, plain.frames,
                                  _nothing)
        ns1 = time.time_ns()
    k = plain.frames + traced.frames
    tr = traces.reduce(prof, ns0, ns1, ports, traced.phases)
    del prof
    line = {"workload": a.workload, "seed": a.seed,
            "device": torch.cuda.get_device_name(device),
            "frame_ms": 1000.0 * plain.seconds / plain.frames,
            "traced_frame_ms": 1000.0 * traced.seconds / traced.frames,
            "traced_ops_a_frame": sum(v[0] for v in tr.ops.values())
            / traced.frames}
    rec = run_cell.Record(frames=plain.frames, frame_s=plain.frame_s,
                          dispatch_s=plain.dispatch_s,
                          window_s=plain.seconds, setup_s=0.0, builds={},
                          counters={}, trace=tr,
                          traced_frames=traced.frames)
    for name in ("torch_ops_ms", "device_idle_pct"):
        line[name] = manifest.reader(cell.bench_dir, name).read(rec)
    got = spanlib.segment(system, k, ports)
    if got is None:
        print("# the program records no spans: no span segment",
              file=sys.stderr)
    else:
        st, s_spans = got
        line["span_frame_ms"] = 1000.0 * s_spans / spanlib.FRAMES
        line["span_ops_a_frame"] = (sum(v[0] for v in st.device.values())
                                    / spanlib.FRAMES)
        line["covered_pct"] = 100.0 * st.covered()
        line["metrics"] = st.metrics()
        for text in spanlib.comment_lines(st, line["span_frame_ms"],
                                          line["traced_frame_ms"],
                                          traced.frames):
            print(text, file=sys.stderr)
    forbidden = run_cell._forbidden_modules()
    if forbidden:
        sys.exit(f"the run loaded {', '.join(forbidden)}: the benchmark's "
                 "process imports no JAX and no JAX package")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
