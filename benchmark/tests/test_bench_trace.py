"""The device trace's reduction on a made-up profile: busy time as the
union of device intervals inside the window, idle gaps labelled by the
harness's frame phase and the host's runtime call, kernels matched by
name."""

from types import SimpleNamespace

import torch

from benchmark.harness import trace
from conftest import ROOT

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, dev, start, dur, annotation=False):
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           start_ns=lambda: start, duration_ns=lambda: dur,
                           is_user_annotation=lambda: annotation)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_reduce_unions_device_time_and_labels_gaps():
    us = 1000
    events = [
        _ev("void plist_super_kernel<false, 2>(float const*)", CUDA, 0,
            100 * us),
        _ev("at::native::elementwise_kernel<4>", CUDA, 50 * us, 120 * us),
        _ev("Memcpy DtoH (Device -> Pageable)", CUDA, 400 * us, 50 * us),
        _ev("void ray_walk_kernel(float4 const*)", CUDA, 900 * us, 200 * us),
        _ev("cudaLaunchKernel", CPU, 150 * us, 10 * us),
        _ev("cudaStreamSynchronize", CPU, 200 * us, 100 * us),
    ]
    phases = [(0, 300 * us, "render_image"), (300 * us, 600 * us, "to_host")]
    tr = trace.reduce(_prof(events), 0, 1000 * us,
                      trace.port_kernel_names(ROOT), phases)
    # busy: [0, 170) + [400, 450) + [900, 1000) (the walk cut at the end)
    assert abs(tr.busy_s - 320e-6) < 1e-12
    assert abs(tr.window_s - 1e-3) < 1e-12
    gaps = dict(tr.idle_gaps)
    # [170, 400): midpoint 285 lies in the sync, inside render_image
    assert abs(gaps["render_image: cudaStreamSynchronize"] - 230e-6) < 1e-12
    # [450, 900): midpoint 675, after the frame's phases, in no call
    assert abs(gaps["harness: host code"] - 450e-6) < 1e-12
    assert tr.matching(r"plist_super_kernel<false") == (1, 100e-6)
    assert tr.matching(r"ray_walk_kernel")[0] == 1
    assert tr.is_port_kernel("void ray_walk_kernel(float4 const*)")
    assert not tr.is_port_kernel("at::native::elementwise_kernel<4>")
    assert "ray_walk_kernel" in tr.port_kernels
    assert "__launch_bounds__" not in tr.port_kernels
    bd = trace.breakdown(tr)
    assert bd["device_ops"][0][0] == "at::native::elementwise_kernel<4>"
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_readers_of_the_trace():
    from benchmark.harness import manifest
    from benchmark.harness.run_cell import Record
    us = 1000
    events = [_ev("void plist_super_kernel<true, 4>(float const*)", CUDA, 0,
                  600 * us),
              _ev("void plist_super_kernel<false, 2>(float const*)", CUDA,
                  600 * us, 100 * us),
              _ev("at::native::gather<4>", CUDA, 700 * us, 100 * us),
              _ev("Memcpy DtoH", CUDA, 800 * us, 100 * us)]
    tr = trace.reduce(_prof(events), 0, 1000 * us,
                      trace.port_kernel_names(ROOT))
    rec = Record(frames=5, frame_s=[], dispatch_s=[], window_s=1e-3,
                 setup_s=0.0, builds={}, counters={}, trace=tr,
                 traced_frames=2)
    read = {n: manifest.reader(ROOT / "benchmark", n).read(rec)
            for n in ("k1_ms", "k1p_ms", "g1_ms", "torch_ops_ms",
                      "device_idle_pct", "k1_ms.preview")}
    assert abs(read["k1p_ms"] - 0.3) < 1e-9 and abs(read["k1_ms"] - 0.05) < 1e-9
    assert read["g1_ms"] is None           # nothing to read: left out
    assert abs(read["torch_ops_ms"] - 0.05) < 1e-9
    assert abs(read["device_idle_pct"] - 10.0) < 1e-9
    assert read["k1_ms.preview"] == read["k1_ms"]   # per traced frame
