"""The span segment's reduction (harness/spans.py) on a made-up profile
and made-up spans: a device operation goes to the innermost span that
holds its launching runtime event, a gap inside a frame to the span that
holds its midpoint, a sync to the span it waits in, and what no span
holds is reported as unattributed; the device stamps' drift from the
host clock changes none of it."""

from types import SimpleNamespace

import torch

from benchmark.harness import spans, trace
from clpathtracer_tpu_torch.utils.profiling import Span
from conftest import ROOT

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
US = 1000


def _ev(name, dev, start, dur, corr=0):
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           start_ns=lambda: start * US,
                           duration_ns=lambda: dur * US,
                           correlation_id=lambda: corr,
                           is_user_annotation=lambda: False)


# one frame [0, 1000) us: rays [10, 100), the primary wave [100, 600)
# holding its prepass [110, 300) and resolve [500, 590), shade [600, 990)
SPANS = [Span("rays", 1, 0, 0, 10 * US, 100 * US, {}),
         Span("prepass", 3, 2, 0, 110 * US, 300 * US, {}),
         Span("resolve", 4, 2, 0, 500 * US, 590 * US, {}),
         Span("wave", 2, 0, 0, 100 * US, 600 * US,
              {"kind": "primary", "b": 0}),
         Span("shade", 5, 0, 0, 600 * US, 990 * US, {"b": 0}),
         Span("frame", 0, None, 0, 0, 1000 * US, {})]
EVENTS = [
    # launched in rays, runs [120, 150)
    _ev("cudaLaunchKernel", CPU, 20, 5, corr=7),
    _ev("at::native::elementwise_kernel<4>", CUDA, 120, 30, corr=7),
    # launched inside the prepass nested in the wave: the prepass's
    _ev("cudaLaunchKernel", CPU, 200, 5, corr=8),
    _ev("at::native::radix_sort<4>", CUDA, 210, 40, corr=8),
    # the port's kernel, launched in the wave's own time
    _ev("cudaLaunchKernel", CPU, 400, 5, corr=9),
    _ev("void plist_super_kernel<false, 2>(float const*)", CUDA, 400, 100,
        corr=9),
    # launched in the resolve, a sync in the shade waits for it
    _ev("cudaLaunchKernel", CPU, 520, 5, corr=10),
    _ev("at::native::gather<4>", CUDA, 520, 180, corr=10),
    _ev("cudaStreamSynchronize", CPU, 650, 50),
    # launched after the frame (the image's copy): no span holds it
    _ev("cudaMemcpyAsync", CPU, 1100, 5, corr=11),
    _ev("Memcpy DtoH (Device -> Pageable)", CUDA, 1100, 50, corr=11),
    _ev("cudaStreamSynchronize", CPU, 1105, 45),
]


def _reduce(events):
    return spans.reduce(events, SPANS, 0, 1200 * US,
                        trace.port_kernel_names(ROOT))


def test_a_kernel_counts_to_the_innermost_span_of_its_launch():
    st = _reduce(EVENTS)
    assert st.unlinked == 0
    assert st.frames == 1
    dev = {k: (v[0], round(v[1] * 1e6), round(v[2] * 1e6),
               round(v[3] * 1e6)) for k, v in st.device.items()}
    assert dev == {"rays": (1, 30, 0, 0), "prepass": (1, 40, 0, 0),
                   "wave.primary": (1, 0, 100, 0),
                   "resolve": (1, 180, 0, 0),
                   spans.OUTSIDE: (1, 0, 0, 50)}
    got = st.metrics()
    assert abs(got["rays_ms"] - 0.03) < 1e-9
    assert abs(got["prepass_ms"] - 0.04) < 1e-9
    assert abs(got["shade_ms"] - 0.18) < 1e-9   # resolve and shade
    assert "light_ms" not in got                # nothing to read
    # every torch kernel sits in a span below the frame
    assert abs(st.covered() - 1.0) < 1e-12


def test_gaps_in_a_frame_go_to_the_span_at_their_midpoint():
    st = _reduce(EVENTS)
    idle = {k: round(v * 1e6) for k, v in st.idle.items()}
    # frame [0, 1000): busy [120, 150), [210, 250), [400, 500), [520,
    # 700); gaps [0, 120) mid 60 in rays, [150, 210) mid 180 in the
    # prepass, [250, 400) mid 325 in the wave's own time, [500, 520) mid
    # 510 in the resolve, [700, 1000) mid 850 in the shade. The gap after
    # the frame is not render_image's.
    assert idle == {"rays": 120, "prepass": 60, "wave.primary": 150,
                    "resolve": 20, "shade": 300}
    assert abs(st.metrics()["render_idle_ms"] - 0.65) < 1e-9


def test_a_sync_counts_to_its_span():
    st = _reduce(EVENTS)
    syncs = {k: (v[0], round(v[1] * 1e6)) for k, v in st.syncs.items()}
    assert syncs == {"shade: cudaStreamSynchronize": (1, 50),
                     f"{spans.OUTSIDE}: cudaStreamSynchronize": (1, 45)}
    lines = spans.comment_lines(st, 1.5, 1.4, 10)
    assert [ln.split(":")[0] for ln in lines] == [
        "# the spans' cost", "# device time by span (a frame; ops matched "
        "by correlation id, 0 unlinked; 100.000% of the torch kernels' "
        "time in a span below the frame)",
        "# idle in render_image by span (ms a frame, 0.65 in all)",
        "# syncs by span (count and host ms a frame)"]


def test_ops_outside_any_span_are_unattributed():
    late = [_ev("cudaLaunchKernel", CPU, 1150, 5, corr=12),
            _ev("at::native::fill<4>", CUDA, 1160, 20, corr=12),
            # a device operation whose launch the profile lacks
            _ev("at::native::copy<4>", CUDA, 1185, 10, corr=99)]
    st = _reduce(EVENTS + late)
    ops, torch_s, _, copy_s = st.device[spans.OUTSIDE]
    assert ops == 3 and round(torch_s * 1e6) == 30
    assert round(copy_s * 1e6) == 50 and st.unlinked == 1
    assert abs(st.covered() - 250 / 280) < 1e-12


def test_the_device_clock_drift_is_taken_out():
    """Device stamps that run ahead of the host clock or behind it by more
    than a span's length read as the unskewed profile: an operation
    counts by its launch, its gaps on the host clock."""
    want = _reduce(EVENTS)
    for drift in (-400, 400):
        moved = [_ev(e.name(), e.device_type(),
                     e.start_ns() // US + (drift if e.device_type() == CUDA
                                           else 0),
                     e.duration_ns() // US, e.correlation_id())
                 for e in EVENTS]
        got = _reduce(moved)
        assert got.device.keys() == want.device.keys() and got.unlinked == 0
        for k, v in want.device.items():
            assert got.device[k][0] == v[0]
            assert all(abs(a - b) < 1e-12 for a, b in
                       zip(got.device[k][1:], v[1:])), k
        assert got.idle.keys() == want.idle.keys()
        assert all(abs(got.idle[k] - v) < 1e-12 for k, v in want.idle.items())


def test_a_drift_across_frames_is_taken_out():
    """Two frames whose device stamps run 2% fast against the host clock
    (the lag grows from frame to frame) read as two undrifted frames."""
    step = 1200
    spans2 = SPANS + [s._replace(id=s.id + 10, frame=1,
                                 parent=None if s.parent is None
                                 else s.parent + 10,
                                 start_ns=s.start_ns + step * US,
                                 end_ns=s.end_ns + step * US)
                      for s in SPANS]
    events2 = EVENTS + [_ev(e.name(), e.device_type(),
                            e.start_ns() // US + step, e.duration_ns() // US,
                            e.correlation_id() + 100 if e.correlation_id()
                            else 0) for e in EVENTS]

    def drift(e):
        if e.device_type() != CUDA:
            return e
        s, d = e.start_ns() // US, e.duration_ns() // US
        return _ev(e.name(), CUDA, s * 1.02, d * 1.02, e.correlation_id())

    ports = trace.port_kernel_names(ROOT)
    want = spans.reduce(events2, spans2, 0, 2 * step * US, ports)
    got = spans.reduce([drift(e) for e in events2], spans2, 0,
                       2 * step * US, ports)
    assert want.frames == got.frames == 2
    assert {k: round(v * 1e6) for k, v in want.idle.items()} == {
        "rays": 240, "prepass": 120, "wave.primary": 300, "resolve": 40,
        "shade": 600}
    assert got.idle.keys() == want.idle.keys()
    assert all(abs(got.idle[k] - v) < 1e-6 for k, v in want.idle.items())

