"""The spans inside a frame (utils/profiling.py::span, recording): off, one
shared no-op that launches no operation and leaves the image bit-equal to
a recorded frame's; on, the tree of render_lanes' spans in normal, mirror
and path+NEE mode on a tiny emissive soup (one 16x32 gate: the windows
route with the plain kernel versions; in path mode the grid or the
shadow tree)."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.accel.sah import build_shadow_tree
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      light_cdf,
                                                      render_image)
from clpathtracer_tpu_torch.scene import procedural as tproc
from clpathtracer_tpu_torch.utils import profiling

torch.set_num_threads(2)
CPU = torch.device("cpu")
W, H = 32, 16

PATH = [("primary", 0), ("shadow", 0), ("bounce", 1), ("shadow", 1)]
NEE = RenderOptions(W, H, mode="path", bounces=2, nee=True, background=0.0)
MODES = {
    # name: (options, the structure beside the windows, the waves' (kind,
    # b) in order)
    "normal": (RenderOptions(W, H), None, [("primary", 0)]),
    "mirror": (RenderOptions(W, H, mode="mirror", bounces=2), None,
               [("primary", 0), ("bounce", 1)]),
    "path-nee": (NEE, "grid", PATH),
    "path-nee-spp2": (RenderOptions(W, H, mode="path", bounces=2, spp=2,
                                    nee=True, background=0.0), "grid",
                      PATH * 2),
    "path-nee-shadow-tree": (NEE, "shadow", PATH),
}
# the spans inside a wave: the windows' primaries (gate prepass, K1,
# resolve); without another structure the other waves' sorted bundles
# (sort and bundle prepass, K1', resolve); the grid's walks (G1) none; the
# shadow tree's walk (W1) its winners' resolve, its any-hit form none
WAVE_SPANS = {(None, "bounce"): {"prepass", "resolve"},
              ("grid", "bounce"): set(), ("grid", "shadow"): set(),
              ("shadow", "bounce"): {"resolve"},
              ("shadow", "shadow"): set()}
# the span names each span may sit directly inside
PARENTS = {"frame": {None}, "rays": {"frame"}, "wave": {"frame", "light"},
           "prepass": {"wave"}, "resolve": {"wave"}, "shade": {"frame"},
           "light": {"frame"}}


@pytest.fixture(scope="module")
def world():
    scene = tproc.random_tri_soup(1500, seed=3, extent=2.0, tri_size=0.2,
                                  emissive_frac=0.05, device=CPU)
    scene = scene.bake_shading()
    mwin = tpl.build_morton_windows(scene.tri_corners(), 2, device=CPU)
    mwin = tpl.attach_resolve(tpl.attach_so(mwin), scene.shade_rows)
    return dict(scene=scene, mwin=mwin,
                grid=build_grid(scene.tri_corners(), device=CPU),
                shadow=build_shadow_tree(scene.tri_corners(), device=CPU),
                lights=light_cdf(scene),
                cam=Camera.create([0.0, 0.0, -4.0], [0.0, 0.0, 1.0],
                                  device=CPU))


def _render(world, mode, seed=0):
    opts, structure, _ = MODES[mode]
    kw = {structure: world[structure]} if structure else {}
    return render_image(world["scene"], world["cam"], opts, world["mwin"],
                        lights=world["lights"], **kw,
                        generator=torch.Generator().manual_seed(seed))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_spans_off_are_one_no_op_and_frames_bit_equal(world):
    assert profiling._recorder is None
    off = profiling.span("wave", kind="primary", b=0)
    assert off is profiling.span("frame") is profiling.span("shade", b=1)
    with _Ops() as seen:
        with profiling.span("wave", kind="primary", b=0):
            pass
        with profiling.recording() as log:
            with profiling.span("frame"), profiling.span("rays"):
                pass
    assert seen.ops == [] and [s.name for s in log] == ["rays", "frame"]
    for mode in MODES:
        plain = _render(world, mode)
        with profiling.recording() as log:
            traced = _render(world, mode)
        assert log and torch.equal(plain, traced), mode
        assert bool(torch.isfinite(plain).all()) and float(plain.sum()) > 0
    assert profiling._recorder is None
    with profiling.recording():
        with pytest.raises(RuntimeError, match="already"):
            with profiling.recording():
                pass


@pytest.mark.parametrize("mode", list(MODES))
def test_spans_nest_as_the_frame_tree(world, mode):
    with profiling.recording() as log:
        _render(world, mode, seed=0)
        _render(world, mode, seed=1)
    by_id = {s.id: s for s in log}
    assert len(by_id) == len(log) and profiling._recorder is None
    frames = [s for s in log if s.name == "frame"]
    assert sorted(f.frame for f in frames) == [0, 1]
    for s in log:
        assert s.start_ns <= s.end_ns
        parent = by_id.get(s.parent)
        assert (parent.name if parent else None) in PARENTS[s.name], s
        if parent:   # inside its parent, in its parent's frame
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.frame == parent.frame
        if s.name == "light" and "b" in s.attrs:   # holds its shadow wave
            assert [(c.attrs["kind"], c.attrs["b"]) for c in log
                    if c.parent == s.id] == [("shadow", s.attrs["b"])]
    opts, structure, waves = MODES[mode]
    for f in frames:
        mine = sorted((s for s in log if s.frame == f.frame),
                      key=lambda s: s.id)          # the order they opened
        got = [s for s in mine if s.name == "wave"]
        assert [(s.attrs["kind"], s.attrs["b"]) for s in got] == waves
        for w in got:
            kind = w.attrs["kind"]
            assert {s.name for s in log if s.parent == w.id} == (
                {"prepass", "resolve"} if kind == "primary"
                else WAVE_SPANS[structure, kind]), w
        names = {s.name for s in mine}
        assert {"frame", "rays", "shade"} <= names
        assert ("light" in names) == opts.nee
        assert {s.attrs["b"] for s in mine if s.name == "shade"
                and "b" in s.attrs} >= {b for _, b in waves}
