"""Whole runs of every cell at a tiny size on the CPU (the look for a
card skipped): correct with the port as it is, not correct with the timed
path broken underneath in each way the cells can be, nor with the
control, the reference with its pair test in bfloat16, in the program's
place."""

import functools
import time

import pytest
import torch

from benchmark.harness import run_cell
from benchmark.reference import inputs, render
from conftest import CELLS, tiny

CPU = torch.device("cpu")
SEED = 2**31 + 101


def _run(cell, seconds=0.5):
    res, lines = run_cell.run(cell, SEED, seconds, False, CPU, time.time())
    assert res["attempted"] > 0 and lines
    return res


@pytest.mark.parametrize("name", CELLS)
def test_port_is_correct(cells, name):
    res = _run(tiny(cells[name]))
    assert res["correct"], res["check"]
    got = set(res["metrics"])
    assert "setup_s" in got and any(n.startswith("frame_ms") for n in got)
    assert got == {m["name"] for m in cells[name].end_to_end}
    assert list(res)[-1] == "check"


def _frozen(monkeypatch):
    """A frame that returns its state unchanged: every call gives the
    first call's image."""
    from clpathtracer_tpu_torch.render import integrator
    real, first = integrator.render_image, []

    def stale(*a, **kw):
        if not first:
            first.append(real(*a, **kw))
        return first[0].clone()
    monkeypatch.setattr(integrator, "render_image", stale)


def _half_lanes(monkeypatch):
    """Half of the batch left out: every other ray of the primary wave
    takes no part (K1 reports a miss for it)."""
    from clpathtracer_tpu_torch.ops import plist
    real = plist.plist_super

    @functools.wraps(real)
    def half(*a, **kw):
        t, slot, stats = real(*a, **kw)
        slot = slot.clone()
        slot[::2] = -1
        return t, slot, stats
    monkeypatch.setattr(plist, "plist_super", half)


def _half_samples(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: a path
    frame averages half of its samples."""
    import dataclasses

    from clpathtracer_tpu_torch.render import integrator
    real = integrator.render_image

    def half(scene, camera, opts, mwin=None, *, jitter=None, bounce=None,
             light=None, **kw):
        h = opts.spp // 2
        return real(scene, camera, dataclasses.replace(opts, spp=h), mwin,
                    jitter=jitter[:h], bounce=bounce[:h], light=light[:h],
                    **kw)
    monkeypatch.setattr(integrator, "render_image", half)


def _altered(monkeypatch):
    """An answer altered where it is produced: K1 names the record next
    to the winner for every fourth ray."""
    from clpathtracer_tpu_torch.ops import plist
    real = plist.plist_super

    @functools.wraps(real)
    def alter(*a, **kw):
        t, slot, stats = real(*a, **kw)
        slot = slot.clone()
        sel = slot[::4]
        slot[::4] = torch.where(sel >= 0, sel ^ 1, sel)
        return t, slot, stats
    monkeypatch.setattr(plist, "plist_super", alter)


FAULTS = {"frozen": _frozen, "half_lanes": _half_lanes,
          "half_samples": _half_samples, "altered": _altered}
# the faults each cell can have: a frame of one sample has no mean
CASES = [(f, c) for f in sorted(FAULTS) for c in CELLS
         if f != "half_samples" or ".path-" in c]


@pytest.mark.parametrize("fault,name", CASES)
def test_faults_are_not_correct(cells, monkeypatch, name, fault):
    cell = tiny(cells[name])
    FAULTS[fault](monkeypatch)
    res = _run(cell, seconds=1.0 if fault == "frozen" else 0.5)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cells, monkeypatch, name):
    """The control in the program's place: every frame the bfloat16
    reference's image. 20k triangles: small enough triangles that bf16's
    rounding of coordinates near 10 (0.03-0.06) shows, as at 1M."""
    from benchmark.harness import system as system_mod
    cell = tiny(cells[name], num_tris=20000)
    arrays = {}

    def control(self, k):
        if "scene" not in arrays:
            arrays["scene"] = render.Scene(inputs.make_scene(
                cell.config["scene"], SEED), CPU)
        tr = cell.traffic
        pos, fwd = inputs.pose(cell.config["camera"], SEED, k)
        pix = torch.arange(tr["width"] * tr["height"])
        img = render.frame_pixels(arrays["scene"], tr, cell.config["camera"],
                                  pos, fwd, pix,
                                  inputs.frame_draws(self.draws, k),
                                  torch.bfloat16)
        return img.float().reshape(tr["height"], tr["width"], 3)
    monkeypatch.setattr(system_mod.System, "render", control)
    res = _run(cell)
    assert not res["correct"], res["check"]
