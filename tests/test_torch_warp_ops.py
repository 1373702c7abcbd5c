"""The warp-issued count of the plain MT test (ops/packet.py::mt_pairs with
a 7-lane tally, warp_ops) on a hand-built case whose exits are known.

Two records against 64 lanes (two warps of 32). Record 0 is the triangle
v0 = 0, e1 = x, e2 = y; record 1 the same moved by +10 along x. A lane
looking down -z from (ox, oy, 1) has det = 1, u = ox - v0.x, v = oy and
t = 1; a lane looking up +z has det = -1. So:

- warp 0: lanes 0-31 look up (they leave at det), but lane 5, which hits
  record 0 and leaves record 1 at u;
- warp 1: lanes 32-47 leave at u (ox = 2), lanes 48-63 at v (oy = -1) on
  record 0; every lane of warp 1 leaves record 1 at u.
"""

import pytest
import torch

from clpathtracer_tpu_torch.ops.packet import (MT_EXIT_OPS, WARP, mt_ops,
                                               mt_pairs, warp_ops)

torch.set_num_threads(2)

RECORDS = torch.tensor([[0.0, 0, 0, 1, 0, 0, 0, 1, 0, 0],
                        [10.0, 0, 0, 1, 0, 0, 0, 1, 0, 1]])
# lane counts passing det, u, v; (warp, record) groups tested and those
# whose deepest lane passes det, u, v
WANT = [66, 17, 1, 4, 4, 2, 1]


def _rays(uniform=False):
    """(ox, oy, oz, dx, dy, dz) [64] of the case; uniform: warp 0 all like
    lane 5 and warp 1 all leaving record 0 at u, so no warp diverges."""
    o = torch.tensor([0.2, 0.2, 1.0]).repeat(64, 1)
    d = torch.tensor([0.0, 0.0, -1.0]).repeat(64, 1)
    if uniform:
        o[32:, 0] = 2.0
    else:
        d[:32, 2] = 1.0
        d[5, 2] = -1.0
        o[32:48, 0] = 2.0
        o[48:, 1] = -1.0
    return (*o.T, *d.T)


def _tally(layout, rays, tested=None):
    """The 7-lane tally of the case with the lanes last ("K3", records
    [2, 1, 10]) or before the records ("K1", records [1, 2, 10])."""
    tally = torch.zeros(7, dtype=torch.int64)
    if layout == "K3":
        r, ray = RECORDS[:, None, :], [x[None, :] for x in rays]
        on = None if tested is None else tested[None, :]
        mt_pairs(r, *ray, tally, on)
    else:
        r, ray = RECORDS[None, :, :], [x[:, None] for x in rays]
        on = None if tested is None else tested[:, None]
        mt_pairs(r, *ray, tally, on, lane_dim=-2)
    return tally


@pytest.mark.parametrize("layout", ["K3", "K1"])
def test_warp_tally_known_exits(layout):
    tally = _tally(layout, _rays())
    assert tally.tolist() == WANT
    # lane average: 62 pairs leave at det, 49 at u, 16 at v, 1 runs through
    tests = 2 * 64
    assert mt_ops(tests, tally) == 62 * 15 + 49 * 27 + 16 * 45 + 53 == 3026
    # warps: no group leaves at det, two at u, one at v, one runs through
    assert warp_ops(tally) == WARP * (2 * 27 + 45 + 53) == 4864
    assert warp_ops(tally) > mt_ops(tests, tally)


@pytest.mark.parametrize("layout", ["K3", "K1"])
def test_warp_tally_skips_untested_lanes(layout):
    tested = torch.arange(64) >= 32      # warp 0 not tested (dead lanes)
    tally = _tally(layout, _rays(), tested)
    assert tally.tolist() == [64, 16, 0, 2, 2, 1, 0]
    assert warp_ops(tally) == WARP * (27 + 45)


def test_warp_ops_equal_lane_ops_without_divergence():
    tally = _tally("K3", _rays(uniform=True))
    # warp 0 runs record 0 through and leaves record 1 at u; warp 1 leaves
    # both at u: every lane of a warp leaves where its warp leaves
    assert tally.tolist() == [128, 32, 32, 4, 4, 1, 1]
    assert warp_ops(tally) == mt_ops(2 * 64, tally) == \
        32 * (MT_EXIT_OPS[3] + 3 * MT_EXIT_OPS[1])


def test_three_lane_tally_unchanged():
    tally = torch.zeros(3, dtype=torch.int64)
    r, ray = RECORDS[:, None, :], [x[None, :] for x in _rays()]
    ok, t = mt_pairs(r, *ray, tally)
    assert tally.tolist() == WANT[:3]
    assert ok.sum() == 1 and bool(ok[0, 5]) and float(t[0, 5]) == 1.0
