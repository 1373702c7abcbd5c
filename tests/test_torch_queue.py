"""Port parity, the queue engine K5 and the stream engine's f32 form K4:
the port's traverse_packet(engine="queue") (K5 in its plain torch version
on the CPU) against the JAX package's traverse_packet(engine="queue") (its
Pallas kernels in interpret mode: _kernel_queue_smem at CLPT_SMEM=1,
_kernel_queue at CLPT_SMEM=0) on the "frustum" and "active" fixtures of
tests/test_torch_packet.py; the plain K5 against the port's plain K3 on
the same inputs; and K4's f32 form (_kernel_stream, CLPT_SMEM=0), which
the port serves with K3.

Contract (tests/test_plist.py's): hit masks equal, t allclose (rtol 1e-5,
atol 1e-6), triangle ids equal on more than 95% of hits (exact-t ties),
and all five tile_stats lanes equal (lanes 0-3 for K4 against K3: the TPU
kernel writes 0 in lane 4, K3 its dense executions)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.scene.procedural import random_tri_soup
from clpathtracer_tpu_torch.ops import packet as tpk
from test_torch_packet import _active, _assert_hits, _scene_fixture

torch.set_num_threads(2)
TILE = 256
# case -> (fixture, traverse_packet keywords, CLPT_SMEM)
SO = dict(shared_origin=True, grid_dirs=True)
CASES = {
    "so_cull_smem": ("frustum", SO, "1"),
    "so_cull_vmem": ("frustum", SO, "0"),
    "mt_cull_smem": ("frustum", dict(), "1"),
    "mt_cull_vmem": ("frustum", dict(), "0"),
    "mt_active": ("active", dict(active=True), "1"),
    "all_dead": ("active", dict(active=False), "1"),
}


@pytest.fixture(scope="module")
def fixtures():
    return {
        "frustum": _scene_fixture(random_tri_soup(
            20_000, seed=11, extent=10.0, tri_size=0.05), 32,
            (0.0, 0.0, -25.0), 10, 512),
        "active": _scene_fixture(random_tri_soup(
            3000, seed=1, extent=2.0, tri_size=0.05), 32, (0.0, 0.0, -4.0),
            None, 16),
    }


def _mask(fx, kw):
    """The case's active mask as numpy (None: all lanes active)."""
    if "active" not in kw:
        return None
    return _active(fx) if kw["active"] else np.zeros(fx["size"] ** 2, bool)


def _jax(fx, kw, smem, monkeypatch, **extra):
    kw = dict(kw)
    mask = _mask(fx, kw)
    if mask is not None:
        kw["active"] = jnp.asarray(mask)
    monkeypatch.setenv("CLPT_SMEM", smem)
    rec = jpk.traverse_packet(fx["jt"], fx["jt"].quads, fx["orig"],
                              fx["dirs"], image_shape=(fx["size"],) * 2,
                              tile=TILE, **kw, **extra)
    return {k: np.asarray(v) for k, v in rec.items()}


def _port(fx, kw, **extra):
    kw = dict(kw)
    mask = _mask(fx, kw)
    if mask is not None:
        kw["active"] = torch.as_tensor(mask)
    return tpk.traverse_packet(fx["pt"], fx["o"], fx["d"],
                               image_shape=(fx["size"],) * 2, tile=TILE,
                               **kw, **extra)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k5_matches_jax_queue(fixtures, monkeypatch, case):
    fname, kw, smem = CASES[case]
    fx = fixtures[fname]
    ref = _jax(fx, kw, smem, monkeypatch, engine="queue")
    rec = _port(fx, kw, engine="queue")
    st = rec["tile_stats"].numpy()
    np.testing.assert_array_equal(st, ref["tile_stats"].astype(np.int32))
    if case == "all_dead":
        assert not rec["hit"].any() and not ref["hit"].any()
        assert (st[:, 0] == 0).all()
        return
    _assert_hits(rec, ref)
    assert st[:, 1].sum() > 0 and (st[:, 4] == 0).all()
    if fname == "active":
        assert not rec["hit"].numpy()[~_active(fx)].any()


@pytest.mark.parametrize("case", ["so_cull_smem", "mt_cull_smem",
                                  "mt_active"])
def test_plain_k5_matches_plain_k3(fixtures, case):
    """The queue computes the stream engine's function: the same hits and
    t on the same inputs (K3 with the AABB cull, no strips or frustum)."""
    fname, kw, _ = CASES[case]
    fx = fixtures[fname]
    q = _port(fx, kw, engine="queue")
    s = _port(fx, kw, strips=False, frustum=False)
    assert q["hit"].any()
    assert torch.equal(q["hit"], s["hit"]) and torch.equal(q["t"], s["t"])
    h = s["hit"]
    assert (q["tri"][h] == s["tri"][h]).float().mean() > 0.95
    # the same node pops and active lanes; K5 skips at the drain what K3
    # culls at the cursor, so only the sum of lanes 1 and 3 may differ
    np.testing.assert_array_equal(q["tile_stats"][:, 2],
                                  s["tile_stats"][:, 2])


def test_k4_f32_is_served_by_k3(fixtures, monkeypatch):
    """JAX's stream engine on its VMEM tables (_kernel_stream, K4, in its
    f32 form) against the port's plain K3 in the same form (SO rows, the
    AABB cull, no strips or frustum): the same hits and tile_stats lanes
    0-3 (the TPU kernel writes 0 in lane 4)."""
    fx = fixtures["frustum"]
    ref = _jax(fx, SO, "0", monkeypatch, engine="stream")
    rec = _port(fx, SO, strips=False, frustum=False)
    _assert_hits(rec, ref)
    st = rec["tile_stats"].numpy()
    np.testing.assert_array_equal(st[:, :4],
                                  ref["tile_stats"][:, :4].astype(np.int32))
    assert (ref["tile_stats"][:, 4] == 0).all() and st[:, 3].sum() > 0


@pytest.mark.parametrize("bad", ["dtype", "tile", "precision"])
def test_packet_queue_rejects_bad_arguments(fixtures, bad):
    fx = fixtures["frustum"]
    if bad == "precision":
        with pytest.raises(ValueError, match="precision"):
            tpk.traverse_packet(fx["pt"], fx["o"], fx["d"], tile=TILE,
                                engine="queue", precision="fp8")
        return
    args, kw, _ = tpk.stream_kernel_args(fx["pt"], fx["o"], fx["d"],
                                         tile=TILE)
    args = list(args)
    if bad == "dtype":
        args[2] = args[2].double()
    else:
        kw["tile"] = 768
    with pytest.raises(ValueError, match="packet_queue"):
        tpk.packet_queue(*args, **kw)
