"""Port parity, kernel K1 and traverse_plist: the plain torch version of
the super-list kernel and the port's traverse_plist against the JAX
package's traverse_plist (its Pallas kernel in interpret mode on the CPU)
at 64x64 rays (8 gates) on a ~16k-triangle terrain, win_rows 16, with the
JAX package's shared-origin and resolve tables carried across.

The parity rule is tests/test_plist.py's: hit masks equal, t allclose on
common hits, triangle ids equal on more than 95% of hits (exact-t ties
are a documented freedom)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.scene.procedural import terrain_mesh
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops.packet import BIG, _blockify, so_combine
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64


@pytest.fixture(scope="module")
def ref():
    """One JAX traverse_plist run (one interpret-mode compile) and the
    same state carried into the port."""
    scene = terrain_mesh(16_000, seed=0, extent=10.0).bake_shading()
    tv = np.asarray(scene.tri_corners())
    jw = jpl.attach_resolve(
        jpl.attach_so(jpl.build_morton_windows(tv, win_rows=16)),
        scene.shade_rows)
    cam = JCamera.create(position=[0.0, 14.0, 0.0], forward=[0.0, -1.0, 0.01])
    orig, dirs = generate_rays(cam_matrix(cam, H), W, H)
    rec = jpl.traverse_plist(jw, orig, dirs, (H, W), supers=True)
    return dict(
        tv=tv, jw=jw,
        rec={k: np.asarray(v) for k, v in rec.items()},
        tw=interop.windows_from_numpy(jw.tris128, jw.win_bnd, jw.so_base,
                                      jw.resolve_rows, jw.slot_of_tri, 16,
                                      device=CPU),
        orig=torch.as_tensor(np.array(orig)),
        dirs=torch.as_tensor(np.array(dirs)))


def _assert_parity(rec, ref):
    h_p, h_r = rec["hit"].numpy(), ref["hit"]
    np.testing.assert_array_equal(h_p, h_r)
    both = h_p & h_r
    assert both.mean() > 0.9
    np.testing.assert_allclose(rec["t"].numpy()[both], ref["t"][both],
                               rtol=1e-5, atol=1e-6)
    tri_eq = (rec["tri"].numpy()[both] == ref["tri"][both]).mean()
    assert tri_eq > 0.95, tri_eq


def _assert_stats_equal(stats, ref_stats):
    # per gate (0, windows, 512, supers, windows). The port stops a gate
    # with the t_upper refreshed after the current super, the TPU kernel
    # (which prefetches the next super) with the one before it; the
    # difference can only add supers on the JAX side, and this fixture
    # shows none.
    np.testing.assert_array_equal(stats.numpy(), ref_stats.astype(np.int32))


def test_plist_super_reference_vs_jax(ref):
    """K1's plain version on the JAX package's own prepass lists and SO
    rows: winners resolve to the JAX hits, stats equal per gate."""
    jw, tw = ref["jw"], ref["tw"]
    dir_b = _blockify(ref["dirs"], H, W, tpl.GH, tpl.GW)
    o = ref["orig"][0]
    jkey, jsid, jbits = jpl.gate_lists_super(
        jw.win_bnd, jnp.asarray(dir_b.numpy()), jnp.asarray(o.numpy()), 16)
    n_gates = dir_b.shape[0] // tpl.GATE
    n_supers = tw.num_windows // tpl.SUPER

    def flat(x, dtype):  # [G, C, 8, 128] chunk packing -> [G, Ls]
        x = np.asarray(x).transpose(0, 1, 3, 2).reshape(n_gates, -1)
        return torch.as_tensor(x[:, :n_supers].astype(dtype))
    key, sid, bits = (flat(jkey, np.float32), flat(jsid, np.int32),
                      flat(jbits, np.int32))
    rows = so_combine(tw.so_base, o)
    t0 = torch.full((n_gates * tpl.GATE,), BIG)
    best_t, best_slot, stats = tpl.plist_super_reference(
        key, sid, bits, rows, dir_b.T.contiguous(), t0, win_rows=16)
    assert best_slot.dtype == torch.int32 and stats.shape == (n_gates, 5)
    assert ((best_slot >= 0) == (best_t < BIG)).all()
    _assert_stats_equal(stats, ref["rec"]["tile_stats"])
    slots = tpl._unblockify(best_slot, H, W, tpl.GH, tpl.GW)
    rec = tpl._resolve_winners(tw, slots, ref["orig"], ref["dirs"], stats)
    _assert_parity(rec, ref["rec"])
    # the wrapper takes the plain version for CPU tensors
    again = tpl.plist_super(key, sid, bits, rows, dir_b.T.contiguous(), t0,
                            win_rows=16)
    for a, b in zip(again, (best_t, best_slot, stats)):
        assert torch.equal(a, b)


def test_traverse_plist_vs_jax(ref):
    rec = tpl.traverse_plist(ref["tw"], ref["orig"], ref["dirs"], (H, W))
    _assert_parity(rec, ref["rec"])
    _assert_stats_equal(rec["tile_stats"], ref["rec"]["tile_stats"])
    for k in ("snormal", "salbedo", "semission"):
        np.testing.assert_allclose(rec[k].numpy(), ref["rec"][k], rtol=1e-5,
                                   atol=1e-6)


def _bruteforce(tv, orig, dirs, chunk=4096):
    """Nearest front-face Moller-Trumbore hit over every triangle."""
    v0 = torch.as_tensor(tv[:, 0])[None]
    e1 = torch.as_tensor(tv[:, 1] - tv[:, 0])[None]
    e2 = torch.as_tensor(tv[:, 2] - tv[:, 0])[None]
    best = torch.full((orig.shape[0],), float("inf"))
    for c in range(0, tv.shape[0], chunk):
        ok, t, _, _ = _mt_pre(v0[:, c:c + chunk], e1[:, c:c + chunk],
                              e2[:, c:c + chunk], orig[:, None],
                              dirs[:, None])
        best = torch.minimum(best, torch.where(ok, t, float("inf"))
                             .amin(dim=1))
    return torch.isfinite(best), best


def test_traverse_plist_vs_bruteforce(ref):
    """The port's own windows and SO tables against a brute-force MT over
    all triangles, with the SO edge-flip budget of
    tests/test_plist.py::test_plist_so_affine_parity."""
    tw = tpl.attach_so(tpl.build_morton_windows(ref["tv"], 16, device=CPU))
    tw = tw.replace(resolve_rows=ref["tw"].resolve_rows)
    rec = tpl.traverse_plist(tw, ref["orig"], ref["dirs"], (H, W))
    hit, t = _bruteforce(ref["tv"], ref["orig"], ref["dirs"])
    assert (rec["hit"] != hit).float().mean() < 2e-3
    both = (rec["hit"] & hit).numpy()
    np.testing.assert_allclose(rec["t"].numpy()[both], t.numpy()[both],
                               rtol=1e-4, atol=1e-5)


def test_sky_camera_runs_zero_supers(ref):
    cam = tcam.Camera.create([0.0, 14.0, 0.0], [0.0, 1.0, 0.01], device=CPU)
    orig, dirs = tcam.generate_rays(tcam.cam_matrix(cam, H), W, H)
    rec = tpl.traverse_plist(ref["tw"], orig, dirs, (H, W))
    assert not rec["hit"].any()
    assert (rec["tile_stats"][:, [1, 3, 4]] == 0).all()
    assert (rec["t"] == np.float32(BIG)).all()


def test_plist_super_tie_rule_lowest_slot():
    """Exact-t ties go to the lowest slot: the same triangle at slots 7
    and 3 of one window (pad records elsewhere) -> slot 3 wins."""
    rows16 = np.zeros((tpl.SUPER * 8, 16), np.float32)    # win_rows 1
    rows16[:, 10] = -1.0
    tri = np.array([[-1.0, -1.0, 2.0], [0.0, 1.0, 2.0], [1.0, -1.0, 2.0]],
                   np.float32)
    rec = np.zeros(16, np.float32)
    rec[0:3], rec[3:6], rec[6:9] = tri[0], tri[1] - tri[0], tri[2] - tri[0]
    rec[9] = 0.0
    rows16[[3, 7]] = rec
    so = tpl.so_affine_tables(torch.as_tensor(rows16))
    rows = so_combine(so, torch.zeros(3))
    n = tpl.GATE
    dirs = torch.zeros((3, n))
    dirs[2] = 1.0
    key = torch.zeros((1, 1))
    sid = torch.zeros((1, 1), dtype=torch.int32)
    bits = torch.ones((1, 1), dtype=torch.int32)
    best_t, best_slot, stats = tpl.plist_super(
        key, sid, bits, rows, dirs, torch.full((n,), BIG), win_rows=1)
    assert (best_slot == 3).all()
    assert torch.allclose(best_t, torch.full((n,), 2.0))
    assert stats[0].tolist() == [0, 1, tpl.GATE, 1, 1]


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "win_rows"])
def test_plist_super_rejects_bad_args(bad):
    g, ls, wr = 2, 1, 1
    args = dict(key=torch.zeros((g, ls)),
                sid=torch.zeros((g, ls), dtype=torch.int32),
                bits=torch.zeros((g, ls), dtype=torch.int32),
                rows=torch.zeros((tpl.SUPER * 8 * wr, 16)),
                dir_t=torch.zeros((3, g * tpl.GATE)),
                t0=torch.zeros((g * tpl.GATE,)))
    kw = dict(win_rows=wr)
    if bad == "dtype":
        args["sid"] = args["sid"].float()
    elif bad == "shape":
        args["rows"] = torch.zeros((100, 16))
    elif bad == "contig":
        args["dir_t"] = torch.zeros((g * tpl.GATE, 3)).T
    else:
        kw["win_rows"] = 0
    with pytest.raises(ValueError):
        tpl.plist_super(*args.values(), **kw)
