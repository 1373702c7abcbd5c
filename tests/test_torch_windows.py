"""Port parity, window build and prepass: the torch host build, the
shared-origin tables and the per-gate super lists against
clpathtracer_tpu.ops.plist on the same ~8k-triangle terrain and rays, on
the CPU. The prepass here is plain XLA in the JAX package (no Pallas)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.scene.procedural import terrain_mesh
from clpathtracer_tpu_torch.ops import packet as tpk
from clpathtracer_tpu_torch.ops import plist as tpl

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    scene = terrain_mesh(8000, seed=0, extent=10.0).bake_shading()
    tv = np.asarray(scene.tri_corners())
    cam = JCamera.create(position=[0.0, 14.0, 0.0], forward=[0.0, -1.0, 0.01])
    orig, dirs = generate_rays(cam_matrix(cam, 64), 64, 64)
    dir_b = np.array(jpk._blockify(dirs, 64, 64, jpl.GH, jpl.GW))
    jw = jpl.build_morton_windows(tv, win_rows=16)
    tw = tpl.build_morton_windows(tv, 16, device=CPU)
    return dict(scene=scene, tv=tv, o=np.array(orig[0]), dir_b=dir_b, jw=jw,
                tw=tw)


def test_median_order_equal(setup):
    np.testing.assert_array_equal(tpl.median_order(setup["tv"], 128),
                                  jpl.median_order(setup["tv"], 128))


def test_build_morton_windows_equal(setup):
    jw, tw = setup["jw"], setup["tw"]
    tris = np.asarray(jw.tris128).reshape(-1, 16)
    np.testing.assert_array_equal(tw.tris.numpy(), tris)
    np.testing.assert_array_equal(tw.tri_id.numpy(), tris[:, 9])
    np.testing.assert_array_equal(tw.win_bnd.numpy(),
                                  np.asarray(jw.win_bnd)[:, :6])
    np.testing.assert_array_equal(tw.slot_of_tri.numpy(),
                                  np.asarray(jw.slot_of_tri))
    assert tw.num_windows == jw.num_windows
    assert tw.num_windows % tpl.SUPER == 0


def test_resolve_rows_equal(setup):
    jw, tw, scene = setup["jw"], setup["tw"], setup["scene"]
    jr = np.asarray(jpl.build_resolve_rows(jw.tris128, scene.shade_rows))
    tr = tpl.build_resolve_rows(tw.tris, tw.tri_id,
                                torch.as_tensor(np.array(scene.shade_rows)))
    np.testing.assert_array_equal(
        tr.numpy(), jr.reshape(-1, 32)[:tw.tris.shape[0]])


def test_so_affine_tables_close(setup):
    # the cross products may round in another order than XLA's
    jt = np.asarray(jpk.so_affine_tables(setup["jw"].quads)).reshape(4, -1, 16)
    tt = tpk.so_affine_tables(setup["tw"].tris).numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    pads = setup["tw"].tri_id.numpy() < 0
    assert pads.any() and not tt[:, pads].any()


def test_win_keys_match(setup):
    d = setup["dir_b"].reshape(-1, jpl.GATE, 3)
    jk = np.asarray(jpl._win_keys(setup["jw"].win_bnd, jnp.asarray(d),
                                  setup["o"], jpl.GH, jpl.GW))
    tk = tpl._win_keys(setup["tw"].win_bnd, torch.as_tensor(d),
                       torch.as_tensor(setup["o"]), tpl.GH, tpl.GW).numpy()
    flips = np.isfinite(jk) != np.isfinite(tk)
    print(f"window-borderline flips: {flips.sum()} of {jk.size}")
    assert flips.mean() <= 1e-3
    both = np.isfinite(jk) & np.isfinite(tk)
    assert both.any()
    np.testing.assert_array_equal(tk[both], jk[both])


def test_gate_lists_super_match(setup):
    jkey, jsid, jbits = jpl.gate_lists_super(
        setup["jw"].win_bnd, jnp.asarray(setup["dir_b"]), setup["o"], 16)
    tkey, tsid, tbits = tpl.gate_lists_super(
        setup["tw"].win_bnd, torch.as_tensor(setup["dir_b"]),
        torch.as_tensor(setup["o"]))
    n_gates, n_supers = tkey.shape
    assert n_supers == setup["tw"].num_windows // tpl.SUPER
    assert tsid.dtype == torch.int32 and tbits.dtype == torch.int32

    def flat(x):  # [G, C, 8, 128] chunk packing -> [G, Ls]
        x = np.asarray(x)
        return x.transpose(0, 1, 3, 2).reshape(n_gates, -1)[:, :n_supers]
    jkey, jsid, jbits = flat(jkey), flat(jsid), flat(jbits)
    np.testing.assert_array_equal(tkey.numpy(), jkey)
    for g in range(n_gates):
        tset = sorted(zip(tsid[g].tolist(), tbits[g].tolist()))
        jset = sorted(zip(jsid[g].astype(int).tolist(),
                          jbits[g].astype(int).tolist()))
        assert tset == jset, g
    assert np.isfinite(jkey).any() and np.isinf(jkey).any()
