"""Port parity, the kd-tree stream route and kernel K3: the port's
traverse_packet (K3 in its plain torch version on the CPU) against the
JAX package's traverse_packet(engine="stream") (its Pallas kernel
_kernel_stream_smem in interpret mode) on the fixtures of
tests/test_packet.py: TestStripGating (strips, 128-lane strips and
512-lane gates), TestFrustumCull (cull + frustum, cull only) and
TestStreamEngine.test_active_mask (general Moller-Trumbore with an active
mask); then render_image on the kd route against the JAX package's
render_image(intersector="packet", tree=...) in normal and mirror mode,
and against the port's own windows route in path mode. The queue engine K5
and the bf16 preview K4 have their own files (test_torch_queue.py,
test_torch_bf16.py); the engines still to port raise, naming their kernels.

Contract (tests/test_plist.py's): hit masks equal, t allclose (rtol 1e-5,
atol 1e-6), triangle ids equal on more than 95% of hits (exact-t ties),
and tile_stats lanes 0-4 equal. One exception, stated where it applies:
with the corner-frustum cull, the JAX package's frustum planes come from
XLA, which contracts the cross products into FMAs on the CPU, so they can
differ from the port's torch planes in the last bit; a window on the edge
of a plane is then culled by one and streamed by the other, which moves
windows between lanes 1 (streamed) and 3 (culled) and lane 4 with lane 1,
but not their sum, the node pops or any hit. Given the JAX planes, the
plain K3 reproduces every lane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import attach_so_tables as j_attach_so
from clpathtracer_tpu.accel.sah import build_kd_tree as j_build
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix as j_cam_matrix
from clpathtracer_tpu.core.camera import generate_rays as j_generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene.procedural import random_tri_soup
from clpathtracer_tpu.scene.procedural import terrain_mesh as j_terrain
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import packet as tpk
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from clpathtracer_tpu_torch.scene.procedural import terrain_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]
# case -> (fixture, tile, traverse_packet keywords, JAX environment)
CASES = {
    "strips_128lane": ("strips", 256, dict(shared_origin=True,
                                           grid_dirs=True), {}),
    "strips_gates": ("strips", 1024, dict(shared_origin=True,
                                          grid_dirs=True), {}),
    "cull_frustum": ("frustum", 256, dict(shared_origin=True,
                                          grid_dirs=True),
                     {"CLPT_STRIPS": "0"}),
    "cull": ("frustum", 256, dict(shared_origin=True, grid_dirs=True,
                                  frustum=False),
             {"CLPT_STRIPS": "0", "CLPT_FRUSTUM": "0"}),
    "mt_active": ("active", 256, dict(), {}),
}


def _scene_fixture(scene, size, pos, depth, leaf):
    v0, v1, v2 = scene.tri_verts()
    tv = np.stack([np.asarray(v0), np.asarray(v1), np.asarray(v2)], 1)
    kw = dict(leaf_size=leaf, tri_block=4)
    if depth is not None:
        kw["max_depth"] = depth
    jt = j_attach_so(j_build(tv, **kw))
    cam = JCamera.create(position=list(pos), forward=[0.0, 0.0, 1.0])
    orig, dirs = j_generate_rays(j_cam_matrix(cam, size), size, size)
    pt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, jt.so_base,
                                 jt.max_leaf_tris, device=CPU)
    return dict(jt=jt, pt=pt, orig=orig, dirs=dirs, size=size,
                o=torch.as_tensor(np.array(orig)),
                d=torch.as_tensor(np.array(dirs)))


@pytest.fixture(scope="module")
def fixtures():
    return {
        # TestStripGating
        "strips": _scene_fixture(random_tri_soup(
            20_000, seed=13, extent=10.0, tri_size=0.05), 64,
            (0.0, 0.0, -25.0), 10, 512),
        # TestFrustumCull
        "frustum": _scene_fixture(random_tri_soup(
            20_000, seed=11, extent=10.0, tri_size=0.05), 32,
            (0.0, 0.0, -25.0), 10, 512),
        # TestStreamEngine.test_active_mask
        "active": _scene_fixture(random_tri_soup(
            3000, seed=1, extent=2.0, tri_size=0.05), 32, (0.0, 0.0, -4.0),
            None, 16),
    }


def _active(fx):
    return np.random.default_rng(0).random(fx["size"] ** 2) < 0.5


@pytest.fixture(scope="module")
def jax_records(fixtures):
    """One JAX traverse_packet per case (interpret mode)."""
    out = {}
    for case, (fname, tile, kw, env) in CASES.items():
        fx = fixtures[fname]
        jkw = dict(kw)
        jkw.pop("frustum", None)
        if fname == "active":
            jkw["active"] = jnp.asarray(_active(fx))
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            rec = jpk.traverse_packet(
                fx["jt"], fx["jt"].quads, fx["orig"], fx["dirs"],
                image_shape=(fx["size"],) * 2, tile=tile, engine="stream",
                **jkw)
        out[case] = {k: np.asarray(v) for k, v in rec.items()}
    return out


def _port_record(fx, fname, tile, kw):
    kw = dict(kw)
    if fname == "active":
        kw["active"] = torch.as_tensor(_active(fx))
    return tpk.traverse_packet(fx["pt"], fx["o"], fx["d"],
                               image_shape=(fx["size"],) * 2, tile=tile,
                               **kw)


def _assert_hits(rec, ref):
    h = ref["hit"]
    np.testing.assert_array_equal(rec["hit"].numpy(), h)
    assert h.any()
    np.testing.assert_allclose(rec["t"].numpy()[h], ref["t"][h], rtol=1e-5,
                               atol=1e-6)
    assert (rec["tri"].numpy()[h] == ref["tri"][h]).mean() > 0.95


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k3_matches_jax(fixtures, jax_records, case):
    fname, tile, kw, _ = CASES[case]
    fx = fixtures[fname]
    ref = jax_records[case]
    rec = _port_record(fx, fname, tile, kw)
    _assert_hits(rec, ref)
    if fname == "active":
        assert not rec["hit"].numpy()[~_active(fx)].any()
    st = rec["tile_stats"].numpy().astype(np.int64)
    jst = ref["tile_stats"].astype(np.int64)
    assert st.shape == jst.shape and st[:, 1].sum() > 0
    if case != "cull_frustum":
        np.testing.assert_array_equal(st, jst)
    else:   # the frustum planes' last bit: see the module docstring
        np.testing.assert_array_equal(st[:, [0, 2]], jst[:, [0, 2]])
        np.testing.assert_array_equal(st[:, 1] + st[:, 3],
                                      jst[:, 1] + jst[:, 3])
        np.testing.assert_array_equal(st[:, 4], st[:, 1])
    if case == "strips_128lane":
        assert st[:, 3].sum() > 0                  # the masks culled
    if case == "strips_gates":                     # dense runs per gate
        assert (st[:, 4] <= 2 * st[:, 1]).all() and st[:, 4].sum() < \
            2 * st[:, 1].sum()


def test_plain_k3_with_jax_frustum_rows(fixtures, jax_records):
    """The frustum form given the JAX package's own planes: every lane of
    tile_stats equal, and the winners."""
    fname, tile, kw, _ = CASES["cull_frustum"]
    fx = fixtures[fname]
    args, kern_kw, layout = tpk.stream_kernel_args(
        fx["pt"], fx["o"], fx["d"], (fx["size"],) * 2, tile, **kw)
    th, tw = tpk.tile_shape(tile)
    jfr = jpk._frustum_rows(jpk._blockify(fx["dirs"], fx["size"], fx["size"],
                                          th, tw), fx["orig"][0], tile, th,
                            tw)
    kern_kw["frustum"] = torch.as_tensor(np.array(jfr))
    _, slot, stats = tpk.packet_stream_reference(*args, **kern_kw)
    ref = jax_records["cull_frustum"]
    np.testing.assert_array_equal(stats.numpy(),
                                  ref["tile_stats"].astype(np.int32))
    slot = tpk._to_wave_order(slot, layout)
    np.testing.assert_array_equal(slot.numpy() >= 0, ref["hit"])


def test_culls_keep_the_unculled_hits(fixtures):
    """Every window cull is conservative: strips, cull + frustum, cull
    only and no cull give the same winners; each cull streams fewer
    windows than none."""
    fx = fixtures["strips"]
    forms = {"strips": {}, "frustum": dict(strips=False),
             "cull": dict(strips=False, frustum=False),
             "none": dict(chunk_cull=False)}
    recs = {k: tpk.traverse_packet(fx["pt"], fx["o"], fx["d"],
                                   image_shape=(64, 64), tile=512,
                                   shared_origin=True, grid_dirs=True, **kw)
            for k, kw in forms.items()}
    for k in ("strips", "frustum", "cull"):
        for f in ("hit", "tri", "t"):
            assert torch.equal(recs[k][f], recs["none"][f]), (k, f)
        assert recs[k]["tile_stats"][:, 1].sum() < \
            recs["none"]["tile_stats"][:, 1].sum()
    assert int(recs["none"]["tile_stats"][:, 3].sum()) == 0


@pytest.fixture(scope="module")
def terrain():
    """The 16k terrain of tests/test_torch_render.py for both packages,
    with its tree (depth 10, leaf 512) and, for the port, its windows."""
    js = j_terrain(16_000, seed=0, extent=10.0).bake_shading()
    jt = j_attach_so(j_build(np.asarray(js.tri_corners()), max_depth=10,
                             leaf_size=512, tri_block=4))
    scene = terrain_mesh(16_000, seed=0, extent=10.0,
                         device=CPU).bake_shading()
    tree = sah.attach_so_tables(sah.build_kd_tree(
        scene.tri_corners(), max_depth=10, leaf_size=512, device=CPU))
    mwin = tpl.build_morton_windows(scene.tri_corners(), 16, device=CPU)
    mwin = tpl.attach_resolve(tpl.attach_so(mwin), scene.shade_rows)
    return dict(js=js, jt=jt, scene=scene, tree=tree, mwin=mwin)


@pytest.mark.parametrize("mode", ["normal", "mirror"])
def test_render_image_kd_route_matches_jax(terrain, mode):
    jopts = jint.RenderOptions(width=64, height=64, mode=mode,
                               intersector="packet", packet_tile=1024)
    ref = np.asarray(jint.render_image(
        terrain["js"], JCamera.create(position=POS, forward=FWD), jopts,
        tree=terrain["jt"]))
    cam = Camera.create(POS, FWD, device=CPU)
    img = render_image(terrain["scene"], cam,
                       RenderOptions(width=64, height=64, mode=mode,
                                     intersector="packet", packet_tile=1024),
                       tree=terrain["tree"]).numpy()
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    # the same hits give the same image up to exact-t tie winners at
    # shared mesh edges (the budget of tests/test_torch_render.py)
    differ = (np.abs(img - ref).max(axis=-1) > 1e-5).mean()
    assert differ < 1.5e-2, differ


@pytest.mark.parametrize("spp", [1, 2])
def test_path_kd_route_matches_windows_route(terrain, spp):
    """Path mode (no NEE) with the same explicit draws on both routes:
    the kd route's SO pixel tiles (strips at spp 1, the AABB cull on
    jittered samples) and sorted MT packet tiles against the windows
    route's gates and bundles."""
    opts = RenderOptions(width=64, height=64, mode="path", spp=spp,
                         bounces=2, intersector="packet", packet_tile=512)
    rng = np.random.default_rng(5)
    jitter = (torch.as_tensor(rng.random((spp, 4096, 2), np.float32))
              if spp > 1 else None)
    bounce = torch.as_tensor(rng.random((spp, 2, 4096, 2), np.float32))
    cam = Camera.create(POS, FWD, device=CPU)
    kw = dict(jitter=jitter, bounce=bounce)
    kd = render_image(terrain["scene"], cam, opts, tree=terrain["tree"],
                      **kw).numpy()
    win = render_image(terrain["scene"], cam, opts, terrain["mwin"],
                       **kw).numpy()
    assert np.isfinite(kd).all() and 0.0 < kd.mean() <= 1.0
    differ = (np.abs(kd - win).max(axis=-1) > 1e-4).mean()
    assert differ < 2e-2, differ


@pytest.mark.parametrize("baked", [True, False])
def test_resolve_tri_hits_matches_jax(baked):
    """Both branches of resolve_tri_hits (baked shade rows; faces with
    smooth vertex normals on some faces and geometric normals on the
    others) against the JAX package's on the same arrays."""
    from clpathtracer_tpu.render.shading import resolve_tri_hits as j_res
    from clpathtracer_tpu.scene.scene import Scene as JScene
    from clpathtracer_tpu_torch.render.shading import resolve_tri_hits
    rng = np.random.default_rng(7)
    verts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    normals = rng.normal(size=(12, 3)).astype(np.float32)
    faces = np.full((10, 3, 3), -1, np.int32)
    faces[:, :, 0] = rng.integers(0, 30, (10, 3))
    faces[:5, :, 1] = rng.integers(0, 12, (5, 3))     # smooth normals
    albedo = rng.uniform(0, 1, (10, 3)).astype(np.float32)
    emission = rng.uniform(0, 2, (10, 3)).astype(np.float32)
    js = JScene.create(verts, faces, normals, albedo, emission)
    ts = interop.scene_from_numpy(verts, faces, normals, albedo, emission,
                                  device=CPU)
    if baked:
        js, ts = js.bake_shading(), ts.bake_shading()
    tri = np.array([0, 3, 5, 9, -1, 7, 2], np.int32)
    u = rng.uniform(0, 0.5, 7).astype(np.float32)
    v = rng.uniform(0, 0.5, 7).astype(np.float32)
    ref = j_res(js, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    got = resolve_tri_hits(ts, torch.as_tensor(tri), torch.as_tensor(u),
                           torch.as_tensor(v))
    for k in ("normal", "albedo", "emission"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["queue", "legacy", "stream2", "mxu",
                                  "wide", "bf16", "frame", "no_tree"])
def test_outside_the_route_raises(terrain, case):
    """What the route does not carry raises; the queue engine, the bf16
    preview, the legacy and wide engines and the stream2 and mxu engines,
    once outside it, now run (their parity is in test_torch_queue.py,
    test_torch_bf16.py, test_torch_legacy.py, test_torch_stream2.py and
    test_torch_mxu.py)."""
    tree = terrain["tree"]
    o = torch.zeros((4096, 3))
    d = torch.ones((4096, 3))
    if case in ("queue", "bf16", "legacy", "wide", "stream2", "mxu"):
        kw = ({"precision": "bf16"} if case == "bf16"  # ported: the run
              else {"engine": case})                  # agrees with K3's
        rec = tpk.traverse_packet(tree, o, d, **kw)
        ref = tpk.traverse_packet(tree, o, d)
        assert rec["tile_stats"].shape == ref["tile_stats"].shape == (4, 5)
        if case in ("queue", "bf16", "stream2", "mxu"):
            assert torch.equal(rec["tile_stats"][:, 2],
                               ref["tile_stats"][:, 2])
        else:       # the v1 kernels write 0 where K3 counts active lanes
            assert (rec["tile_stats"][:, 2:] == 0).all()
            assert (rec["tile_stats"][:, :2] > 0).all()
        if case == "mxu":   # another summation order: the JAX budget
            assert (rec["hit"] == ref["hit"]).float().mean() >= 0.995
        elif case != "bf16":
            assert torch.equal(rec["hit"], ref["hit"])
    elif case == "frame":      # not whole packet tiles: the rope walk
        cam = Camera.create(POS, FWD, device=CPU)
        walk = render_image(terrain["scene"], cam,
                            RenderOptions(width=48, height=48,
                                          intersector="packet"), tree=tree)
        packed = render_image(terrain["scene"], cam,
                              RenderOptions(width=48, height=48,
                                            intersector="packet",
                                            packet_tile=256), tree=tree)
        assert bool(torch.isfinite(walk).all())
        differ = ((walk - packed).abs().amax(dim=-1) > 1e-5).float().mean()
        assert float(differ) < 1.5e-2
    else:
        with pytest.raises(ValueError):
            tpk.traverse_packet(None, o, d)


@pytest.mark.parametrize("bad", ["dtype", "contig", "tile", "rows",
                                 "frustum"])
def test_packet_stream_rejects_bad_arguments(fixtures, bad):
    fx = fixtures["active"]
    args, kw, _ = tpk.stream_kernel_args(fx["pt"], fx["o"], fx["d"],
                                         tile=256)
    args = list(args)
    if bad == "dtype":
        args[0] = args[0].float()
    elif bad == "contig":
        args[3] = args[3].T.contiguous().T
    elif bad == "tile":
        kw["tile"] = 768
    elif bad == "rows":
        args[2] = args[2][:64]
    else:
        kw["frustum"] = torch.zeros((3, 16))
    with pytest.raises(ValueError):
        tpk.packet_stream(*args, **kw)
