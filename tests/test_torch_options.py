"""Port parity, the renderer's last options: winner resolution without
fused resolve rows on every windows entry point, the per-frame shared-origin rows of a tree without SO tables (so_rows), and
unsorted bounce waves (RenderOptions.sort_bounces=False) on the plain
frame and the differentiable route. The JAX parts are XLA only (the
resolve body, so_rows), each called once in a module fixture; no Pallas
call."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel.grid import build_grid
from clpathtracer_tpu_torch.accel.sah import attach_so_tables, build_kd_tree
from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                generate_rays)
from clpathtracer_tpu_torch.diff.grad import intersect_diff
from clpathtracer_tpu_torch.ops import packet
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.render import integrator
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      intersect_scene,
                                                      render_image)
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 32
N = H * W
TILE = 64
POS, FWD = [0.013, 6.0, -3.0], [0.0, -1.0, 0.5]


def _nearest(scene, orig, dir):
    """The brute-force nearest front-face hit: (tri [N] i64, -1 on a
    miss; t [N], inf on a miss)."""
    v0, v1, v2 = scene.tri_verts()
    ok, t, _, _ = _mt_pre(v0[None], (v1 - v0)[None], (v2 - v0)[None],
                          orig[:, None], dir[:, None])
    t = torch.where(ok, t, float("inf"))
    best, tri = t.min(dim=1)
    return torch.where(torch.isfinite(best), tri, -1), best


@pytest.fixture(scope="module")
def res():
    """A 3000-triangle terrain in both packages; the JAX package's windows
    (win_rows 2, no resolve rows) carried to the port, and the port's
    fused copy; the 32x32 primaries and their brute-force winner slots;
    the JAX package's _resolve_winners_body on those slots."""
    jscene = jproc.terrain_mesh(3000, seed=0, extent=3.0)
    scene = tproc.terrain_mesh(3000, seed=0, extent=3.0,
                               device=CPU).bake_shading()
    jw = jpl.build_morton_windows(np.asarray(jscene.tri_corners()),
                                  win_rows=2, order="median")
    mwin = interop.windows_from_numpy(
        np.asarray(jw.tris128), np.asarray(jw.win_bnd), None, None,
        np.asarray(jw.slot_of_tri), jw.win_rows, device=CPU)
    cam = Camera.create(POS, FWD, device=CPU)
    orig, dirs = generate_rays(cam_matrix(cam, H), W, H)
    tri, _ = _nearest(scene, orig, dirs)
    slot = torch.where(tri >= 0, mwin.slot_of_tri[tri.clamp(min=0)], -1)
    j = jpl._resolve_winners_body(jw, jnp.asarray(slot.numpy()),
                                  jnp.asarray(orig.numpy()),
                                  jnp.asarray(dirs.numpy()))
    return dict(scene=scene, mwin=mwin,
                fused=tpl.attach_resolve(mwin, scene.shade_rows), cam=cam,
                orig=orig, dirs=dirs, slot=slot,
                jax={k: np.asarray(v) for k, v in j.items()})


def test_unfused_resolve_matches_jax(res):
    """Without resolve rows the winner's record comes from the windows'
    records: hit and tri equal to the JAX package's _resolve_winners_body
    on the same slots, t (rtol 1e-6) and u, v (atol 1e-5) close: XLA may
    contract _mt_pre's products into FMAs, and u, v divide by a small
    determinant on small triangles (tests/test_torch_grid.py holds them
    to 5e-4). No shade attributes."""
    out = tpl._resolve_winners_body(res["mwin"], res["slot"], res["orig"],
                                    res["dirs"])
    j = res["jax"]
    assert set(out) == set(j) == {"hit", "t", "tri", "u", "v"}
    np.testing.assert_array_equal(out["hit"].numpy(), j["hit"])
    np.testing.assert_array_equal(out["tri"].numpy(), j["tri"])
    hit = j["hit"]
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_allclose(out["t"].numpy()[hit], j["t"][hit],
                               rtol=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(out[k].numpy(), j[k], atol=1e-5)
    assert (out["t"].numpy()[~hit] == tpl.BIG).all()


def test_unfused_resolve_equals_fused(res):
    """The fused rows hold the same geometry record: hit, t, tri, u, v
    bit-equal; the fused record adds the shade attributes."""
    a = tpl._resolve_winners_body(res["mwin"], res["slot"], res["orig"],
                                  res["dirs"])
    b = tpl._resolve_winners_body(res["fused"], res["slot"], res["orig"],
                                  res["dirs"])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert {"snormal", "salbedo", "semission"} == set(b) - set(a)


def test_frame_without_resolve_rows(res):
    """traverse_plist and render_image on windows without resolve rows:
    the record equals the fused one's (K1's plain version), and the normal
    frame equals the fused frame exactly (_surface gathers the shade
    attributes)."""
    a = tpl.traverse_plist(res["mwin"], res["orig"], res["dirs"], (H, W))
    b = tpl.traverse_plist(res["fused"], res["orig"], res["dirs"], (H, W))
    assert "snormal" not in a
    for k in ("hit", "t", "tri", "u", "v", "tile_stats"):
        assert torch.equal(a[k], b[k]), k
    img = render_image(res["scene"], res["cam"], RenderOptions(W, H),
                       res["mwin"])
    want = render_image(res["scene"], res["cam"], RenderOptions(W, H),
                        res["fused"])
    assert torch.equal(img, want)


def _entry(entry, mwin, orig, dirs):
    """A windows entry point's record of the primaries: the SO super
    schedule (K1), single windows (K2), gathered tables (K10), sub-gates
    (K11) or 512-ray bundles (K1')."""
    if entry == "super_so":
        return tpl.traverse_plist(mwin, orig, dirs, (H, W))
    if entry == "window":
        return tpl.traverse_plist(mwin, orig, dirs, (H, W), supers=False)
    if entry == "gathered":
        return tpl.traverse_plist(mwin, orig, dirs, (H, W), gathered=True)
    if entry == "subgate":
        return tpl.traverse_plist4(mwin, orig, dirs, (H, W))
    return tpl.traverse_plist_bundle(mwin, orig, dirs)


@pytest.mark.parametrize("entry", ["super_so", "window", "gathered",
                                   "subgate", "bundle"])
def test_entries_without_resolve_rows(res, entry):
    """Every windows entry point resolves its winners without resolve rows
    (on the SO-table windows, which K1 and K10 need): hit, t, tri, u, v
    and tile_stats equal to the fused windows' (the same kernel's plain
    version gives the same slots), and no shade attributes."""
    so = tpl.attach_so(res["mwin"])
    a = _entry(entry, so, res["orig"], res["dirs"])
    b = _entry(entry, tpl.attach_resolve(so, res["scene"].shade_rows),
               res["orig"], res["dirs"])
    assert {"snormal", "salbedo", "semission"} == set(b) - set(a)
    for k in ("hit", "t", "tri", "u", "v", "tile_stats"):
        assert torch.equal(a[k], b[k]), k
    assert 0.5 < float(a["hit"].float().mean()) < 1.0


def test_options_read_no_environment(monkeypatch):
    monkeypatch.setenv("CLPT_SORT_BOUNCES", "0")
    assert RenderOptions().sort_bounces is True


@pytest.fixture(scope="module")
def kd(res):
    """The terrain's kd-tree without SO tables and with them, its records
    and an origin; the JAX package's so_rows of those records."""
    tree = build_kd_tree(res["scene"].tri_corners(), max_depth=8,
                         leaf_size=64, device=CPU)
    recs = packet.pad_records(tree.tris)
    origin = res["orig"][0]
    return dict(tree=tree, so_tree=attach_so_tables(tree), recs=recs,
                origin=origin, jax=np.asarray(jpk.so_rows(
                    jnp.asarray(recs.numpy()),
                    jnp.asarray(origin.numpy()))))


def test_so_rows_matches_jax(kd):
    """so_rows against the JAX package's: allclose (rtol 1e-5, atol 1e-5
    of the largest entry's scale), sentinel rows exactly 0, and the
    layout of so_combine's records (their difference is the rounding of
    the affine tables)."""
    rows = packet.so_rows(kd["recs"], kd["origin"])
    j = kd["jax"]
    assert rows.shape == j.shape == (kd["recs"].shape[0], 16)
    pad = kd["recs"][:, 9] < 0
    assert bool(pad.any())
    assert (rows[pad] == 0).all() and (j[pad.numpy()] == 0).all()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(rows.numpy(), j, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(rows[:, 10].numpy(),
                                  np.where(pad, 0.0, kd["recs"][:, 9]))
    comb = packet.so_combine(kd["so_tree"].so_base, kd["origin"])
    np.testing.assert_allclose(rows.numpy(), comb.numpy(), rtol=1e-4,
                               atol=1e-4 * scale)


def test_packet_frame_without_so_tables(res, kd, monkeypatch):
    """A kd packet normal frame on a tree without SO tables runs K3's SO
    form on the per-frame so_rows (strips on, tile 128): 1 so_rows pass,
    and the primaries within phase 14's budget of the brute force (hit
    mismatch < 2e-3, t rtol 1e-4)."""
    calls = []
    real = packet.so_rows

    def spy(*a):
        calls.append(1)
        return real(*a)
    monkeypatch.setattr(packet, "so_rows", spy)
    _, kw, _ = packet.stream_kernel_args(
        kd["tree"], res["orig"], res["dirs"], (H, W), 2 * TILE,
        shared_origin=True, grid_dirs=True)
    assert kw["so"] and kw["n_strips"] == 1 and len(calls) == 1
    opts = RenderOptions(W, H, intersector="packet", packet_tile=2 * TILE)
    rec = intersect_scene(res["scene"], None, res["orig"], res["dirs"], opts,
                          tree=kd["tree"])
    assert len(calls) == 2
    _, bt = _nearest(res["scene"], res["orig"], res["dirs"])
    bf_hit = torch.isfinite(bt)
    assert float((rec["hit"] != bf_hit).float().mean()) < 2e-3
    both = rec["hit"] & bf_hit
    torch.testing.assert_close(rec["t"][both], bt[both], rtol=1e-4,
                               atol=1e-5)


def test_queue_without_so_tables(res, kd, monkeypatch):
    """engine="queue" (K5) on a tree without SO tables takes the same
    per-frame so_rows as K3 (its SO form, no strips): one so_rows pass,
    and the primaries within phase 14's budget of the brute force."""
    calls = []
    _spy(monkeypatch, packet, "so_rows", calls)
    rec = packet.traverse_packet(kd["tree"], res["orig"], res["dirs"],
                                 (H, W), tile=2 * TILE, engine="queue",
                                 shared_origin=True, grid_dirs=True)
    assert calls == ["so_rows"]
    _, bt = _nearest(res["scene"], res["orig"], res["dirs"])
    bf_hit = torch.isfinite(bt)
    assert float((rec["hit"] != bf_hit).float().mean()) < 2e-3
    both = rec["hit"] & bf_hit
    torch.testing.assert_close(rec["t"][both], bt[both], rtol=1e-4,
                               atol=1e-5)


def test_bf16_without_so_tables_keeps_mt(res, kd, monkeypatch):
    """The bf16 preview (K4) has no SO form, as in the JAX package: on a
    tree without SO tables it takes the MT records and makes no so_rows
    pass, so its record equals the one on the tree with SO tables (the
    frame's top half)."""
    calls = []
    _spy(monkeypatch, packet, "so_rows", calls)
    orig, dirs = res["orig"][:N // 2], res["dirs"][:N // 2]
    kw = dict(image_shape=(H // 2, W), tile=2 * TILE, shared_origin=True,
              grid_dirs=True, precision="bf16")
    rec = packet.traverse_packet(kd["tree"], orig, dirs, **kw)
    assert calls == []
    want = packet.traverse_packet(kd["so_tree"], orig, dirs, **kw)
    for k in ("hit", "t", "tri", "u", "v", "tile_stats"):
        assert torch.equal(rec[k], want[k]), k
    assert 0.5 < float(rec["hit"].float().mean()) < 1.0


def _mirror(res, kd, monkeypatch, **changes):
    """The kd packet mirror frame at 32x16 (tile 64) through render_image,
    and its bounce wave's (orig, dir, active) and record as
    intersect_scene gave them to shade_mirror."""
    waves = []
    real = integrator.intersect_scene

    def spy(*a, **k):
        rec = real(*a, **k)
        if not k.get("coherent", True):
            waves.append((a[2], a[3], k["active"], rec))
        return rec
    monkeypatch.setattr(integrator, "intersect_scene", spy)
    opts = RenderOptions(W, H // 2, mode="mirror", intersector="packet",
                         packet_tile=TILE, **changes)
    img = render_image(res["scene"], res["cam"], opts, tree=kd["tree"])
    monkeypatch.undo()
    (o, d, alive, rec), = waves
    return dict(opts=opts, img=img, o=o, d=d, alive=alive, rec=rec)


@pytest.fixture(scope="module")
def bounce(res, kd):
    """The sorted mirror frame (the default) and its bounce wave."""
    with pytest.MonkeyPatch.context() as mp:
        return _mirror(res, kd, mp)


def _no_sort(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("sort_rays called")
    monkeypatch.setattr(integrator, "sort_rays", fail)


def test_unsorted_mirror_matches_sorted(res, kd, bounce, monkeypatch):
    """sort_bounces=False: the bounce wave goes to K3 unsorted, in the
    frame's pixel-blocked tiles (sort_rays patched to fail): hit equal to
    the sorted wave's, t equal (both walks find each lane's exact
    nearest), tri equal but at exact-t ties; the frames equal on more
    than 99% of pixels."""
    _no_sort(monkeypatch)
    got = _mirror(res, kd, monkeypatch, sort_bounces=False)
    for k in ("o", "d", "alive"):
        assert torch.equal(got[k], bounce[k]), k
    rec, want = got["rec"], bounce["rec"]
    assert torch.equal(rec["hit"], want["hit"])
    assert 0.05 < float(want["hit"].float().mean()) < 0.95
    assert torch.equal(rec["t"], want["t"])
    assert float((rec["tri"] != want["tri"]).float().mean()) < 1e-2
    differ = (got["img"] != bounce["img"]).any(dim=-1).float().mean()
    assert float(differ) < 1e-2


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*a, **k):
        log.append(name)
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)


LANES = 4 * TILE   # the bounce wave's first lanes: the route tests' wave


def _lanes(bounce):
    """orig, dir and active of the bounce wave's first LANES lanes."""
    return (bounce["o"][:LANES], bounce["d"][:LANES],
            bounce["alive"][:LANES])


# (intersector, structures) -> the route of an unsorted scattered wave
ROUTES = {
    "packet+grid": ("packet", ("tree", "grid"), "traverse_packet"),
    "wavefront+grid": ("wavefront", ("tree", "grid"), "traverse_grid"),
    "packet+windows": ("packet", ("tree", "mwin"), "traverse_packet"),
    "wavefront+windows": ("wavefront", ("tree", "mwin"), "traverse_fast"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_unsorted_routes(res, kd, bounce, monkeypatch, case):
    """Where sort_bounces=False sends a scattered wave: with
    intersector="packet", K3 unsorted before the grid; the wavefront
    route keeps the grid (the JAX package reads the option on the packet
    branches only); with windows, the bundles are skipped for the tree's
    branch. Never sorted."""
    intersector, have, want = ROUTES[case]
    _no_sort(monkeypatch)
    log = []
    for name in ("traverse_packet", "traverse_grid", "traverse_fast",
                 "traverse_plist_bundle"):
        _spy(monkeypatch, integrator, name, log)
    opts = dataclasses.replace(bounce["opts"], intersector=intersector,
                               sort_bounces=False)
    structs = dict(tree=kd["tree"],
                   grid=build_grid(res["scene"].tri_corners(), device=CPU),
                   mwin=res["fused"])
    kw = {k: structs[k] for k in have if k != "mwin"}
    o, d, alive = _lanes(bounce)
    rec = intersect_scene(res["scene"], structs["mwin"] if "mwin" in have
                          else None, o, d, opts, coherent=False,
                          active=alive, **kw)
    assert log == [want]
    assert torch.equal(rec["hit"], bounce["rec"]["hit"][:LANES])


def test_unsorted_windows_alone(res, bounce, monkeypatch):
    """Windows alone: an unsorted bounce wave raises ValueError (the JAX
    package has no unsorted bundle route); NEE's shadow query ignores the
    option and keeps the sorted bundles."""
    opts = dataclasses.replace(bounce["opts"], sort_bounces=False)
    with pytest.raises(ValueError, match="sort_bounces"):
        intersect_scene(res["scene"], res["fused"], bounce["o"], bounce["d"],
                        opts, coherent=False, active=bounce["alive"])
    log = []
    _spy(monkeypatch, integrator, "sort_rays", log)
    dist = torch.full(bounce["alive"].shape, 50.0)
    occ = integrator._occluded(res["scene"], bounce["o"], bounce["d"], dist,
                               opts, active=bounce["alive"],
                               mwin=res["fused"])
    assert log == ["sort_rays"]
    assert torch.equal(occ, bounce["rec"]["hit"] & bounce["alive"])


@pytest.mark.parametrize("intersector", ["wavefront", "packet"])
def test_diff_unsorted_is_coherent(res, kd, bounce, monkeypatch,
                                   intersector):
    """The differentiable route takes an unsorted scattered wave as
    coherent (JAX render/integrator.py:180): the grid is skipped, nothing
    is sorted, K3 runs unsorted (intersector="packet") or W1; the hits
    are the plain route's."""
    _no_sort(monkeypatch)
    log = []
    for name in ("traverse_packet", "traverse_grid", "traverse_fast"):
        _spy(monkeypatch, integrator, name, log)
    opts = dataclasses.replace(bounce["opts"], intersector=intersector,
                               sort_bounces=False, differentiable=True)
    o, d, alive = _lanes(bounce)
    rec = intersect_diff(res["scene"], kd["tree"], o, d, opts,
                         coherent=False, active=alive,
                         grid=build_grid(res["scene"].tri_corners(),
                                         device=CPU))
    assert log == ["traverse_packet" if intersector == "packet"
                   else "traverse_fast"]
    want = {k: bounce["rec"][k][:LANES] for k in ("hit", "t")}
    assert torch.equal(rec["hit"], want["hit"])
    torch.testing.assert_close(rec["t"][rec["hit"]], want["t"][rec["hit"]],
                               rtol=1e-5, atol=1e-6)
