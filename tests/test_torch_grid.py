"""Port parity, the uniform grid and its walk: the Cornell box,
fog_likeness and the grid build (bit for bit), and the plain version of
the grid DDA G1 against the JAX package's traverse_grid (XLA, its
wind-down compaction on and off) in four forms and at its edge cases.
K1's kcap form and the two-phase engine that finishes on the DDA are in
tests/test_torch_kcap.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import grid as jgrid
from clpathtracer_tpu.ops import grid_walk as jgw
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch.accel import grid as tgrid
from clpathtracer_tpu_torch.ops.grid_walk import (BIG, traverse_grid,
                                                  traverse_grid_reference)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64
N = H * W


def _soup(module):
    return module.random_tri_soup(20_000, seed=3, extent=10.0, tri_size=0.02,
                                  **({} if module is jproc
                                     else {"device": CPU}))


@pytest.fixture(scope="module")
def soup():
    """A ~20k-triangle soup and its grids in both packages, and a wave of
    random rays (origins in and around the grid's box, unit directions),
    per-ray bounds and a mask with a quarter of the lanes dead."""
    tv = np.asarray(_soup(jproc).tri_corners())
    rng = np.random.default_rng(0)
    o = rng.uniform(-14, 14, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(tv=tv, jg=jgrid.build_grid(tv),
                tg=tgrid.build_grid(tv, device=CPU), o=o, d=d,
                t_max=rng.uniform(0.5, 30.0, N).astype(np.float32),
                active=rng.uniform(size=N) < 0.75)


@pytest.mark.parametrize("scene", ["soup", "cornell"])
def test_build_grid_matches_jax(scene):
    if scene == "soup":
        jtv, ttv = _soup(jproc).tri_corners(), _soup(tproc).tri_corners()
    else:
        jtv = jproc.cornell_box().tri_corners()
        ttv = tproc.cornell_box(device=CPU).tri_corners()
    jtv = np.asarray(jtv)
    np.testing.assert_array_equal(ttv, jtv)
    assert tgrid.fog_likeness(ttv) == jgrid.fog_likeness(jtv)
    a = jgrid.build_grid(jtv)
    b = tgrid.build_grid(ttv, device=CPU)
    assert b.res == a.res
    for k in ("table", "lo", "hi", "h"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)), k)
    assert b.stats() == a.stats()


def test_cornell_box_matches_jax():
    js, ts = jproc.cornell_box(), tproc.cornell_box(device=CPU)
    for k in ("verts", "faces", "normals", "albedo", "emission"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), k)


def test_split_layout_raises(soup):
    """The split layout (meta rows and quad rows) is built bit for bit as
    the JAX package builds it, with the inline layout's cells and entries;
    an unknown layout raises."""
    a = jgrid.build_grid(soup["tv"], layout="split")
    b = tgrid.build_grid(soup["tv"], layout="split", device=CPU)
    assert b.layout == "split" and b.table is None and b.res == a.res
    for k in ("cells", "quads", "lo", "hi", "h"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)), k)
    assert b.stats() == a.stats()
    inline = soup["tg"].stats()
    assert (b.stats()["cells"], b.stats()["entries"]) == (
        inline["cells"], inline["entries"])
    with pytest.raises(ValueError, match="layout"):
        tgrid.build_grid(soup["tv"], layout="packed", device=CPU)


def _both(grid_pair, o, d, compact=True, **kw):
    """The JAX walk and the port's wrapper (its plain version on the CPU)
    on the same rays: (JAX record, port record) as numpy dicts."""
    jg, tg = grid_pair
    jkw = {k: jnp.asarray(v) for k, v in kw.items() if k != "any_hit"}
    tkw = {k: torch.as_tensor(v) for k, v in kw.items() if k != "any_hit"}
    ah = kw.get("any_hit", False)
    j = jgw.traverse_grid(jg, jnp.asarray(o), jnp.asarray(d),
                          compact=compact, any_hit=ah, **jkw)
    t = traverse_grid(tg, torch.as_tensor(o), torch.as_tensor(d),
                      any_hit=ah, **tkw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in t.items()})


def _assert_walks_agree(j, t, tv, o, d):
    """Hits equal; tri equal but at exact-t ties; t to rtol 1e-6 (XLA may
    contract _mt_pre's products into FMAs on the CPU); steps equal on
    99.9% of lanes. u and v are ill-conditioned on small triangles seen
    from afar: JAX's own eager and jitted _mt_pre differ by up to 4e-5
    relative on this fixture. So they are held to the port's _mt_pre of
    the winning triangle exactly, and to JAX's within 5e-4."""
    np.testing.assert_array_equal(t["hit"], j["hit"])
    hit = j["hit"]
    np.testing.assert_allclose(t["t"][hit], j["t"][hit], rtol=1e-6)
    tie = t["tri"] != j["tri"]
    assert not tie[~hit].any()
    np.testing.assert_allclose(t["t"][tie], j["t"][tie], rtol=1e-6)
    assert (t["steps"] == j["steps"]).mean() >= 0.999
    tri = t["tri"][hit]
    v0 = torch.as_tensor(tv[tri, 0])
    _, tt, uu, vv = _mt_pre(v0, torch.as_tensor(tv[tri, 1]) - v0,
                            torch.as_tensor(tv[tri, 2]) - v0,
                            torch.as_tensor(o[hit]), torch.as_tensor(d[hit]))
    np.testing.assert_array_equal(t["t"][hit], tt.numpy())
    np.testing.assert_array_equal(t["u"][hit], uu.numpy())
    np.testing.assert_array_equal(t["v"][hit], vv.numpy())
    for k in ("u", "v"):
        np.testing.assert_allclose(t[k][hit], j[k][hit], atol=5e-4)
        assert (t[k][~hit] == 0.0).all()


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("form", ["nearest", "t_max", "any_hit", "active"])
def test_grid_walk_matches_jax(soup, form, compact):
    kw = {"nearest": {}, "t_max": dict(t_max=soup["t_max"]),
          "any_hit": dict(t_max=soup["t_max"], any_hit=True),
          "active": dict(active=soup["active"])}[form]
    j, t = _both((soup["jg"], soup["tg"]), soup["o"], soup["d"], compact,
                 **kw)
    _assert_walks_agree(j, t, soup["tv"], soup["o"], soup["d"])
    assert 0.05 < t["hit"].mean() < 0.95
    if "t_max" in kw:
        assert (t["t"][t["hit"]] < soup["t_max"][t["hit"]]).all()
    if form == "active":
        assert not t["hit"][~soup["active"]].any()
        assert (t["steps"][~soup["active"]] == 0).all()
    if form == "any_hit":    # the flags of the nearest walk below t_max
        near = traverse_grid(soup["tg"], torch.as_tensor(soup["o"]),
                             torch.as_tensor(soup["d"]))
        below = near["hit"].numpy() & (near["t"].numpy() < soup["t_max"])
        np.testing.assert_array_equal(t["hit"], below)


def test_grid_walk_edge_cases(soup):
    """Rays that miss the grid's box: no hit and no step. Axis-parallel
    rays with their origins on the box's slab planes (the dir == 0 axes
    take the origin-in-slab answer): equal to JAX's walk and to a brute
    force over all triangles."""
    g = soup["tg"]
    lo, hi = g.lo.numpy(), g.hi.numpy()
    rng = np.random.default_rng(1)
    away = rng.uniform(lo, hi, (256, 3)).astype(np.float32)
    away[:, 0] = hi[0] + 1.0                      # beside the box, +x of it
    d_away = np.tile(np.float32([1.0, 0.0, 0.0]), (256, 1))
    rec = traverse_grid(g, torch.as_tensor(away), torch.as_tensor(d_away))
    assert not rec["hit"].any() and not rec["steps"].any()
    assert (rec["t"] == BIG).all() and (rec["tri"] == -1).all()

    rays_o, rays_d = [], []
    for ax in range(3):
        for plane in (lo, hi):
            o = rng.uniform(lo, hi, (128, 3)).astype(np.float32)
            o[:, (ax + 1) % 3] = plane[(ax + 1) % 3]   # on a slab plane
            d = np.zeros((128, 3), np.float32)
            d[:, ax] = np.where(np.arange(128) % 2, 1.0, -1.0)
            rays_o.append(o)
            rays_d.append(d)
    # padded with the fixture's rays to its wave width, the shape of the
    # JAX walks already compiled
    o = np.concatenate(rays_o + [soup["o"][768:]])
    d = np.concatenate(rays_d + [soup["d"][768:]])
    j, t = _both((soup["jg"], g), o, d, compact=False)
    _assert_walks_agree(j, t, soup["tv"], o, d)
    assert (t["steps"][:768] > 0).all()
    tv = soup["tv"]
    v0 = torch.as_tensor(tv[None, :, 0])
    ok, tt, _, _ = _mt_pre(v0, torch.as_tensor(tv[None, :, 1]) - v0,
                           torch.as_tensor(tv[None, :, 2]) - v0,
                           torch.as_tensor(o[:768])[:, None],
                           torch.as_tensor(d[:768])[:, None])
    bf = torch.where(ok, tt, float("inf")).amin(dim=1).numpy()
    hit = t["hit"][:768]
    np.testing.assert_array_equal(hit, np.isfinite(bf))
    np.testing.assert_allclose(t["t"][:768][hit], bf[hit], rtol=1e-6)


def test_traverse_grid_checks(soup):
    o = torch.as_tensor(soup["o"])
    with pytest.raises(ValueError, match="any_hit needs t_max"):
        traverse_grid(soup["tg"], o, o, any_hit=True)
    with pytest.raises(ValueError):
        traverse_grid(soup["tg"], o.double(), o.double())
    rec = traverse_grid_reference(soup["tg"], o, torch.as_tensor(soup["d"]),
                                  max_iters=3)
    assert int(rec["steps"].max()) == 3
