"""Port parity, the uniform grid's split layout: the build (cells and quad
rows) bit for bit against the JAX package's build_grid(layout="split") on
tests/test_grid.py's inputs, the plain version of G1's split form against
the JAX package's traverse_grid on that layout (XLA, body_split), the
split walk against the port's own inline walk, the interop carrier of
both layouts, and a NEE path frame over each layout. No Pallas call."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import grid as jgrid
from clpathtracer_tpu.ops import grid_walk as jgw
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import grid as tgrid
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops.grid_walk import (traverse_grid,
                                                  traverse_grid_reference)
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 2048
FORMS = {"nearest": {}, "t_max": {"t_max"}, "any_hit": {"t_max", "any_hit"},
         "active": {"active"}}


def _tv(scene):
    return np.asarray(scene.tri_corners(), np.float32)


@pytest.mark.parametrize("case", ["soup", "icosphere"])
def test_split_build_matches_jax(case):
    """tests/test_grid.py's split builds: a 500-triangle soup at res
    (7, 5, 6) and icosphere(2) at res 4. Cells and quads bit-equal, the
    stats equal, every cell's count the number of real records in its
    quad rows, and the inline layout's cells and entries."""
    if case == "soup":
        tv = _tv(jproc.random_tri_soup(500, seed=0, extent=2.0,
                                       tri_size=0.1))
        res = (7, 5, 6)
    else:
        tv = _tv(jproc.icosphere(2))
        res = 4
    a = jgrid.build_grid(tv, res=res, layout="split")
    b = tgrid.build_grid(tv, res=res, layout="split", device=CPU)
    assert b.layout == "split" and b.table is None and b.res == a.res
    for k in ("cells", "quads", "lo", "hi", "h"):
        np.testing.assert_array_equal(getattr(b, k).numpy(),
                                      np.asarray(getattr(a, k)), k)
    assert b.stats() == a.stats()
    cells = b.cells.numpy()
    recs = b.quads.numpy().reshape(-1, 16)
    assert int(cells[:, 1].sum()) == int((recs[:, 9] >= 0).sum())
    inline = tgrid.build_grid(tv, res=res, device=CPU).stats()
    assert (b.stats()["cells"], b.stats()["entries"]) == (
        inline["cells"], inline["entries"])


@pytest.fixture(scope="module")
def walk():
    """A 3000-triangle soup (tests/test_grid.py's), its split grid in both
    packages and its inline grid in the port; a wave of N random rays in
    and around the grid, bounds, a mask; the JAX split walk of each form
    (compact=False: one while loop), run once."""
    tv = _tv(jproc.random_tri_soup(3000, seed=1, extent=2.0, tri_size=0.05))
    rng = np.random.default_rng(0)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kw = dict(t_max=rng.uniform(0.2, 4.0, N).astype(np.float32),
              active=rng.uniform(size=N) < 0.75)
    jg = jgrid.build_grid(tv, layout="split")
    jax_recs = {}
    for form, keys in FORMS.items():
        r = jgw.traverse_grid(jg, jnp.asarray(o), jnp.asarray(d),
                              compact=False, any_hit="any_hit" in keys,
                              **{k: jnp.asarray(kw[k]) for k in keys
                                 if k != "any_hit"})
        jax_recs[form] = {k: np.asarray(v) for k, v in r.items()}
    return dict(tv=tv, o=o, d=d, kw=kw, jax=jax_recs,
                split=tgrid.build_grid(tv, layout="split", device=CPU),
                inline=tgrid.build_grid(tv, device=CPU))


def _port(w, grid, form):
    keys = FORMS[form]
    rec = traverse_grid(grid, torch.as_tensor(w["o"]),
                        torch.as_tensor(w["d"]), any_hit="any_hit" in keys,
                        **{k: torch.as_tensor(w["kw"][k]) for k in keys
                           if k != "any_hit"})
    return {k: v.numpy() for k, v in rec.items()}


@pytest.mark.parametrize("form", list(FORMS))
def test_split_walk_matches_jax(walk, form):
    """The plain split walk against the JAX package's: hit and steps (quad
    rows) equal; t allclose (rtol 1e-5, atol 1e-6: XLA may contract
    _mt_pre's products into FMAs); tri equal on more than 95% of hits
    (exact-t ties may pick another duplicate); no hit on dead lanes."""
    j, t = walk["jax"][form], _port(walk, walk["split"], form)
    np.testing.assert_array_equal(t["hit"], j["hit"])
    np.testing.assert_array_equal(t["steps"], j["steps"])
    hit = j["hit"]
    assert 0.02 < hit.mean() < 0.95
    np.testing.assert_allclose(t["t"][hit], j["t"][hit], rtol=1e-5,
                               atol=1e-6)
    assert (t["tri"][hit] == j["tri"][hit]).mean() > 0.95
    assert (t["tri"][~hit] == -1).all()
    if form == "active":
        assert not t["hit"][~walk["kw"]["active"]].any()
        assert (t["steps"][~walk["kw"]["active"]] == 0).all()


@pytest.mark.parametrize("form", list(FORMS))
def test_split_walk_matches_inline(walk, form):
    """The two layouts hold the same records in the same order within a
    cell (tests/test_grid.py:142-146): hit, t and tri equal for the
    nearest forms; any-hit's flags equal (its t and tri are a hit)."""
    s, i = _port(walk, walk["split"], form), _port(walk, walk["inline"],
                                                  form)
    np.testing.assert_array_equal(s["hit"], i["hit"])
    if form != "any_hit":
        for k in ("t", "tri", "u", "v"):
            np.testing.assert_array_equal(s[k], i[k], k)


def test_split_walk_tally_and_cap(walk):
    """The tally counts the split form's pairs and bytes (8 of meta on a
    cell's first quad row, 48 a record held), and max_iters caps the quad
    rows a ray reads."""
    o, d = torch.as_tensor(walk["o"][:256]), torch.as_tensor(walk["d"][:256])
    tally = torch.zeros(5, dtype=torch.int64)
    rec = traverse_grid_reference(walk["split"], o, d, tally=tally)
    assert int(tally[0]) >= int(tally[1]) >= int(tally[2]) >= int(tally[3])
    assert int(tally[3]) >= int(rec["hit"].sum())
    assert int(tally[4]) >= 48 * int(tally[0])
    assert (int(tally[4]) - 48 * int(tally[0])) % 8 == 0
    capped = traverse_grid_reference(walk["split"], o, d, max_iters=2)
    assert int(capped["steps"].max()) == 2


@pytest.mark.parametrize("layout", ["inline", "split"])
def test_grid_from_numpy(walk, layout):
    """The interop carrier rebuilds the JAX package's grid of either
    layout as the port's build of it, field for field; a grid with
    neither layout's tables raises."""
    jg = jgrid.build_grid(walk["tv"], layout=layout)
    g = interop.grid_from_numpy(
        np.asarray(jg.lo), np.asarray(jg.hi), np.asarray(jg.h), jg.res,
        table=None if jg.table is None else np.asarray(jg.table),
        cells=None if jg.cells is None else np.asarray(jg.cells),
        quads=None if jg.quads is None else np.asarray(jg.quads),
        device=CPU)
    want = walk[layout]
    assert g.layout == layout and g.res == want.res
    for k in ("table", "cells", "quads", "lo", "hi", "h"):
        a, b = getattr(g, k), getattr(want, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert torch.equal(a, b), k
    with pytest.raises(ValueError):
        interop.grid_from_numpy(np.asarray(jg.lo), np.asarray(jg.hi),
                                np.asarray(jg.h), jg.res, device=CPU)


def test_nee_frame_split_equals_inline():
    """A small NEE path frame over the emissive soup (bounce waves and
    shadow waves on the grid: G1's plain version) is the same image over
    either layout, exactly."""
    soup = tproc.random_tri_soup(3000, seed=0, extent=2.0, tri_size=0.05,
                                 emissive_frac=0.01, device=CPU)
    soup = soup.bake_shading()
    cam = Camera.create([0.0, 0.0, -4.0], [0.0, 0.0, 1.0], device=CPU)
    opts = RenderOptions(24, 24, mode="path", nee=True, bounces=2,
                         background=0.0)
    tv = soup.tri_corners()
    imgs = [render_image(soup, cam, opts, grid=tgrid.build_grid(
        tv, layout=layout, device=CPU),
        generator=torch.Generator().manual_seed(0))
        for layout in ("inline", "split")]
    assert float(imgs[0].mean()) > 0.0
    assert torch.equal(imgs[0], imgs[1])
