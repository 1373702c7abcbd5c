"""Port parity, K1's kcap form and the two-phase straggler engine that
finishes on the grid DDA (traverse_plist(kcap=, grid=)): the plain K1 at
kcap 3 against the JAX kernel at kcap 3 (Pallas interpret mode, the
file's one compile) on a ~20k-triangle soup's primary gates, the port's
two-phase traverse_plist at kcap 1, 3 and 24 against its own
single-phase run (tests/test_plist.py::test_plist_two_phase_parity's
contract) and at kcap 3 against the JAX package's two-phase run (which
reuses that compile), and the two-phase and grid-bounce routes through
render_image."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel import grid as jgrid
from clpathtracer_tpu.core import camera as jcam
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import grid as tgrid
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops.packet import BIG, _blockify, so_combine
from clpathtracer_tpu_torch.render import integrator as tint
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64
N = H * W
KCAP = 3


def _soup(module):
    return module.random_tri_soup(20_000, seed=3, extent=10.0, tri_size=0.02,
                                  **({} if module is jproc
                                     else {"device": CPU}))


@pytest.fixture(scope="module")
def kcap_ref():
    """The JAX package's K1 at kcap 3 (one interpret-mode compile) on the
    soup's primary gates (camera [0, 0, -25] looking +z, win_rows 8), its
    two-phase traverse_plist at kcap 3 (the same compile) and
    single-phase one, and the same state carried into the port."""
    js = _soup(jproc).bake_shading()
    tv = np.asarray(js.tri_corners())
    jw = jpl.attach_resolve(
        jpl.attach_so(jpl.build_morton_windows(tv, win_rows=8)),
        js.shade_rows)
    cam = jcam.Camera.create(position=[0.0, 0.0, -25.0],
                             forward=[0.0, 0.0, 1.0])
    orig, dirs = jcam.generate_rays(jcam.cam_matrix(cam, H), W, H)
    dir_b = _blockify(torch.as_tensor(np.array(dirs)), H, W, tpl.GH, tpl.GW)
    o = np.asarray(orig)[0]
    # the jitted prepass, as traverse_plist calls it (one compile for both)
    key, sid, bits = jpl._gate_lists_super(jw.win_bnd,
                                           jnp.asarray(dir_b.numpy()),
                                           jnp.asarray(o), 8, dilate_px=0.0,
                                           gh=tpl.GH)
    rows128 = (jw.so_base[0] + o[0] * jw.so_base[1] + o[1] * jw.so_base[2]
               + o[2] * jw.so_base[3])
    out = jpl._plist_super_call(
        key, sid, bits, rows128.reshape(-1, 8, 128),
        jnp.broadcast_to(jnp.asarray(o)[:, None], (3, N)),
        jnp.asarray(dir_b.numpy().T), jnp.full((1, N), BIG, jnp.float32),
        interpret=True, so=True, win_rows=8, kcap=KCAP, d0cull=False,
        tup_every=jpl.TUP_EVERY, nobits=False)
    grid = jgrid.build_grid(tv)
    return dict(
        jw=jw, key=key, sid=sid, bits=bits, o=o, dir_b=dir_b, grid=grid,
        k1={k: np.asarray(v) for k, v in zip(("t", "slot", "stats"), out)},
        tw=interop.windows_from_numpy(jw.tris128, jw.win_bnd, jw.so_base,
                                      jw.resolve_rows, jw.slot_of_tri, 8,
                                      device=CPU),
        tgrid=tgrid.build_grid(tv, device=CPU), tv=tv,
        orig=torch.as_tensor(np.array(orig)),
        dirs=torch.as_tensor(np.array(dirs)))


@pytest.fixture(scope="module")
def jax_two_phase(kcap_ref):
    """The JAX package's two-phase traverse_plist at kcap 3
    (CLPT_PLIST_KCAP, read at call time)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CLPT_PLIST_KCAP", str(KCAP))
    try:
        rec = jpl.traverse_plist(kcap_ref["jw"], jnp.asarray(kcap_ref["orig"]),
                                 jnp.asarray(kcap_ref["dirs"]), (H, W),
                                 supers=True, grid=kcap_ref["grid"])
    finally:
        mp.undo()
    return {k: np.asarray(v) for k, v in rec.items()}


def test_plist_super_kcap_reference_vs_jax(kcap_ref):
    """The plain K1 at kcap 3 on the JAX package's own lists: slots and
    all five stats lanes equal the JAX kernel's, t at the SO tolerance of
    tests/test_torch_plist_sched.py (XLA rounds the SO quotient
    otherwise); the cap streams fewer supers than the uncapped run."""
    r = kcap_ref
    n_gates = N // tpl.GATE
    n_supers = r["tw"].num_windows // tpl.SUPER

    def flat(x, dtype):  # [G, C, 8, 128] chunk packing -> [G, Ls]
        x = np.asarray(x).transpose(0, 1, 3, 2).reshape(n_gates, -1)
        return torch.as_tensor(x[:, :n_supers].astype(dtype))
    key, sid, bits = (flat(r["key"], np.float32), flat(r["sid"], np.int32),
                      flat(r["bits"], np.int32))
    rows = so_combine(r["tw"].so_base, torch.as_tensor(r["o"].copy()))
    dir_t = r["dir_b"].T.contiguous()
    t0 = torch.full((N,), BIG)
    best_t, best_slot, stats = tpl.plist_super(key, sid, bits, rows, dir_t,
                                               t0, win_rows=8, kcap=KCAP)
    np.testing.assert_array_equal(best_slot.numpy(),
                                  r["k1"]["slot"][0].astype(np.int32))
    np.testing.assert_array_equal(
        stats.numpy(), r["k1"]["stats"][::8, :5].astype(np.int32))
    hit = best_slot.numpy() >= 0
    np.testing.assert_allclose(best_t.numpy()[hit], r["k1"]["t"][0][hit],
                               rtol=1e-4)
    assert (stats[:, 3] <= KCAP).all()
    full = tpl.plist_super(key, sid, bits, rows, dir_t, t0, win_rows=8)
    assert int(stats[:, 3].sum()) < int(full[2][:, 3].sum())


def _assert_two_phase(rec, ref):
    """tests/test_plist.py::test_plist_two_phase_parity's contract: hits
    equal, t to rtol 1e-5, triangle ids equal on more than 95% of hits."""
    hit, rhit = np.asarray(rec["hit"]), np.asarray(ref["hit"])
    np.testing.assert_array_equal(hit, rhit)
    both = hit & rhit
    np.testing.assert_allclose(np.asarray(rec["t"])[both],
                               np.asarray(ref["t"])[both], rtol=1e-5,
                               atol=1e-6)
    assert (np.asarray(rec["tri"])[both]
            == np.asarray(ref["tri"])[both]).mean() > 0.95


@pytest.mark.parametrize("kcap", [1, KCAP, 24])
def test_two_phase_matches_single_phase(kcap_ref, kcap):
    r = kcap_ref
    ref = tpl.traverse_plist(r["tw"], r["orig"], r["dirs"], (H, W))
    rec = tpl.traverse_plist(r["tw"], r["orig"], r["dirs"], (H, W),
                             kcap=kcap, grid=r["tgrid"])
    _assert_two_phase(rec, ref)
    assert 0.2 < ref["hit"].float().mean() < 1.0
    # engagement canary: a small phase-1 budget streams fewer windows (the
    # stats count phase 1 only)
    if kcap <= KCAP:
        assert (int(rec["tile_stats"][:, 1].sum())
                < int(ref["tile_stats"][:, 1].sum()))
    # the MT form (no SO tables) gives the same record
    mt = tpl.traverse_plist(r["tw"].replace(so_base=None), r["orig"],
                            r["dirs"], (H, W), kcap=kcap, grid=r["tgrid"])
    _assert_two_phase(mt, ref)


def test_two_phase_matches_jax(kcap_ref, jax_two_phase):
    r = kcap_ref
    rec = tpl.traverse_plist(r["tw"], r["orig"], r["dirs"], (H, W),
                             kcap=KCAP, grid=r["tgrid"])
    _assert_two_phase(rec, jax_two_phase)
    np.testing.assert_array_equal(rec["tile_stats"].numpy(),
                                  jax_two_phase["tile_stats"]
                                  .astype(np.int32))


@pytest.mark.parametrize("case", ["no_grid", "window", "gathered"])
def test_kcap_needs_grid_and_supers(kcap_ref, case):
    r = kcap_ref
    kw = {"no_grid": {}, "window": dict(grid=r["tgrid"], supers=False),
          "gathered": dict(grid=r["tgrid"], gathered=True)}[case]
    with pytest.raises(ValueError, match="kcap"):
        tpl.traverse_plist(r["tw"], r["orig"], r["dirs"], (H, W), kcap=KCAP,
                           **kw)


def test_render_with_kcap_and_bounce_grid(kcap_ref):
    """Through render_image: a normal frame with plist_kcap equals the
    single-phase frame but at tie winners; a mirror frame whose bounce
    wave takes the grid keeps its hits; plist_kcap without a grid
    raises."""
    r = kcap_ref
    scene = _soup(tproc).bake_shading()
    mwin = tpl.attach_resolve(tpl.attach_so(tpl.build_morton_windows(
        scene.tri_corners(), 8, device=CPU)), scene.shade_rows)
    cam = tcam.Camera.create([0.0, 0.0, -25.0], [0.0, 0.0, 1.0], device=CPU)
    base = tint.render_image(scene, cam, tint.RenderOptions(W, H), mwin)
    two = tint.render_image(scene, cam, tint.RenderOptions(W, H,
                                                           plist_kcap=KCAP),
                            mwin, grid=r["tgrid"])
    assert ((two - base).abs().amax(dim=-1) > 1e-5).float().mean() < 1.5e-2
    m = tint.RenderOptions(W, H, mode="mirror")
    a = tint.render_image(scene, cam, m, mwin)
    b = tint.render_image(scene, cam, m, mwin, grid=r["tgrid"])
    assert ((a - b).abs().amax(dim=-1) > 1e-5).float().mean() < 1.5e-2
    with pytest.raises(ValueError, match="plist_kcap"):
        tint.render_image(scene, cam, tint.RenderOptions(W, H, plist_kcap=2),
                          mwin)


def test_bounce_grid_off_takes_bundles(kcap_ref):
    """bounce_grid=False with a grid given: the bounce wave takes the
    sorted bundles (K1'), as with no grid, so the mirror frame equals the
    no-grid frame exactly."""
    scene = _soup(tproc).bake_shading()
    mwin = tpl.attach_resolve(tpl.attach_so(tpl.build_morton_windows(
        scene.tri_corners(), 8, device=CPU)), scene.shade_rows)
    cam = tcam.Camera.create([0.0, 0.0, -25.0], [0.0, 0.0, 1.0], device=CPU)
    m = tint.RenderOptions(W, H, mode="mirror")
    a = tint.render_image(scene, cam, m, mwin)
    off = tint.render_image(scene, cam,
                            tint.RenderOptions(W, H, mode="mirror",
                                               bounce_grid=False),
                            mwin, grid=kcap_ref["tgrid"])
    assert torch.equal(off, a)
