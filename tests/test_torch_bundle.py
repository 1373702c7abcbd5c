"""Port parity, sorted bounce bundles and kernel K1' (the general
Moller-Trumbore form of the super-list kernel): ray sort keys, bundle
keys and lists, and the port's traverse_plist_bundle (K1' in its plain
torch version on the CPU) against the JAX package's traverse_plist_bundle
(its Pallas kernel in interpret mode, one compile) on 2048 Morton-sorted
random rays, a ~30k-triangle terrain at win_rows 8, as in
tests/test_plist.py::test_plist_bundle_parity_vs_wavefront.

The parity rule is tests/test_plist.py's: hit masks equal, t allclose on
common hits (rtol 1e-5, atol 1e-6), triangle ids equal on more than 95%
of hits (exact-t ties are a documented freedom)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.ops import sort as jsort
from clpathtracer_tpu.scene.procedural import terrain_mesh
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops import sort as tsort
from clpathtracer_tpu_torch.ops.packet import BIG

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 2048
WR = 8


def _rays(seed, n=N):
    rng = np.random.default_rng(seed)
    orig = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orig, d


@pytest.fixture(scope="module")
def ref():
    """One JAX traverse_plist_bundle run (one interpret-mode compile) and
    the port's windows of the same scene."""
    scene = terrain_mesh(30_000, seed=0, extent=10.0).bake_shading()
    tv = np.asarray(scene.tri_corners())
    jw = jpl.build_morton_windows(tv, win_rows=WR)
    orig, d = _rays(3)
    perm, _ = jsort.sort_rays(jnp.asarray(orig), jnp.asarray(d))
    perm = np.asarray(perm)
    rec = jpl.traverse_plist_bundle(jw, jnp.asarray(orig[perm]),
                                    jnp.asarray(d[perm]))
    tw = tpl.build_morton_windows(tv, WR, device=CPU)
    tw = tpl.attach_resolve(tw, torch.as_tensor(np.array(scene.shade_rows)))
    return dict(tv=tv, jw=jw, tw=tw, orig=orig, d=d, perm=perm,
                rec={k: np.asarray(v) for k, v in rec.items()})


def _assert_parity(rec, ref):
    h_p, h_r = rec["hit"].numpy(), np.asarray(ref["hit"])
    np.testing.assert_array_equal(h_p, h_r)
    both = h_p & h_r
    assert both.any()
    np.testing.assert_allclose(rec["t"].numpy()[both],
                               np.asarray(ref["t"])[both], rtol=1e-5,
                               atol=1e-6)
    tri_eq = (rec["tri"].numpy()[both] == np.asarray(ref["tri"])[both]).mean()
    assert tri_eq > 0.95, tri_eq


def _sorted_trace(tw, orig, d, active=None, t_max=None):
    """Sort, trace in bundles, restore wave order (the integrator's
    scattered-wave route)."""
    o, dd = torch.as_tensor(orig), torch.as_tensor(d)
    perm, inv = tsort.sort_rays(o, dd, alive=active)
    rec = tpl.traverse_plist_bundle(
        tw, o[perm], dd[perm], active=None if active is None else active[perm],
        t_max=None if t_max is None else t_max[perm])
    return {k: (v[inv] if v.shape[:1] == perm.shape else v)
            for k, v in rec.items()}


@pytest.mark.parametrize("alive", ["all", "half"])
def test_sort_keys_and_perm_match_jax(alive):
    orig, d = _rays(7)
    # a few exact ties of the keys: duplicated rays keep their wave order
    orig[100:140] = orig[100]
    d[100:140] = d[100]
    act = np.arange(N) % 3 != 0 if alive == "half" else None
    jact = None if act is None else jnp.asarray(act)
    tact = None if act is None else torch.as_tensor(act)
    jk = np.asarray(jsort.ray_sort_keys(jnp.asarray(orig), jnp.asarray(d),
                                        jact))
    tk = tsort.ray_sort_keys(torch.as_tensor(orig), torch.as_tensor(d), tact)
    assert tk.dtype == torch.int32
    np.testing.assert_array_equal(tk.numpy(), jk)
    jp, ji = jsort.sort_rays(jnp.asarray(orig), jnp.asarray(d), jact)
    tp, ti = tsort.sort_rays(torch.as_tensor(orig), torch.as_tensor(d), tact)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if act is not None:      # dead rays sort to the tail
        assert not act[tp.numpy()[act.sum():]].any()


@pytest.mark.parametrize("case", ["sorted", "dead_lanes", "signed_zeros"])
def test_bundle_keys_match_jax(ref, case):
    orig, d = ref["orig"][ref["perm"]], ref["d"][ref["perm"]].copy()
    if case == "dead_lanes":
        d[N // 2 + 100:] = 0.0
    elif case == "signed_zeros":
        # axis-parallel lanes with +0 and -0 components, as reflect gives
        d[::5, 0] = -0.0
        d[1::5, 2] = 0.0
        d[2::7, 1] = -0.0
    ob, db = orig.reshape(-1, tpl.GATE, 3), d.reshape(-1, tpl.GATE, 3)
    jk = np.asarray(jpl._bundle_keys(ref["jw"].win_bnd, jnp.asarray(ob),
                                     jnp.asarray(db)))
    tk = tpl._bundle_keys(ref["tw"].win_bnd, torch.as_tensor(ob),
                          torch.as_tensor(db)).numpy()
    flips = np.isfinite(jk) != np.isfinite(tk)
    print(f"{case}: borderline window flips {flips.sum()} of {jk.size}")
    assert flips.mean() <= 1e-3
    both = np.isfinite(jk) & np.isfinite(tk)
    assert both.any() and np.isinf(jk).any()
    np.testing.assert_array_equal(tk[both], jk[both])


def _flat_lists(jlists, n_b, n_supers):
    """JAX's [B, C, 8, 128] chunk packing -> flat [B, Ls] tensors."""
    out = []
    for x, dtype in zip(jlists, (np.float32, np.int32, np.int32)):
        x = np.asarray(x).transpose(0, 1, 3, 2).reshape(n_b, -1)
        out.append(torch.as_tensor(x[:, :n_supers].astype(dtype)))
    return out


def test_plist_super_mt_reference_on_jax_lists(ref):
    """K1's general form, plain version, on the JAX package's own bundle
    lists and records: winners resolve to the JAX hits, and windows and
    supers per bundle equal the JAX kernel's."""
    tw = ref["tw"]
    o = torch.as_tensor(ref["orig"][ref["perm"]])
    d = torch.as_tensor(ref["d"][ref["perm"]])
    n_b = N // tpl.GATE
    jl = jpl._bundle_lists(ref["jw"].win_bnd,
                           jnp.asarray(o.numpy().reshape(n_b, -1, 3)),
                           jnp.asarray(d.numpy().reshape(n_b, -1, 3)))
    key, sid, bits = _flat_lists(jl, n_b, tw.num_windows // tpl.SUPER)
    t0 = torch.full((N,), BIG)
    best_t, best_slot, stats = tpl.plist_super_mt_reference(
        key, sid, bits, tw.tris, o.T.contiguous(), d.T.contiguous(), t0,
        win_rows=WR)
    assert ((best_slot >= 0) == (best_t < BIG)).all()
    np.testing.assert_array_equal(stats.numpy(),
                                  ref["rec"]["tile_stats"].astype(np.int32))
    rec = tpl._resolve_winners(tw, best_slot, o, d, stats)
    _assert_parity(rec, ref["rec"])
    # the wrapper takes the plain version for CPU tensors
    again = tpl.plist_super_mt(key, sid, bits, tw.tris, o.T.contiguous(),
                               d.T.contiguous(), t0, win_rows=WR)
    for a, b in zip(again, (best_t, best_slot, stats)):
        assert torch.equal(a, b)


def test_plist_super_mt_reference_tally(ref):
    """The plain K1' tallies the tested pairs that pass det, then u, then
    v: on one bundle against one super of 16 windows, equal to the same
    test written in numpy, and the outputs do not change."""
    tw = ref["tw"]
    o = ref["orig"][ref["perm"]][:tpl.GATE]
    d = ref["d"][ref["perm"]][:tpl.GATE]
    s = 3
    key = torch.zeros((1, 1))
    sid = torch.tensor([[s]], dtype=torch.int32)
    bits = torch.tensor([[(1 << tpl.SUPER) - 1]], dtype=torch.int32)
    args = (key, sid, bits, tw.tris, torch.as_tensor(o.T.copy()),
            torch.as_tensor(d.T.copy()), torch.full((tpl.GATE,), BIG))
    tally = torch.zeros(3, dtype=torch.int64)
    out = tpl.plist_super_mt_reference(*args, win_rows=WR, tally=tally)
    plain = tpl.plist_super_mt_reference(*args, win_rows=WR)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert out[2][0, 1] == tpl.SUPER
    win_tris = WR * 8
    r = tw.tris.numpy()[s * tpl.SUPER * win_tris:
                        (s + 1) * tpl.SUPER * win_tris][None]
    ox, oy, oz = (o[:, None, i] for i in range(3))
    dx, dy, dz = (d[:, None, i] for i in range(3))
    e1x, e1y, e1z, e2x, e2y, e2z = (r[..., i] for i in range(3, 9))
    px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    invd = np.float32(1.0) / np.where(det == 0, np.float32(1.0), det)
    tx, ty, tz = ox - r[..., 0], oy - r[..., 1], oz - r[..., 2]
    u = (tx * px + ty * py + tz * pz) * invd
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * invd
    p_det = det > 0
    p_u = p_det & (u >= 0) & (u <= 1)
    p_v = p_u & (v >= 0) & (u + v <= 1)
    want = [int(p_det.sum()), int(p_u.sum()), int(p_v.sum())]
    assert tally.tolist() == want
    assert 0 < want[2] < want[1] < want[0] < tpl.GATE * tpl.SUPER * win_tris


def test_traverse_plist_bundle_vs_jax(ref):
    """The port's whole bundle route (its own lists, K1' plain) against
    the JAX kernel. Windows and supers per bundle: the port stops a
    bundle with the t_upper refreshed after the current super, the TPU
    kernel (which prefetches the next super) with the one before it, so
    the port's counts can only be lower; this fixture shows them equal."""
    tw = ref["tw"]
    o = torch.as_tensor(ref["orig"][ref["perm"]])
    d = torch.as_tensor(ref["d"][ref["perm"]])
    rec = tpl.traverse_plist_bundle(tw, o, d)
    _assert_parity(rec, ref["rec"])
    js = ref["rec"]["tile_stats"].astype(np.int32)
    ts = rec["tile_stats"].numpy()
    assert (ts[:, [1, 3, 4]] <= js[:, [1, 3, 4]]).all()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(rec["u"].numpy()[rec["hit"].numpy()],
                               ref["rec"]["u"][ref["rec"]["hit"]],
                               rtol=1e-4, atol=1e-5)


def test_bundle_active_mask(ref):
    """Dead lanes never hit; live lanes equal the all-alive trace (the
    check of tests/test_plist.py::test_plist_bundle_active_mask)."""
    orig, d = _rays(5, 1024)
    full = _sorted_trace(ref["tw"], orig, d)
    act = torch.as_tensor(np.arange(1024) % 2 == 0)
    rec = _sorted_trace(ref["tw"], orig, d, active=act)
    assert not rec["hit"][~act].any()
    assert torch.equal(rec["hit"][act], full["hit"][act])
    h = act & full["hit"]
    assert h.any()
    assert torch.equal(rec["t"][h], full["t"][h])


def test_all_dead_bundle_streams_only_zero_keys(ref):
    """A bundle whose lanes are all dead (t0 = 0) streams exactly the
    supers whose key is 0 (windows holding a lane's origin box) and hits
    nothing, as the TPU kernel does."""
    orig, d = _rays(9, tpl.GATE)
    o = torch.as_tensor(orig) / 12.0        # origins in [-1, 1]^3
    dz = torch.zeros((tpl.GATE, 3))
    rec = tpl.traverse_plist_bundle(ref["tw"], o, torch.as_tensor(d),
                                    active=torch.zeros(tpl.GATE, dtype=bool))
    assert not rec["hit"].any()
    key, _, bits = tpl._bundle_lists(ref["tw"].win_bnd, o[None], dz[None])
    zero = key[0] == 0.0
    assert zero.any() and not zero.all()
    n_win = int(sum(bin(int(b)).count("1") for b in bits[0][zero]))
    assert rec["tile_stats"][0].tolist() == [0, n_win, tpl.GATE,
                                             int(zero.sum()), n_win]


def test_bundle_t_max_seeds(ref):
    """Per-lane t_max seeds leave every hit with t < t_max unchanged and
    only cut work. Coherent rays (a narrow downward cone from a small box
    above the terrain) so that the keys spread and the break can cut."""
    rng = np.random.default_rng(11)
    n = 1024
    orig = (rng.uniform(-1, 1, (n, 3)) + [0.0, 8.0, 0.0]).astype(np.float32)
    d = np.stack([rng.normal(scale=0.2, size=n), -np.ones(n),
                  rng.normal(scale=0.2, size=n)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    full = _sorted_trace(ref["tw"], orig, d)
    scale = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32)
    t_max = torch.where(full["hit"], full["t"] * scale, 1.0)
    rec = _sorted_trace(ref["tw"], orig, d, t_max=t_max)
    keep = full["hit"] & (full["t"] < t_max)
    assert keep.any() and (~keep & full["hit"]).any()
    assert torch.equal(rec["hit"][keep], full["hit"][keep])
    assert torch.equal(rec["t"][keep], full["t"][keep])
    assert (rec["tile_stats"][:, 1] <= full["tile_stats"][:, 1]).all()
    # short bounds on every lane (shadow rays to a near light) cut work
    near = _sorted_trace(ref["tw"], orig, d, t_max=full["t"] * 0.5)
    assert near["tile_stats"][:, 1].sum() < full["tile_stats"][:, 1].sum()


def test_traverse_plist_general_form_vs_so(ref):
    """traverse_plist without shared-origin tables runs K1' on the raw
    records: the same hits as the SO route, within the SO edge-flip
    budget of tests/test_plist.py::test_plist_so_affine_parity."""
    tw = ref["tw"]
    cam = tcam.Camera.create([0.0, 14.0, 0.0], [0.0, -1.0, 0.01], device=CPU)
    orig, dirs = tcam.generate_rays(tcam.cam_matrix(cam, 64), 64, 64)
    rec_gen = tpl.traverse_plist(tw, orig, dirs, (64, 64))
    rec_so = tpl.traverse_plist(tpl.attach_so(tw), orig, dirs, (64, 64))
    assert (rec_gen["hit"] != rec_so["hit"]).float().mean() < 2e-3
    both = (rec_gen["hit"] & rec_so["hit"]).numpy()
    assert both.mean() > 0.9
    np.testing.assert_allclose(rec_gen["t"].numpy()[both],
                               rec_so["t"].numpy()[both], rtol=1e-4,
                               atol=1e-5)


def test_plist_super_mt_tie_rule_lowest_slot():
    """Exact-t ties go to the lowest slot: the same triangle at slots 7
    and 3 of one window (pad records elsewhere) -> slot 3 wins; per-lane
    origins move the hit distance."""
    rows16 = np.zeros((tpl.SUPER * 8, 16), np.float32)    # win_rows 1
    rows16[:, 9] = -1.0
    tri = np.array([[-1.0, -1.0, 2.0], [0.0, 1.0, 2.0], [1.0, -1.0, 2.0]],
                   np.float32)
    rec = np.zeros(16, np.float32)
    rec[0:3], rec[3:6], rec[6:9] = tri[0], tri[1] - tri[0], tri[2] - tri[0]
    rows16[[3, 7]] = rec
    n = tpl.GATE
    orig = torch.zeros((3, n))
    orig[2] = -torch.arange(n, dtype=torch.float32) / n
    dirs = torch.zeros((3, n))
    dirs[2] = 1.0
    key = torch.zeros((1, 1))
    sid = torch.zeros((1, 1), dtype=torch.int32)
    bits = torch.ones((1, 1), dtype=torch.int32)
    best_t, best_slot, stats = tpl.plist_super_mt(
        key, sid, bits, torch.as_tensor(rows16), orig, dirs,
        torch.full((n,), BIG), win_rows=1)
    assert (best_slot == 3).all()
    assert torch.allclose(best_t, 2.0 - orig[2])
    assert stats[0].tolist() == [0, 1, tpl.GATE, 1, 1]
    # a dead lane (direction 0, t0 0) never hits
    dirs[:, :7] = 0.0
    t0 = torch.full((n,), BIG)
    t0[:7] = 0.0
    _, slot, _ = tpl.plist_super_mt(key, sid, bits, torch.as_tensor(rows16),
                                    orig, dirs, t0, win_rows=1)
    assert (slot[:7] == -1).all() and (slot[7:] == 3).all()


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "win_rows",
                                 "orig_t"])
def test_plist_super_mt_rejects_bad_args(bad):
    g, ls, wr = 2, 1, 1
    args = dict(key=torch.zeros((g, ls)),
                sid=torch.zeros((g, ls), dtype=torch.int32),
                bits=torch.zeros((g, ls), dtype=torch.int32),
                rows=torch.zeros((tpl.SUPER * 8 * wr, 16)),
                orig_t=torch.zeros((3, g * tpl.GATE)),
                dir_t=torch.zeros((3, g * tpl.GATE)),
                t0=torch.zeros((g * tpl.GATE,)))
    kw = dict(win_rows=wr)
    if bad == "dtype":
        args["bits"] = args["bits"].float()
    elif bad == "shape":
        args["rows"] = torch.zeros((100, 16))
    elif bad == "contig":
        args["orig_t"] = torch.zeros((g * tpl.GATE, 3)).T
    elif bad == "win_rows":
        kw["win_rows"] = 65
    else:
        args["orig_t"] = torch.zeros((3, tpl.GATE))
    with pytest.raises(ValueError):
        tpl.plist_super_mt(*args.values(), **kw)
