"""Port parity, the windows route's other stream schedules: K2 (one
sorted entry per window, plist_window), K10 (gathered per-gate tables,
plist_gathered) and K11 (four 128-ray sub-gates, plist_subgate), their
prepasses and traverse_plist(supers=False), traverse_plist(gathered=True)
and traverse_plist4.

The JAX package's kernels run in interpret mode on the CPU, five calls in
all (K2 SO and MT, K10, K11 SO and MT; its traverse_plist records are
resolved from them), at 64x64 rays (8 gates) on the ~16k-triangle terrain of
tests/test_torch_plist.py, win_rows 16, with its windows carried across.
The other tests run port code only, on that terrain and a small soup.

Tolerances: each plain kernel on the JAX package's own lists equals the
JAX kernel in hit masks and stats, and in slots except at exact-t ties
(where the JAX slot's record gives the port's t exactly); t to rtol 1e-6
in the MT forms, 1e-4 in the SO forms (see test_plain_kernel_vs_jax).
Records follow tests/test_plist.py's _assert_parity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.ops import plist as jpl
from clpathtracer_tpu.scene.procedural import terrain_mesh as jterrain
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.ops.packet import (BIG, _blockify,
                                               _blockify_strips, mt_pairs,
                                               so_combine, so_pairs)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from clpathtracer_tpu_torch.scene.procedural import (random_tri_soup,
                                                     terrain_mesh)

torch.set_num_threads(2)
CPU = torch.device("cpu")
H = W = 64
WR = 16
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]


def _np(x):
    return np.array(x)      # writable: JAX's host views are read-only


def _flat8(x, n_gates, n):
    """[G, C, 8, 128] chunk packing (entry e at [e // 1024, e % 8,
    (e % 1024) // 8]) -> the first n entries [G, n]."""
    return np.ascontiguousarray(
        _np(x).transpose(0, 1, 3, 2).reshape(n_gates, -1)[:, :n])


def _flat_rows(x, n_gates, n):
    """[G, 8, N/8] (entry e at [e % 8, e // 8]) -> the first n [G, n]."""
    return np.ascontiguousarray(
        _np(x).transpose(0, 2, 1).reshape(n_gates, -1)[:, :n])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's lists and its five kernel calls, and the same
    state in the port."""
    scene = jterrain(16_000, seed=0, extent=10.0).bake_shading()
    tv = _np(scene.tri_corners())
    jw = jpl.attach_resolve(
        jpl.attach_so(jpl.build_morton_windows(tv, win_rows=WR)),
        scene.shade_rows)
    cam = JCamera.create(position=POS, forward=FWD)
    orig, dirs = generate_rays(cam_matrix(cam, H), W, H)
    tw = interop.windows_from_numpy(jw.tris128, jw.win_bnd, jw.so_base,
                                    jw.resolve_rows, jw.slot_of_tri, WR,
                                    device=CPU)
    t_orig, t_dirs = torch.as_tensor(_np(orig)), torch.as_tensor(_np(dirs))
    o = t_orig[0]
    n_gates, n_win = H * W // tpl.GATE, tw.num_windows
    so_rows = so_combine(tw.so_base, o)
    rows128 = jnp.asarray(so_rows.numpy().reshape(-1, 128))

    def rays(block):
        ob, db = (block(x, H, W, tpl.GH, tpl.GW) for x in (t_orig, t_dirs))
        return ob.T.contiguous(), db.T.contiguous()
    orig_t, dir_t = rays(_blockify)
    orig_s, dir_s = rays(lambda x, *a: _blockify_strips(x, *a, tpl.SBH,
                                                        tpl.SBW))
    jo, jd, jos, jds = (jnp.asarray(x.numpy())
                        for x in (orig_t, dir_t, orig_s, dir_s))
    jdir_b, jo0 = jnp.asarray(dir_t.T.numpy()), jnp.asarray(o.numpy())

    # K2: the per-window lists
    row0, ten = jpl.gate_lists(jw.win_bnd, jdir_b, jo0, WR)
    k2 = dict(key=torch.as_tensor(_flat8(ten, n_gates, n_win)),
              wid=torch.as_tensor(
                  (_flat8(row0, n_gates, n_win) / WR).astype(np.int32)))
    k2["so"] = jpl._plist_call(row0, ten, rows128, jo, jd, so=True,
                               win_rows=WR, interpret=True)
    k2["mt"] = jpl._plist_call(row0, ten, jw.tris128, jo, jd, so=False,
                               win_rows=WR, interpret=True)
    # K10: the gathered tables at the JAX defaults (kmax 64, cwin 2)
    kmax, cwin = tpl.gathered_sizes(WR)
    table, ids8, ten8, overflow = jpl.gate_lists_gathered(
        jw.win_bnd, jdir_b, jo0, WR, kmax, rows128)
    assert not bool(overflow)
    k10 = dict(ten=torch.as_tensor(_flat_rows(ten8, n_gates, kmax)),
               ids=torch.as_tensor(
                   _flat_rows(ids8, n_gates, kmax).astype(np.int32)),
               table=torch.as_tensor(_np(table).reshape(n_gates, -1, 16)),
               kmax=kmax, cwin=cwin)
    k10["so"] = jpl._plist_gath_call(ids8, ten8, table, jo, jd,
                                     win_rows=WR, kmax=kmax, cwin=cwin,
                                     tup_every=1, interpret=True)
    # K11: the sub-gate lists
    jkey4, jpay4 = jpl.gate_lists4(jw.win_bnd, jnp.asarray(dir_s.T.numpy()),
                                   jo0, WR)
    k11 = dict(key=torch.as_tensor(_flat_rows(jkey4, n_gates, n_win)),
               pay=torch.as_tensor(
                   _flat_rows(jpay4, n_gates, n_win).astype(np.int32)))
    k11["so"] = jpl._plist4_call(jkey4, jpay4, rows128, jos, jds, so=True,
                                 win_rows=WR, interpret=True)
    k11["mt"] = jpl._plist4_call(jkey4, jpay4, jw.tris128, jos, jds,
                                 so=False, win_rows=WR, interpret=True)

    def jrec(out, unblock):
        slot = unblock(_np(out[1][0]).astype(np.int32), H, W, tpl.GH,
                       tpl.GW)
        rec = jpl._resolve_winners(jw, jnp.asarray(slot), orig, dirs,
                                   out[2][::8, :5])
        return {k: _np(v) for k, v in rec.items()}
    # the records of traverse_plist(supers=False), of traverse_plist(
    # gathered=True) (its lax.cond takes K10 here: no overflow) and of
    # traverse_plist4, from their kernel calls above
    recs = {"window": jrec(k2["so"], jpk._unblockify),
            "gathered": jrec(k10["so"], jpk._unblockify),
            "subgate": jrec(k11["so"], jpk._unblockify_strips)}
    return dict(tv=tv, tw=tw, orig=t_orig, dirs=t_dirs, so_rows=so_rows,
                orig_t=orig_t, dir_t=dir_t, orig_s=orig_s, dir_s=dir_s,
                k2=k2, k10=k10, k11=k11, recs=recs)


@pytest.fixture(scope="module")
def soup():
    scene = random_tri_soup(20_000, seed=11, extent=10.0, tri_size=0.05,
                            device=CPU).bake_shading()
    cam = tcam.Camera.create([0.0, 0.0, -25.0], [0.0, 0.0, 1.0], device=CPU)
    orig, dirs = tcam.generate_rays(tcam.cam_matrix(cam, H), W, H)
    return _port_windows(scene), orig, dirs


def _port_windows(scene):
    mwin = tpl.build_morton_windows(scene.tri_corners(), WR, device=CPU)
    return tpl.attach_resolve(tpl.attach_so(mwin), scene.shade_rows)


def _assert_ties(rows, orig_t, dir_t, t, slot, other_slot):
    """Where the slots differ, the other slot's record is hit at exactly t
    by that ray: an exact-t tie."""
    differ = torch.nonzero(slot != other_slot).squeeze(1)
    assert differ.numel() <= 0.05 * max(int((slot >= 0).sum()), 1)
    if not differ.numel():
        return
    r = rows[other_slot[differ].long()][:, :10]
    d = [dir_t[ax, differ] for ax in range(3)]
    if orig_t is None:
        ok, t2 = so_pairs(r, *d)
    else:
        ok, t2 = mt_pairs(r, *(orig_t[ax, differ] for ax in range(3)), *d)
    assert bool(ok.all()) and torch.equal(t2, t[differ])


def _plain_on_jax_lists(ref, case):
    """(port plain outputs, JAX kernel outputs, the test's rows, origins,
    directions) of one kernel form on the JAX package's lists."""
    tw = ref["tw"]
    t0 = torch.full((H * W,), BIG)
    if case.startswith("k2"):
        k2, so = ref["k2"], case == "k2_so"
        rows = ref["so_rows"] if so else tw.tris
        orig_t = None if so else ref["orig_t"]
        out = tpl.plist_window_reference(k2["key"], k2["wid"], rows,
                                         ref["dir_t"], t0, win_rows=WR,
                                         orig_t=orig_t)
        return out, k2["so" if so else "mt"], rows, orig_t, ref["dir_t"]
    if case == "k10":
        k10 = ref["k10"]
        out = tpl.plist_gathered_reference(
            k10["ten"], k10["ids"], k10["table"], ref["dir_t"], t0,
            win_rows=WR, cwin=k10["cwin"])
        return out, k10["so"], ref["so_rows"], None, ref["dir_t"]
    k11, so = ref["k11"], case == "k11_so"
    rows = ref["so_rows"] if so else tw.tris
    orig_t = None if so else ref["orig_s"]
    out = tpl.plist_subgate_reference(k11["key"], k11["pay"], rows,
                                      ref["dir_s"], win_rows=WR,
                                      orig_t=orig_t)
    return out, k11["so" if so else "mt"], rows, orig_t, ref["dir_s"]


@pytest.mark.parametrize("case", ["k2_so", "k2_mt", "k10", "k11_so",
                                  "k11_mt"])
def test_plain_kernel_vs_jax(ref, case):
    """Each plain kernel on the JAX package's own lists against the JAX
    kernel: hits and stats equal (the port takes the TPU kernels' t_upper
    timing: K2 and K11 decide on the next window before testing the
    current one, K10 after each chunk), t to rtol 1e-6, slots equal but at
    exact-t ties."""
    (best_t, best_slot, stats), jout, rows, orig_t, dir_t = \
        _plain_on_jax_lists(ref, case)
    j_t, j_slot = (torch.as_tensor(_np(x[0])) for x in jout[:2])
    j_slot = j_slot.to(torch.int32)
    hit = best_slot >= 0
    assert torch.equal(hit, j_slot >= 0) and hit.float().mean() > 0.9
    # the SO quotient d0 / dsum (dsum cancels) rounds otherwise under XLA
    # on the CPU: up to 1.8e-5 relative on this fixture, with every slot
    # equal; the SO edge budget's t tolerance of
    # tests/test_plist.py::test_plist_so_affine_parity
    np.testing.assert_allclose(best_t[hit].numpy(), j_t[hit].numpy(),
                               rtol=1e-6 if orig_t is not None else 1e-4)
    np.testing.assert_array_equal(stats.numpy(),
                                  _np(jout[2])[::8, :5].astype(np.int32))
    _assert_ties(rows, orig_t, dir_t, best_t, best_slot, j_slot)
    # the wrappers take the plain version for CPU tensors
    if case == "k2_mt":
        again = tpl.plist_window(ref["k2"]["key"], ref["k2"]["wid"], rows,
                                 dir_t, torch.full((H * W,), BIG),
                                 win_rows=WR, orig_t=orig_t)
        assert all(torch.equal(a, b)
                   for a, b in zip(again, (best_t, best_slot, stats)))


def _assert_parity(rec, ref):
    """tests/test_plist.py::_assert_parity."""
    h_p, h_r = rec["hit"].numpy(), ref["hit"]
    np.testing.assert_array_equal(h_p, h_r)
    both = h_p & h_r
    assert both.mean() > 0.9
    np.testing.assert_allclose(rec["t"].numpy()[both], ref["t"][both],
                               rtol=1e-5, atol=1e-6)
    tri_eq = (rec["tri"].numpy()[both] == ref["tri"][both]).mean()
    assert tri_eq > 0.95, tri_eq


def _traverse(schedule, mwin, orig, dirs, **kw):
    if schedule == "subgate":
        return tpl.traverse_plist4(mwin, orig, dirs, (H, W))
    return tpl.traverse_plist(mwin, orig, dirs, (H, W),
                              supers=schedule != "window",
                              gathered=schedule == "gathered", **kw)


SCHEDULES = ["window", "gathered", "subgate"]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_traverse_vs_jax(ref, schedule):
    rec = _traverse(schedule, ref["tw"], ref["orig"], ref["dirs"])
    jrec = ref["recs"][schedule]
    _assert_parity(rec, jrec)
    np.testing.assert_array_equal(rec["tile_stats"].numpy(),
                                  jrec["tile_stats"].astype(np.int32))
    for k in ("snormal", "salbedo", "semission"):
        np.testing.assert_allclose(rec[k].numpy(), jrec[k], rtol=1e-5,
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


@pytest.fixture(scope="module")
def brute(ref):
    """The port's own windows and SO tables for the terrain, and the
    brute force's hits on the fixture's rays."""
    tw = tpl.attach_so(tpl.build_morton_windows(ref["tv"], WR, device=CPU))
    return (tw.replace(resolve_rows=ref["tw"].resolve_rows),
            *_bruteforce(ref["tv"], ref["orig"], ref["dirs"]))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_traverse_vs_bruteforce(ref, brute, schedule):
    """The port's own windows and SO tables against a brute-force MT over
    all triangles, with the SO edge-flip budget of
    tests/test_plist.py::test_plist_so_affine_parity."""
    tw, hit, t = brute
    rec = _traverse(schedule, tw, ref["orig"], ref["dirs"])
    assert (rec["hit"] != hit).float().mean() < 2e-3
    both = (rec["hit"] & hit).numpy()
    np.testing.assert_allclose(rec["t"].numpy()[both], t.numpy()[both],
                               rtol=1e-4, atol=1e-5)


def _plain_schedules(mwin, orig, dirs):
    """(best_t, best_slot) in pixel order of the plain K1, K2, K10 and K11
    (SO forms) on the port's own prepasses."""
    o = orig[0]
    rows = so_combine(mwin.so_base, o)
    dir_b = _blockify(dirs, H, W, tpl.GH, tpl.GW)
    dir_t = dir_b.T.contiguous()
    t0 = torch.full((H * W,), BIG)
    # a kmax that holds every gate
    need = int(torch.isfinite(tpl.gate_lists(mwin.win_bnd, dir_b, o)[0])
               .sum(dim=1).max())
    kmax, cwin = tpl.gathered_sizes(WR, kmax=need)
    table, ids, ten, overflow = tpl.gate_lists_gathered(
        mwin.win_bnd, dir_b, o, rows, WR, kmax)
    assert not bool(overflow)
    dir_s = _blockify_strips(dirs, H, W, tpl.GH, tpl.GW, tpl.SBH, tpl.SBW)
    outs = {
        "super": tpl.plist_super_reference(
            *tpl.gate_lists_super(mwin.win_bnd, dir_b, o), rows, dir_t, t0,
            win_rows=WR),
        "window": tpl.plist_window_reference(
            *tpl.gate_lists(mwin.win_bnd, dir_b, o), rows, dir_t, t0,
            win_rows=WR),
        "gathered": tpl.plist_gathered_reference(
            ten, ids, table, dir_t, t0, win_rows=WR, cwin=cwin),
        "subgate": tpl.plist_subgate_reference(
            *tpl.gate_lists4(mwin.win_bnd, dir_s, o), rows,
            dir_s.T.contiguous(), win_rows=WR)}
    unblock = {"subgate": lambda x: tpl._unblockify_strips(
        x, H, W, tpl.GH, tpl.GW, tpl.SBH, tpl.SBW)}
    return rows, {k: tuple(unblock.get(k, lambda x: tpl._unblockify(
        x, H, W, tpl.GH, tpl.GW))(x) for x in v[:2]) for k, v in outs.items()}


@pytest.mark.parametrize("kind", ["terrain", "soup"])
def test_schedules_match_super_exactly(ref, soup, kind):
    """tests/test_plist.py::test_plist_super_exact_match_plain on port
    code only: the same intersector under four stream schedules. Plain K2
    and K10 equal plain K1 exactly in hit, t and slot; plain K11 in hit and
    t, its slots differing only at exact-t ties (its sub-gates break on
    their own t_upper, so a tie can be cut off another way)."""
    if kind == "terrain":
        mwin, orig, dirs = ref["tw"], ref["orig"], ref["dirs"]
    else:
        mwin, orig, dirs = soup
    rows, outs = _plain_schedules(mwin, orig, dirs)
    st, ss = outs["super"]
    assert bool((ss >= 0).any())
    for k in ("window", "gathered"):
        assert torch.equal(outs[k][0], st) and torch.equal(outs[k][1], ss), k
    t4, s4 = outs["subgate"]
    assert torch.equal(t4, st) and torch.equal(s4 >= 0, ss >= 0)
    _assert_ties(rows, None, dirs.T.contiguous(), st, ss, s4)


def _partial(mwin, n_win):
    """The first n_win windows of mwin (dropping only pad windows)."""
    recs = n_win * mwin.win_rows * 8
    assert not bool((mwin.tri_id[recs:] >= 0).any())
    return mwin.replace(tris=mwin.tris[:recs], tri_id=mwin.tri_id[:recs],
                        win_bnd=mwin.win_bnd[:n_win],
                        so_base=mwin.so_base[:, :recs],
                        resolve_rows=mwin.resolve_rows[:recs])


def _spy(monkeypatch):
    """Count the calls of the three gate kernels' wrappers (the launch
    counters count CUDA launches only)."""
    calls = {}
    for name in ("plist_super", "plist_window", "plist_gathered"):
        fn = getattr(tpl, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tpl, name, spy)
    return calls


@pytest.mark.parametrize("whole", [True, False])
def test_gathered_overflow_falls_back(ref, monkeypatch, whole):
    """kmax 8 holds no gate: the frame runs K1 on whole supers, K2 on
    windows that are not whole supers (125 of the terrain's 128 windows:
    its 3 pad windows dropped), never K10, with K1's result."""
    mwin = ref["tw"] if whole else _partial(ref["tw"], 125)
    base = tpl.traverse_plist(ref["tw"], ref["orig"], ref["dirs"], (H, W))
    calls = _spy(monkeypatch)
    rec = tpl.traverse_plist(mwin, ref["orig"], ref["dirs"], (H, W),
                             gathered=True, kmax=8)
    assert calls == ({"plist_super": 1} if whole else {"plist_window": 1})
    for k in ("hit", "t", "tri", "u", "v"):
        assert torch.equal(rec[k], base[k]), k
    calls.clear()
    tpl.traverse_plist(mwin, ref["orig"], ref["dirs"], (H, W), gathered=True)
    assert calls == {"plist_gathered": 1}


def test_supers_need_whole_supers(ref, monkeypatch):
    """supers=True on windows that are not whole supers runs K2, as the
    JAX package does (plist.py:592), with K1's result."""
    base = tpl.traverse_plist(ref["tw"], ref["orig"], ref["dirs"], (H, W))
    calls = _spy(monkeypatch)
    rec = tpl.traverse_plist(_partial(ref["tw"], 125), ref["orig"],
                             ref["dirs"], (H, W))
    assert calls == {"plist_window": 1}
    assert torch.equal(rec["tri"], base["tri"])
    assert torch.equal(rec["t"], base["t"])


def test_gathered_needs_so_tables(ref):
    with pytest.raises(ValueError, match="shared-origin"):
        tpl.traverse_plist(ref["tw"].replace(so_base=None), ref["orig"],
                           ref["dirs"], (H, W), gathered=True)


def test_gathered_pad_ids_sanitized(ref):
    """Every pad entry (key +inf) names window 0, the window whose rows the
    table holds for it; every entry's rows are its window's rows; the
    needed entries equal the JAX package's."""
    tw, o = ref["tw"], ref["orig"][0]
    dir_b = _blockify(ref["dirs"], H, W, tpl.GH, tpl.GW)
    k10 = ref["k10"]
    table, ids, ten, overflow = tpl.gate_lists_gathered(
        tw.win_bnd, dir_b, o, ref["so_rows"], WR, k10["kmax"])
    assert not bool(overflow) and ids.dtype == torch.int32
    pad = ~torch.isfinite(ten)
    assert bool(pad.any()) and bool((ids[pad] == 0).all())
    wins = ref["so_rows"].reshape(-1, WR * 8, 16)
    assert torch.equal(table.reshape(*ids.shape, WR * 8, 16),
                       wins[ids.long()])
    assert torch.equal(ten, k10["ten"])
    assert torch.equal(ids[~pad], k10["ids"][~pad])
    assert not bool((k10["ids"][pad] == 0).all())   # the JAX package's ids


def test_subgate_so_vs_mt(ref):
    """tests/test_plist.py's sub-gate SO/MT contract: hit mismatch
    < 2e-3."""
    a = tpl.traverse_plist4(ref["tw"], ref["orig"], ref["dirs"], (H, W))
    b = tpl.traverse_plist4(ref["tw"].replace(so_base=None), ref["orig"],
                            ref["dirs"], (H, W))
    assert (a["hit"] != b["hit"]).float().mean() < 2e-3
    both = (a["hit"] & b["hit"]).numpy()
    np.testing.assert_allclose(a["t"].numpy()[both], b["t"].numpy()[both],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sky_camera_tests_nothing(ref, schedule):
    cam = tcam.Camera.create(POS, [0.0, 1.0, 0.01], device=CPU)
    orig, dirs = tcam.generate_rays(tcam.cam_matrix(cam, H), W, H)
    rec = _traverse(schedule, ref["tw"], orig, dirs)
    assert not rec["hit"].any()
    assert (rec["tile_stats"][:, [1, 3, 4]] == 0).all()


@pytest.fixture(scope="module")
def port_scene():
    scene = terrain_mesh(16_000, seed=0, extent=10.0, device=CPU) \
        .bake_shading()
    return scene, _port_windows(scene)


@pytest.mark.parametrize("schedule", ["window", "gathered"])
def test_render_schedule_equals_super(port_scene, schedule):
    scene, mwin = port_scene
    cam = tcam.Camera.create(POS, FWD, device=CPU)
    base = render_image(scene, cam, RenderOptions(width=H, height=W), mwin)
    img = render_image(scene, cam, RenderOptions(
        width=H, height=W, plist_schedule=schedule), mwin)
    assert torch.equal(img, base)


def _bad_call(bad, port_scene):
    g, wr = 2, 1
    n = g * tpl.GATE
    lists = dict(key=torch.zeros((g, 3)),
                 wid=torch.zeros((g, 3), dtype=torch.int32))
    rows = torch.zeros((5 * 8 * wr, 16))      # 5 windows: not whole supers
    dir_t, t0 = torch.zeros((3, n)), torch.zeros((n,))
    if bad == "k2_rows":
        return lambda: tpl.plist_window(*lists.values(), rows[:-1], dir_t,
                                        t0, win_rows=wr)
    if bad == "k2_dtype":
        return lambda: tpl.plist_window(lists["key"], lists["key"], rows,
                                        dir_t, t0, win_rows=wr)
    if bad == "k2_orig":
        return lambda: tpl.plist_window(*lists.values(), rows, dir_t, t0,
                                        win_rows=wr, orig_t=dir_t[:, 1:])
    kmax = 8
    ten, ids = torch.zeros((g, kmax)), torch.zeros((g, kmax),
                                                   dtype=torch.int32)
    table = torch.zeros((g, kmax * 8 * wr, 16))
    if bad == "k10_cwin":
        return lambda: tpl.plist_gathered(ten, ids, table, dir_t, t0,
                                          win_rows=wr, cwin=3)
    if bad == "k10_table":
        return lambda: tpl.plist_gathered(ten, ids, table[:, 1:], dir_t, t0,
                                          win_rows=wr, cwin=2)
    if bad == "k10_kmax":
        return lambda: tpl.gathered_sizes(16, kmax=-8)
    if bad == "k11_dtype":
        return lambda: tpl.plist_subgate(lists["key"], lists["key"], rows,
                                         dir_t, win_rows=wr)
    if bad == "k11_win_rows":
        return lambda: tpl.plist_subgate(lists["key"],
                                         lists["wid"], rows, dir_t,
                                         win_rows=0)
    scene, mwin = port_scene
    cam = tcam.Camera.create(POS, FWD, device=CPU)
    return lambda: render_image(scene, cam, RenderOptions(
        width=32, height=32, plist_schedule="gather"), mwin)


@pytest.mark.parametrize("bad", ["k2_rows", "k2_dtype", "k2_orig",
                                 "k10_cwin", "k10_table", "k10_kmax",
                                 "k11_dtype", "k11_win_rows", "schedule"])
def test_rejects_bad_args(port_scene, bad):
    with pytest.raises(ValueError):
        _bad_call(bad, port_scene)()
