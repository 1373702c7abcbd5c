"""Port parity, the v1 packet walks K6a, K6b and K9: the port's
traverse_packet(engine="legacy" | "wide") and its kernels' plain torch
versions against the JAX package's traverse_packet on the "legacy" engine
(_kernel at the default VMEM_BUDGET, _kernel_tri_stream under a budget of
300,000 bytes, as tests/test_packet.py sets it) and with CLPT_WIDE=1
(_kernel_wide), its Pallas kernels in interpret mode, on the soup of
TestStreamEngine (3000 triangles, depth 14, leaf 16: 895 nodes, 95
supernodes) at 32x32 pixel rays, tiles of 256 and 1024; the port's
accel/wide.py against the JAX package's; packet_mode against JAX's.

Contract. Kernels: best slot and tile_stats lanes 0-1 equal, lanes 2-4
zero on both sides; best t within rtol 1e-6 (XLA contracts the JAX
kernels' products into FMAs on the CPU, so their t can differ from the
port's in the last bit; the port's plain versions round every operation
as its CUDA kernels do). Records: tests/test_plist.py's (hit masks equal,
t allclose rtol 1e-5 atol 1e-6, triangle ids equal on more than 95% of
hits), and against a brute-force Moller-Trumbore over all triangles hit
masks equal and t allclose (rtol 1e-5, atol 1e-6). The JAX wide kernel
takes about 15 s a call in interpret mode, so it runs twice."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import build_kd_tree as j_build
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix as j_cam_matrix
from clpathtracer_tpu.core.camera import generate_rays as j_generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.scene.procedural import random_tri_soup
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.accel import sah, wide
from clpathtracer_tpu_torch.ops import packet as tpk
from test_torch_packet import _assert_hits
from test_torch_plist import _bruteforce

torch.set_num_threads(2)
CPU = torch.device("cpu")
SIZE = 32
SMALL_BUDGET = 300_000   # tests/test_packet.py's: the records leave VMEM
# case -> (packet mode, tile); k6a_256 runs with a dead-lane active mask,
# which both packages ignore
CASES = {"k6a_256": ("vmem", 256), "k6a_1024": ("vmem", 1024),
         "k6b_256": ("tri_stream", 256), "k6b_1024": ("tri_stream", 1024),
         "k9_256": ("wide", 256), "k9_1024": ("wide", 1024)}
# the JAX kernel wrapper each mode calls
JAX_CALLS = {"vmem": "_packet_call", "tri_stream": "_packet_call_tri_stream",
             "wide": "_packet_call_wide"}


def _tri_verts(n, seed):
    scene = random_tri_soup(n, seed=seed, extent=2.0, tri_size=0.05)
    return np.stack([np.asarray(v) for v in scene.tri_verts()], 1)


@pytest.fixture(scope="module")
def fx():
    tv = _tri_verts(3000, 1)
    jt = j_build(tv, max_depth=14, leaf_size=16, tri_block=4)
    pt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, None,
                                 jt.max_leaf_tris, jt.wide_table, device=CPU)
    cam = JCamera.create(position=[0.0, 0.0, -4.0], forward=[0.0, 0.0, 1.0])
    orig, dirs = j_generate_rays(j_cam_matrix(cam, SIZE), SIZE, SIZE)
    dead = np.random.default_rng(0).random(SIZE * SIZE) < 0.5
    return dict(tv=tv, jt=jt, pt=pt, orig=orig, dirs=dirs, dead=dead,
                o=torch.as_tensor(np.array(orig)),
                d=torch.as_tensor(np.array(dirs)))


def _select(mp, mode):
    """Make both packages' packet_mode pick `mode`: the small budget for
    tri_stream, CLPT_WIDE=1 for the JAX package's wide engine."""
    if mode == "tri_stream":
        mp.setattr(jpk, "VMEM_BUDGET", SMALL_BUDGET)
        mp.setattr(tpk, "VMEM_BUDGET", SMALL_BUDGET)
    if mode == "wide":
        mp.setenv("CLPT_WIDE", "1")
    return "wide" if mode == "wide" else "legacy"


@pytest.fixture(scope="module")
def jax_runs(fx):
    """One JAX traverse_packet per case (interpret mode), with the kernel
    wrapper's inputs and raw outputs captured on the way."""
    out = {}
    for case, (mode, tile) in CASES.items():
        seen = {}
        real = getattr(jpk, JAX_CALLS[mode])

        def spy(*args, real=real, seen=seen, **kw):
            res = real(*args, **kw)
            seen["args"] = [np.asarray(a) for a in args]
            seen["out"] = [np.asarray(r) for r in res]
            return res
        with pytest.MonkeyPatch.context() as mp:
            engine = _select(mp, mode)
            mp.setattr(jpk, JAX_CALLS[mode], spy)
            extra = ({"active": jnp.asarray(~fx["dead"])}
                     if case == "k6a_256" else {})
            rec = jpk.traverse_packet(
                fx["jt"], fx["jt"].quads, fx["orig"], fx["dirs"],
                image_shape=(SIZE, SIZE), tile=tile, engine=engine, **extra)
        out[case] = dict(seen, rec={k: np.asarray(v) for k, v in rec.items()})
    return out


@pytest.mark.parametrize("case", ["native_build", "carried_tree",
                                  "small_leaves"])
def test_build_wide_table_matches_jax(fx, case):
    """Array-exact against the JAX package's table: on the port's own
    native build, on the tree carried across, and no table below leaf
    size 8 on either side."""
    if case == "small_leaves":
        tv = _tri_verts(500, 2)
        assert j_build(tv, leaf_size=4, tri_block=4).wide_table is None
        assert sah.build_kd_tree(tv, leaf_size=4,
                                 device=CPU).wide_table is None
        return
    ref = np.asarray(fx["jt"].wide_table)
    if case == "native_build":
        pt = sah.build_kd_tree(fx["tv"], max_depth=14, leaf_size=16,
                               device=CPU)
        np.testing.assert_array_equal(pt.node_table.numpy(),
                                      np.asarray(fx["jt"].node_table))
        got = pt.wide_table.numpy()
    else:
        got = wide.build_wide_table(fx["pt"])
        np.testing.assert_array_equal(fx["pt"].wide_table.numpy(), ref)
    assert got.dtype == np.float32 and ref.shape == (95, 128)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["legacy", "legacy_small_budget",
                                  "legacy_no_fit", "wide", "auto"])
def test_packet_mode_matches_jax(fx, monkeypatch, case):
    jt, pt = fx["jt"], fx["pt"]
    n = SIZE * SIZE
    if case == "legacy_small_budget":
        _select(monkeypatch, "tri_stream")
    elif case == "legacy_no_fit":     # not even the node table fits
        monkeypatch.setattr(jpk, "VMEM_BUDGET", 10_000)
        monkeypatch.setattr(tpk, "VMEM_BUDGET", 10_000)
    if case == "wide":
        _select(monkeypatch, "wide")
        assert jpk.packet_mode(jt, n, 256, "auto") == "wide"
        assert tpk.packet_mode(pt, n, 256, "wide") == "wide"
        assert tpk.packet_mode(pt.replace(wide_table=None), n, 256,
                               "wide") is None
        return
    engine = "auto" if case == "auto" else "legacy"
    want = {"legacy": "vmem", "legacy_small_budget": "tri_stream",
            "legacy_no_fit": None, "auto": "stream"}[case]
    assert jpk.packet_mode(jt, n, 256, engine) == want
    assert tpk.packet_mode(pt, n, 256, engine) == want


def _port_kernel(fx, mode, tile):
    """The port's kernel call of traverse_packet's branch (plain version
    on the CPU): (args, outputs)."""
    args, layout = tpk.v1_kernel_args(fx["pt"], fx["o"], fx["d"],
                                      (SIZE, SIZE), tile, mode)
    assert layout == ("blocks", SIZE, SIZE, *tpk.tile_shape(tile))
    if mode == "wide":
        return args, tpk.packet_wide(*args, tile=tile)
    return args, tpk.packet_legacy(*args, tile=tile,
                                   resident=mode == "vmem")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_kernel_matches_jax(fx, jax_runs, case):
    """The plain K6a, K6b and K9 on the JAX kernel's own inputs: equal
    slots and stats lanes 0-1, t to the last bit (rtol 1e-6)."""
    mode, tile = CASES[case]
    run = jax_runs[case]
    args, (bt, bs, st) = _port_kernel(fx, mode, tile)
    # the same tile-major rays and the same tables the JAX kernel read
    np.testing.assert_array_equal(args[2].numpy(), run["args"][2])
    np.testing.assert_array_equal(args[3].numpy(), run["args"][3])
    recs = run["args"][1].reshape(-1, 16)
    np.testing.assert_array_equal(args[1].numpy(), recs)
    if mode == "wide":
        np.testing.assert_array_equal(args[0].numpy(), run["args"][0])
    else:
        np.testing.assert_array_equal(
            args[0].numpy(),
            run["args"][0].reshape(-1, 16)[:args[0].shape[0]])
    j_t, j_s, j_st = run["out"]
    np.testing.assert_array_equal(bs.numpy(), j_s[0].astype(np.int32))
    np.testing.assert_allclose(bt.numpy(), j_t[0], rtol=1e-6, atol=0)
    j_st = j_st[::8, :5].astype(np.int32)
    np.testing.assert_array_equal(st.numpy()[:, :2], j_st[:, :2])
    assert (st.numpy()[:, 2:] == 0).all() and (j_st[:, 2:] == 0).all()
    assert st.shape == (SIZE * SIZE // tile, 5) and (bs >= 0).sum() > 400


@pytest.mark.parametrize("case", list(CASES))
def test_traverse_packet_matches_jax_and_bruteforce(fx, jax_runs,
                                                    monkeypatch, case):
    """traverse_packet(engine="legacy" | "wide") against JAX's and against
    the brute force; k6a_256 with a dead-lane mask that both ignore."""
    mode, tile = CASES[case]
    engine = _select(monkeypatch, mode)
    kw = ({"active": torch.as_tensor(~fx["dead"])} if case == "k6a_256"
          else {})
    rec = tpk.traverse_packet(fx["pt"], fx["o"], fx["d"], (SIZE, SIZE),
                              tile, engine=engine, **kw)
    ref = jax_runs[case]["rec"]
    _assert_hits(rec, ref)
    np.testing.assert_array_equal(rec["tile_stats"].numpy(),
                                  ref["tile_stats"].astype(np.int32))
    hit, t = _bruteforce(fx["tv"], fx["o"], fx["d"])
    assert torch.equal(rec["hit"], hit)
    np.testing.assert_allclose(rec["t"][hit].numpy(), t[hit].numpy(),
                               rtol=1e-5, atol=1e-6)
    if kw:   # ignored: the dead lanes report their hits too
        assert rec["hit"][torch.as_tensor(fx["dead"])].any()
        np.testing.assert_array_equal(
            rec["tri"].numpy(),
            tpk.traverse_packet(fx["pt"], fx["o"], fx["d"], (SIZE, SIZE),
                                tile, engine=engine)["tri"].numpy())


def _chain(depth):
    """A binary table whose walk grows the stack one entry a level: split
    i (axis z, which the rays travel along +z) has the live near child
    i + 1 and a far child behind the rays, which is pushed, popped last
    and culled; a leaf at the end."""
    t = np.zeros((depth + 2, 16), np.float32)
    t[:, 0:3], t[:, 3:6] = -10.0, 10.0
    t[:depth, 7] = 2.0
    t[:depth, 8] = np.arange(1, depth + 1)
    t[:depth, 9] = depth + 1
    t[depth, 7] = 4.0
    t[depth + 1, 2], t[depth + 1, 5] = -100.0, -90.0     # behind the rays
    return torch.as_tensor(t)


def _wide_chain(depth):
    """A supernode table whose walk grows the stack 7 entries a level:
    row i has 7 live internal children that are an empty row, pushed
    first and popped last, and the next row on top; an empty row ends
    the chain."""
    w = np.zeros((depth + 2, 8, 16), np.float32)
    w[:depth, :, 0:3], w[:depth, :, 3:6] = -10.0, 10.0
    w[:depth, :, 6] = 1.0
    w[:depth, :7, 7] = depth + 1
    w[:depth, 7, 7] = np.arange(1, depth + 1)
    return torch.as_tensor(w.reshape(depth + 2, 128))


@pytest.mark.parametrize("engine", ["legacy", "wide"])
def test_stack_overflow_raises(fx, engine):
    """A walk that would pass the 128-entry stack raises; below the limit
    the same walk runs."""
    args, _ = tpk.v1_kernel_args(fx["pt"], fx["o"], fx["d"], tile=256,
                                 mode="tri_stream")
    _, recs, o, d = args
    if engine == "legacy":
        ok, bad, pops = _chain(100), _chain(200), 201
        call = functools.partial(tpk.packet_legacy, resident=False)
    else:
        ok, bad, pops = _wide_chain(10), _wide_chain(30), 81
        call = tpk.packet_wide
    st = call(ok, recs, o, d, tile=256)[2]
    assert (st[:, 0] == pops).all() and (st[:, 1] == 0).all()
    with pytest.raises(RuntimeError, match="overflowed"):
        call(bad, recs, o, d, tile=256)


@pytest.mark.parametrize("bad", ["dtype", "tile", "recs", "table"])
def test_v1_wrappers_reject_bad_arguments(fx, bad):
    args, _ = tpk.v1_kernel_args(fx["pt"], fx["o"], fx["d"], tile=256,
                                 mode="tri_stream")
    args = list(args)
    tile = 256
    if bad == "dtype":
        args[3] = args[3].double()
    elif bad == "tile":
        tile = 768
    elif bad == "recs":
        args[1] = args[1][:100]
    else:
        args[0] = fx["pt"].wide_table
    with pytest.raises(ValueError, match="packet_legacy"):
        tpk.packet_legacy(*args, tile=tile, resident=False)


# the tiles the v1 wrappers take: (engine, tile, taken); all three kernels
# share K3's launch rule, and which tiles run on a cluster of 8 blocks
# (multiples of 256) is the kernel's choice, read on the card
# (packet_v1_shape, chip_smoke.py phase 2)
V1_TILES = ([(tpk._V1_STREAM, t, True)
             for t in (32, 224, 256, 480, 512, 1536, 4096)]
            + [(tpk._V1_WIDE, 2048, True)]
            + [(tpk._V1_RESIDENT, t, True)
               for t in (32, 512, 1024, 2048, 4096, 1536, 3072, 3584)]
            + [(tpk._V1_STREAM, t, False)
               for t in (0, 48, 544, 768, 4352, 8192)]
            + [(tpk._V1_WIDE, 768, False)])


@pytest.mark.parametrize("engine,tile,taken", V1_TILES)
def test_v1_tile_rule(engine, tile, taken):
    """Whole warps up to 4096 and multiples of 512 above 512, for every v1
    kernel: K6a launches each of them too, as K6b and K9 do."""
    assert tpk._walk_takes(tile) is taken
    if not taken:
        return
    table = torch.zeros((1, 128 if engine == tpk._V1_WIDE else 16))
    recs = torch.zeros((128, 16))
    rays = torch.zeros((3, tile))
    tpk._check_v1_args(table, table.shape[1], recs, rays, rays, tile,
                       engine, "v1")


def test_v1_wrappers_refuse_what_no_launch_takes(fx):
    """The wrappers refuse such a tile on the host as on the card: K6a at
    tile 768 (a multiple of 256 above 512 but not of 512), which no kd walk
    takes."""
    args, _ = tpk.v1_kernel_args(fx["pt"], fx["o"], fx["d"], tile=256,
                                 mode="vmem")
    table, recs, o, d = args
    o, d = (torch.cat([x, x], dim=1)[:, :1536].contiguous() for x in (o, d))
    with pytest.raises(ValueError, match="packet_legacy: tile 768"):
        tpk.packet_legacy(table, recs, o, d, tile=768, resident=True)


def _tie_records(rng, n):
    """n records, each a copy of one of two triangles that rays along +z
    from z = 0 inside both hit at exactly t 1 and 2, or a miss (tri_id
    -1), drawn at random (0.5, 0.3, 0.2): exact-t ties at every
    position."""
    recs = np.zeros((n, 16), np.float32)
    kind = rng.choice(3, size=n, p=[0.5, 0.3, 0.2])
    recs[:, 0:3] = [-10.0, -10.0, 0.0]
    recs[:, 2] = np.where(kind == 1, 2.0, 1.0)
    recs[:, 3:6] = [0.0, 20.0, 0.0]   # e1: det > 0 for rays along +z
    recs[:, 6:9] = [20.0, 0.0, 0.0]
    recs[:, 9] = np.where(kind == 2, -1.0, np.arange(n))
    return recs


def _tie_rays(rng):
    """Up to 32 rays along +z from z = 0 inside both triangles of
    _tie_records, as the 6 rows mt_pairs takes."""
    xy = rng.uniform(-9.0, -1.0, size=(64, 2)).astype(np.float32)
    xy = xy[xy.sum(axis=1) < -10.5][:32]
    zero = np.zeros(len(xy), np.float32)
    return [torch.as_tensor(v) for v in (
        xy[:, 0], xy[:, 1], zero, zero, zero, np.ones(len(xy), np.float32))]


def _tie_t(recs, rays):
    """Every record's t on every lane ([records, lanes], BIG on a miss),
    checked to be exactly 1 or 2 where the record is a triangle."""
    ok, t = tpk.mt_pairs(torch.as_tensor(recs)[:, None, :10],
                         *(r[None, :] for r in rays))
    t = torch.where(ok, t, tpk.BIG).numpy()
    want = np.where(recs[:, 9] >= 0.0, recs[:, 2], np.float32(tpk.BIG))
    assert (t == want[:, None]).all()
    return t


def _split_winner(t, k_s, h0):
    """kd_walk.cuh::dense_split's window winner for one lane, replayed:
    share h tests records h, h + k_s, ... in order and keeps a record
    where its t is less, or equal within the kept record's row of 8; the
    shares then merge by precedes over the xor butterfly of warp shuffles,
    seen from share h0 (every share must end with the same winner)."""
    def precedes(a, b):
        (t2, r2), (t1, r1) = a, b
        return t2 < t1 or (t2 == t1 and (r2 >> 3 < r1 >> 3 or (
            r2 >> 3 == r1 >> 3 and r2 > r1)))
    won = []
    for h in range(k_s):
        ct, cr = tpk.BIG, -1
        for r in range(h, len(t), k_s):
            if t[r] < tpk.BIG and (t[r] < ct or (t[r] == ct
                                                 and r >> 3 == cr >> 3)):
                ct, cr = t[r], r
        won.append((ct, cr))
    off = 1
    while off < k_s:
        won = [won[h ^ off] if precedes(won[h ^ off], won[h]) else won[h]
               for h in range(k_s)]
        off <<= 1
    return won[h0]


@pytest.mark.parametrize("seed", range(4))
def test_split_merge_matches_plain_tie_rule(seed):
    """Windows of copies of two triangles at t 1 and 2 and of misses, at
    random positions: exact-t ties at every position of every row. With
    1, 2 or 4 threads a lane (K3, K6b and K9 take 2) the shares' winners
    merged by precedes, each window's then meeting the earlier windows'
    (the later window winning at equal t), give the plain version's slot
    (ops/packet.py::_dense_windows, _mt_chunk_math's rule) on every
    lane, whatever share holds the result."""
    rng = np.random.default_rng(seed)
    n_win = 3
    recs = _tie_records(rng, n_win * 128)
    if seed == 3:       # a window of misses only, then a tie with window 0
        recs[128:256, 9] = -1.0
        recs[256:, 2] = 1.0
    rays = _tie_rays(rng)
    rec_t = torch.as_tensor(recs)
    rows0 = np.arange(n_win) * 16
    n = len(rays[0])
    bt = torch.full((n,), tpk.BIG)
    bs = torch.full((n,), -1, dtype=torch.int32)
    on = torch.ones((n_win, n), dtype=torch.bool)
    p_t, p_s = tpk._dense_windows(rec_t[:, :10], rows0, rays, on, False, bt,
                                  bs, None)
    t = _tie_t(recs, rays)
    for k_s in (1, 2, 4):
        for lane in range(n):
            best_t, best_s = tpk.BIG, -1
            for w in range(n_win):
                for h0 in range(k_s):
                    got = _split_winner(t[w * 128:(w + 1) * 128, lane], k_s,
                                        h0)
                    assert got == _split_winner(
                        t[w * 128:(w + 1) * 128, lane], k_s, 0)
                ct, cr = got
                if ct < tpk.BIG and ct <= best_t:
                    best_t, best_s = ct, w * 128 + cr
            assert (best_t, best_s) == (float(p_t[lane]), int(p_s[lane]))


def _resident_winner(t, k_s, h0, best):
    """packet_v1.cu's K6a leaf for one lane, replayed (ring_leaf,
    dense_resident): the leaf's records in chunks of 128 (the last one
    partial); share h takes records h, h + k_s, ... of a chunk in
    ascending order where it hits at t <= its best; the shares merge by
    the lower t, then the higher record, over the xor butterfly of warp
    shuffles, seen from share h0; the chunk's winner meets the running
    best (t, record within the leaf) where t <= its t. t: inf on a
    miss."""
    def beats(a, b):
        return a[0] < b[0] or (a[0] == b[0] and a[1] > b[1])
    for c0 in range(0, len(t), 128):
        chunk = t[c0:c0 + 128]
        won = []
        for h in range(k_s):
            ct, cr = tpk.BIG, -1
            for r in range(h, len(chunk), k_s):
                if np.isfinite(chunk[r]) and chunk[r] <= ct:
                    ct, cr = chunk[r], r
            won.append((ct, cr))
        off = 1
        while off < k_s:
            won = [won[h ^ off] if beats(won[h ^ off], won[h]) else won[h]
                   for h in range(k_s)]
            off <<= 1
        ct, cr = won[h0]
        if cr >= 0 and ct <= best[0]:
            best = (ct, c0 + cr)
    return best


@pytest.mark.parametrize("count", [1, 127, 128, 129, 300])
def test_resident_merge_matches_plain_tie_rule(count):
    """K6a's leaf on the card (packet_v1.cu::ring_leaf, dense_resident),
    replayed: a leaf of `count` records from the unaligned record 4 q
    (q odd), then a leaf of 7 records earlier in the array, with exact-t
    ties at every position; with 1, 2 or 4 threads a lane (K6a takes 2)
    the shares' winners, merged by the lower t and then the higher record
    in chunks of 128, give ops/packet.py::_resident_leaf's t and slot on
    every lane, whatever share holds the result: the highest record at
    equal t within a leaf, the later leaf across leaves."""
    rng = np.random.default_rng(count)
    first, early = 4 * 3, 4
    recs = _tie_records(rng, first + count + 5)
    rays = _tie_rays(rng)
    rec_t = torch.as_tensor(recs)[:, :10]
    n = len(rays[0])
    bt = torch.full((n,), tpk.BIG)
    bs = torch.full((n,), -1, dtype=torch.int32)
    leaves = ((first, count), (early, 7))
    for f, c in leaves:
        bt, bs = tpk._resident_leaf(rec_t, rays, f, c, bt, bs)
    t = _tie_t(recs, rays)
    t = np.where(t < np.float32(tpk.BIG), t, np.inf)
    ties = 0
    for lane in range(n):
        ties += int((t[first:first + count, lane] == bt[lane].item()).sum()
                    > 1)
        for k_s in (1, 2, 4):
            for h0 in range(k_s):
                best = (tpk.BIG, -1)
                for f, c in leaves:
                    bt_, r = _resident_winner(t[f:f + c, lane], k_s, h0,
                                              (best[0], -1))
                    if r >= 0:
                        best = (bt_, f + r)
                assert best == (float(bt[lane]), int(bs[lane]))
    assert count == 1 or ties > 0   # the leaf's winners had equal-t rivals
