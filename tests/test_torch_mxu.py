"""Port parity, the plane-form engine K8: the port's ops/packet_mxu.py
(mxu_rows_from_quads, traverse_packet(engine="mxu"), the kernel's plain
torch version packet_mxu_reference) against the JAX package's
ops/packet_mxu.py (mxu_rows_from_quads, packet_call_mxu and its Pallas
kernel _kernel_mxu in interpret mode), on the soup of
tests/test_torch_legacy.py (3000 triangles, depth 14, leaf 16) at 32x32
pixel rays, tiles of 256 and 1024, one case with dead lanes, and on the
terrain with empty leaves of tests/test_torch_stream2.py; the stack guard
of the plain K8.

Contract. The JAX kernel sums its planes as a matrix product at HIGHEST
precision, in an order of its own (and XLA contracts products into FMAs
on the CPU); the port sums them term by term, rounding each operation,
as its CUDA kernel does. So a grazing edge could flip, and the JAX
package's own test budgets this engine (tests/test_packet.py::
test_mxu_engine_experimental_parity). On these fixtures the two turn out
exact, and the tests assert that: coefficient rows within rtol 1e-6 atol
1e-6 (XLA's FMAs in the cross products) with the pad triangles' det
columns exactly zero; kernel slots and all five stats lanes equal, best t
within rtol 1e-6; on the terrain's shared edges slots may differ at exact-t
ties (at most 1% of the lanes). Records: tests/test_plist.py's contract
against JAX's, and the brute force on the live lanes (hit masks equal, t
allclose rtol 1e-5 atol 1e-6). The JAX kernel takes 2-3 s a call in
interpret mode: four calls."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.ops import packet_mxu as jmx
from clpathtracer_tpu_torch.ops import packet as tpk
from clpathtracer_tpu_torch.ops import packet_mxu as tmx
from test_torch_legacy import SIZE, fx  # noqa: F401  (the soup fixture)
from test_torch_legacy import _tie_rays, _tie_records
from test_torch_plist import _bruteforce
from test_torch_stream2 import (_Table, chain_table, check_record,
                                dead_lanes, spy_runs, terrain)  # noqa: F401

torch.set_num_threads(2)
# case -> (tile, dead lanes)
CASES = {"t256": (256, False), "t1024": (1024, False),
         "t256_dead": (256, True)}


def jax_mxu(f, tile, dead=False):
    extra = {"active": jnp.asarray(~dead_lanes())} if dead else {}
    return lambda: jpk.traverse_packet(
        f["jt"], f["jt"].quads, f["orig"], f["dirs"],
        image_shape=(SIZE, SIZE), tile=tile, engine="mxu", **extra)


@pytest.fixture(scope="module")
def jax_runs(fx):  # noqa: F811
    runs = spy_runs(pytest.MonkeyPatch.context, jmx, "packet_call_mxu",
                    [jax_mxu(fx, *CASES[c]) for c in CASES])
    return dict(zip(CASES, runs))


def port_args(f, tile, dead=False):
    active = torch.as_tensor(~dead_lanes()) if dead else None
    return tmx.mxu_kernel_args(f["pt"], f["o"], f["d"], (SIZE, SIZE), tile,
                               active)


def check_inputs(args, run, pt):
    """The port's K8 inputs are the JAX kernel's: rays and active mask
    (transposed: JAX's are [N, 3] and [N, 1]), coefficient rows (rtol
    1e-6), and the node tables read the same fields."""
    nodes_i, nodes_f, chunks, orig_t, dir_t, act = (a.numpy() for a in args)
    j_nodes, j_chunks, j_o, j_d, j_act = run["args"]
    np.testing.assert_array_equal(orig_t, j_o.T)
    np.testing.assert_array_equal(dir_t, j_d.T)
    np.testing.assert_array_equal(act, j_act[:, 0])
    np.testing.assert_allclose(chunks, j_chunks, rtol=1e-6, atol=1e-6)
    m = pt.num_nodes
    body = j_nodes[1:1 + m]     # the padded layout: [flags, split, cl, ch,
    np.testing.assert_array_equal(nodes_f[6:], body[:, 1])    # qs, cnt]
    flags = body[:, 0].astype(np.int32)
    leaf = flags >= 4
    np.testing.assert_array_equal(nodes_i[:, 0], flags)
    np.testing.assert_array_equal(nodes_i[~leaf, 1:3],
                                  body[~leaf, 2:4].astype(np.int32))
    first = body[leaf, 4].astype(np.int64) * 4
    cnt = body[leaf, 5].astype(np.int64)
    np.testing.assert_array_equal(nodes_i[leaf, 1], first // 128)
    np.testing.assert_array_equal(nodes_i[leaf, 3],
                                  (first + cnt + 127) // 128 - first // 128)


def check_kernel(out, run, tile, ties=False):
    bt, bs, st = (x.numpy() for x in out)
    j_t, j_s, j_st = run["out"]
    np.testing.assert_allclose(bt, j_t[:, 0], rtol=1e-6, atol=0)
    same = bs == j_s[:, 0].astype(np.int32)
    if ties:
        assert same.mean() > 0.99 and (bs[~same] >= 0).all()
    else:
        assert same.all()
    np.testing.assert_array_equal(st, j_st[::8, :5].astype(np.int32))
    assert st.shape == (SIZE * SIZE // tile, 5) and (bs >= 0).sum() > 100


@pytest.mark.parametrize("scene", ["soup", "terrain"])
def test_mxu_rows_match_jax(fx, terrain, scene):  # noqa: F811
    """The coefficient chunks against JAX's on the same records, the pad
    triangles' det columns exactly zero, and every coefficient K8 skips
    exactly zero."""
    f = fx if scene == "soup" else terrain
    got = tmx.mxu_rows_from_quads(f["pt"].tris).numpy()
    ref = np.asarray(jmx.mxu_rows_from_quads(f["jt"].quads))
    assert got.shape == ref.shape and got.shape[1] == 512
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    tid = np.full(got.shape[0] // 16 * 128, -1.0, np.float32)
    tid[:f["pt"].tris.shape[0]] = f["pt"].tris[:, 9].numpy()
    det = got.reshape(-1, 16, 4, 128)[:, :, 0, :]              # [C, 16, 128]
    pad = (tid < 0).reshape(-1, 128)
    assert pad.any()
    for a in (det, ref.reshape(-1, 16, 4, 128)[:, :, 0, :]):
        assert (a.transpose(0, 2, 1)[pad] == 0).all()
    used = np.zeros((16, 4), bool)
    used[list(tmx.SEG_ROWS), list(tmx.SEG_PLANES)] = True
    assert used.sum() == 19
    assert (got.reshape(-1, 16, 4, 128)[:, ~used, :] == 0).all()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k8_matches_jax(fx, jax_runs, case):  # noqa: F811
    """The plain K8 on the JAX kernel's inputs: slots and all five stats
    lanes equal, t to the last bit (rtol 1e-6)."""
    tile, dead = CASES[case]
    args, layout = port_args(fx, tile, dead)
    assert layout == ("blocks", SIZE, SIZE, *tpk.tile_shape(tile))
    check_inputs(args, jax_runs[case], fx["pt"])
    out = tmx.packet_mxu(*args, tile=tile)
    check_kernel(out, jax_runs[case], tile)
    if dead:
        assert (out[2][3] == 0).all()      # the tile with no live lane


@pytest.mark.parametrize("case", list(CASES))
def test_traverse_packet_mxu_matches_jax_and_bruteforce(
        fx, jax_runs, case):  # noqa: F811
    tile, dead = CASES[case]
    kw = {"active": torch.as_tensor(~dead_lanes())} if dead else {}
    rec = tpk.traverse_packet(fx["pt"], fx["o"], fx["d"], (SIZE, SIZE),
                              tile, engine="mxu", **kw)
    check_record(rec, jax_runs[case]["rec"], fx,
                 dead_lanes() if dead else None)


def test_empty_leaf_terrain(terrain):  # noqa: F811
    """Empty leaves not on a chunk boundary (one chunk there, by the JAX
    kernel's arithmetic) and chunks shared by several leaves."""
    nt = terrain["pt"].node_table.numpy()
    empty = (nt[:, 7] >= 4) & (nt[:, 11] == 0)
    assert (empty & (nt[:, 10] * 4 % 128 != 0)).any()
    (run,) = spy_runs(pytest.MonkeyPatch.context, jmx, "packet_call_mxu",
                      [jax_mxu(terrain, 256)])
    args, _ = port_args(terrain, 256)
    check_inputs(args, run, terrain["pt"])
    check_kernel(tmx.packet_mxu(*args, tile=256), run, 256, ties=True)
    rec = tpk.traverse_packet(terrain["pt"], terrain["o"], terrain["d"],
                              (SIZE, SIZE), 256, engine="mxu")
    check_record(rec, run["rec"], terrain)


def test_stack_overflow_raises(fx):  # noqa: F811
    """A walk that would pass the 128-entry stack raises RuntimeError;
    below the limit the same walk runs."""
    _, _, chunks, orig_t, dir_t, act = port_args(fx, 256)[0]

    def call(depth):
        return tmx.packet_mxu(*tmx.mxu_nodes(_Table(chain_table(depth))),
                              chunks, orig_t, dir_t, act, tile=256)
    st = call(100)[2]
    assert (st[:, 0] == 201).all() and (st[:, 1] == 0).all()
    with pytest.raises(RuntimeError, match="overflowed"):
        call(200)


@pytest.mark.parametrize("bad", ["chunks", "dtype", "tile"])
def test_packet_mxu_rejects_bad_arguments(fx, bad):  # noqa: F811
    args, _ = port_args(fx, 256)
    args = list(args)
    tile = 256
    if bad == "chunks":
        args[2] = args[2][:8]
    elif bad == "dtype":
        args[3] = args[3].double()
    else:
        tile = 768
    with pytest.raises(ValueError, match="packet_mxu"):
        tmx.packet_mxu(*args, tile=tile)


# K8's tiles: those of every kd walk wrapper (packet._walk_takes); which of
# them run on a cluster of 8 blocks (multiples of 256, 2 threads a lane)
# or on one block is the kernel's choice, read on the card
# (packet_mxu_shape, chip_smoke.py phase 2)
MXU_TILES = ([(t, True) for t in (32, 128, 224, 256, 480, 512, 1024, 1536,
                                  2048, 4096)]
             + [(t, False) for t in (0, 48, 544, 768, 4352, 8192)])


@pytest.mark.parametrize("tile,taken", MXU_TILES)
def test_mxu_tile_rule(tile, taken):
    """packet_mxu takes whole warps up to 4096 and multiples of 512 above
    512, the rule of every kd walk, and refuses other tiles on the host as
    on the card. A taken tile of dead lanes does no walk."""
    n = max(tile, 32)
    nodes_i = torch.tensor([[4, 0, 0, 0]], dtype=torch.int32)
    args = (nodes_i, torch.zeros(7), torch.zeros((tmx.MXU_ROWS,
                                                  4 * tmx.MXU_TRIS)),
            torch.zeros((3, n)), torch.zeros((3, n)), torch.zeros(n))
    assert tpk._walk_takes(tile) is taken
    if not taken:
        with pytest.raises(ValueError, match=f"packet_mxu: tile {tile}"):
            tmx.packet_mxu(*args, tile=tile)
        return
    _, best_slot, stats = tmx.packet_mxu(*args, tile=tile)
    assert (best_slot == -1).all() and (stats == 0).all()


BIG32 = np.float32(tpk.BIG)


def _share_winner(t, k_s, h0):
    """packet_mxu.cu::dense_chunk's chunk winner for one lane, replayed:
    share h tests triangles h, h + k_s, ... in ascending order and keeps a
    triangle where its t is less than its best, so the lowest triangle
    among equal t; the shares then merge by the lower t, then the lower
    triangle, over the xor butterfly of warp shuffles, seen from share h0.
    t: [128] float32, BIG on a miss."""
    won = []
    for h in range(k_s):
        ct, cj = BIG32, tmx.MXU_TRIS
        for j in range(h, tmx.MXU_TRIS, k_s):
            if t[j] < ct:
                ct, cj = t[j], j
        won.append((ct, cj))

    def beats(a, b):
        return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])
    off = 1
    while off < k_s:
        won = [won[h ^ off] if beats(won[h ^ off], won[h]) else won[h]
               for h in range(k_s)]
        off <<= 1
    return won[h0]


@pytest.mark.parametrize("seed", range(4))
def test_mxu_split_merge_matches_plain_tie_rule(seed):
    """Chunks of copies of two triangles at t 1 and 2 and of misses, at
    random positions: exact-t ties everywhere. With 1, 2 or 4 threads a
    lane (K8 takes 2 on a cluster) the shares' winners, merged by the lower
    t and then the lower triangle, each chunk's then meeting the earlier
    chunks' where t <= the best so far, give the plain version's t and
    slot (ops/packet_mxu.py::_dense_chunks: within a chunk the least t and
    the lowest slot among equal t, across chunks the later chunk at equal
    t) on every lane, whatever share holds the result."""
    rng = np.random.default_rng(seed)
    n_chunks = 3
    recs = _tie_records(rng, n_chunks * tmx.MXU_TRIS)
    if seed == 3:       # a chunk of misses only, then a tie with chunk 0
        recs[128:256, 9] = -1.0
        recs[256:, 2] = 1.0
    rays = _tie_rays(rng)
    coef = tmx.staged_coefficients(tmx.mxu_rows_from_quads(
        torch.as_tensor(recs)))
    feats = tmx.mxu_features(rays)
    n = len(rays[0])
    p_t, p_s = tmx._dense_chunks(
        coef, np.arange(n_chunks), feats, torch.ones(n, dtype=torch.bool),
        torch.full((n,), tpk.BIG), torch.full((n,), -1, dtype=torch.int32),
        None)
    # every pair's t as the kernel sums it: exactly 1 or 2, or a miss
    det, ud, vd, td = tmx.mxu_planes(coef[:, :, None, :],
                                     [f[None, None, :] for f in feats])
    ok = ((det > 0.0) & (ud >= 0.0) & (ud <= det) & (vd >= 0.0)
          & (ud + vd <= det) & (td > 0.0))
    t = torch.where(ok, td / torch.where(ok, det, 1.0), tpk.BIG).numpy()
    want = np.where(recs[:, 9] >= 0.0, recs[:, 2], BIG32)
    assert (t == want.reshape(n_chunks, tmx.MXU_TRIS)[:, :, None]).all()
    for k_s in (1, 2, 4):
        for lane in range(n):
            best_t, best_s = BIG32, -1
            for c in range(n_chunks):
                won = {_share_winner(t[c, :, lane], k_s, h0)
                       for h0 in range(k_s)}
                assert len(won) == 1
                ct, cj = won.pop()
                if ct < BIG32 and ct <= best_t:
                    best_t, best_s = ct, c * tmx.MXU_TRIS + cj
            assert (float(best_t), best_s) == (float(p_t[lane]),
                                               int(p_s[lane]))
