"""Port parity, the half-split stream engine K7: the port's
traverse_packet(engine="stream2") and its kernel's plain torch version
(ops/packet.py::packet_stream2_reference) against the JAX package's
traverse_packet(engine="stream2") and its Pallas kernel _kernel_stream2 in
interpret mode, on the soup of tests/test_torch_legacy.py (3000 triangles,
depth 14, leaf 16) at 32x32 pixel rays, tiles of 256 and 512, one case
with dead lanes (tiles with a dead left half, a dead right half, no live
lane); on the smallest terrain whose tree has empty leaves; the stream2
rule of packet_mode; the stack guard of the plain K3, K5 and K7.

Contract. Kernel: best slot and tile_stats lanes 0-2 equal, lanes 3-4 zero
on both sides; best t within rtol 1e-6 (XLA contracts the JAX kernel's
products into FMAs on the CPU, so its t can differ from the port's in the
last bit; the port's plain version rounds every operation as its CUDA
kernel does). Records: tests/test_plist.py's (hit masks equal, t allclose
rtol 1e-5 atol 1e-6, triangle ids equal on more than 95% of hits), and
against a brute-force Moller-Trumbore over all triangles on the live
lanes hit masks equal and t allclose (rtol 1e-5, atol 1e-6).

One exception, by design: where a tile's halves differ in direction sign
on a split axis (here a tile whose left half is dead), the JAX kernel
gives the right half the left half's near and far intervals and loses
hits that its own stream engine finds; the port gives each half its own
(ops/csrc/packet_stream2.cu). On that tile the port is held to the brute
force, and the JAX record is shown to miss. The JAX kernel takes 7-9 s a
call in interpret mode: four calls."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.accel.sah import build_kd_tree as j_build
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.core.camera import cam_matrix as j_cam_matrix
from clpathtracer_tpu.core.camera import generate_rays as j_generate_rays
from clpathtracer_tpu.ops import packet as jpk
from clpathtracer_tpu.scene.procedural import terrain_mesh as j_terrain
from clpathtracer_tpu_torch import interop
from clpathtracer_tpu_torch.ops import _cuda
from clpathtracer_tpu_torch.ops import packet as tpk
from test_torch_legacy import SIZE, fx  # noqa: F401  (the soup fixture)
from test_torch_packet import _assert_hits
from test_torch_plist import _bruteforce

torch.set_num_threads(2)
CPU = torch.device("cpu")
# case -> (tile, dead lanes)
CASES = {"t256": (256, False), "t512": (512, False), "t256_dead": (256, True)}
TERRAIN_TRIS = 1000   # the smallest terrain here whose tree (depth 14,
                      # leaf 16) has empty leaves, some at odd quad starts


SIGN_TILE = 0         # the 256-ray tile whose left half is dead


def dead_lanes(seed=0):
    """[SIZE*SIZE] bool in pixel order: 30% of the lanes at random; of
    the 16x16 blocks (256-ray tiles 0-3, row-major), the top half (the
    left half of the tile's lanes) of tile 0, the bottom half (the right
    half) of tile 1 and all of tile 3, a tile with no live lane."""
    dead = np.random.default_rng(seed).random((SIZE, SIZE)) < 0.3
    dead[0:8, 0:16] = True
    dead[8:16, 16:32] = True
    dead[16:32, 16:32] = True
    return dead.reshape(-1)


def sign_lanes(tile):
    """[SIZE*SIZE] bool in pixel order: the lanes of SIGN_TILE in the
    dead-lane case, else none."""
    lanes = np.zeros((SIZE, SIZE), bool)
    if tile == 256:
        lanes[0:16, 0:16] = True
    return lanes.reshape(-1)


def spy_runs(monkeypatch_ctx, module, name, calls):
    """Run each of calls (-> record) with module.name wrapped: returns
    [(captured inputs, raw outputs, record as numpy)]."""
    out = []
    real = getattr(module, name)
    for call in calls:
        seen = {}

        def spy(*args, seen=seen, **kw):
            res = real(*args, **kw)
            seen["args"] = [np.asarray(a) for a in args]
            seen["out"] = [np.asarray(r) for r in res]
            return res
        with monkeypatch_ctx() as mp:
            mp.setattr(module, name, spy)
            rec = call()
        out.append(dict(seen, rec={k: np.asarray(v) for k, v in rec.items()}))
    return out


@pytest.fixture(scope="module")
def jax_runs(fx):  # noqa: F811
    def call(tile, dead):
        extra = {"active": jnp.asarray(~dead_lanes())} if dead else {}
        return lambda: jpk.traverse_packet(
            fx["jt"], fx["jt"].quads, fx["orig"], fx["dirs"],
            image_shape=(SIZE, SIZE), tile=tile, engine="stream2", **extra)
    runs = spy_runs(pytest.MonkeyPatch.context, jpk, "_packet_call_stream2",
                    [call(*CASES[c]) for c in CASES])
    return dict(zip(CASES, runs))


@pytest.fixture(scope="module")
def terrain():
    """The terrain with empty leaves, seen from above as in
    tests/test_packet.py::test_empty_leaf_scenes_all_engines, and JAX's
    stream2 run on it (tile 256)."""
    scene = j_terrain(TERRAIN_TRIS)
    tv = np.stack([np.asarray(v) for v in scene.tri_verts()], 1)
    jt = j_build(tv, max_depth=14, leaf_size=16, tri_block=4)
    pt = interop.tree_from_numpy(jt.node_table, jt.tri_indices, jt.quads,
                                 jt.chunk_start, jt.chunk_bnd, None,
                                 jt.max_leaf_tris, jt.wide_table, device=CPU)
    cam = JCamera.create(position=[0.0, 14.0, 0.0],
                         forward=[0.0, -1.0, 0.01])
    orig, dirs = j_generate_rays(j_cam_matrix(cam, SIZE), SIZE, SIZE)
    return dict(tv=tv, jt=jt, pt=pt, orig=orig, dirs=dirs,
                o=torch.as_tensor(np.array(orig)),
                d=torch.as_tensor(np.array(dirs)))


def port_args(f, tile, dead=False):
    active = torch.as_tensor(~dead_lanes()) if dead else None
    return tpk.stream2_kernel_args(f["pt"], f["o"], f["d"], (SIZE, SIZE),
                                   tile, active)


def check_inputs(args, run, pt):
    """The port's K7 inputs are the JAX kernel's: rays, active mask,
    records, and the node tables read the same fields."""
    nodes_i, nodes_f, rows, orig_t, dir_t, act = (a.numpy() for a in args)
    j_nodes, j_rows, j_o, j_d, j_act = run["args"]
    np.testing.assert_array_equal(orig_t, j_o)
    np.testing.assert_array_equal(dir_t, j_d)
    np.testing.assert_array_equal(act, j_act[0])
    np.testing.assert_array_equal(rows, j_rows.reshape(-1, 16))
    m = pt.num_nodes
    body = j_nodes[1:1 + m]        # the padded layout: [flags, split, cl,
    np.testing.assert_array_equal(nodes_f[6:], body[:, 1])   # ch, qs, cnt]
    np.testing.assert_array_equal(nodes_f[:6], j_nodes[0, :6])
    flags = body[:, 0].astype(np.int32)
    leaf = flags >= 4
    np.testing.assert_array_equal(nodes_i[:, 0], flags)
    np.testing.assert_array_equal(nodes_i[~leaf, 1:3],
                                  body[~leaf, 2:4].astype(np.int32))
    first = body[leaf, 4].astype(np.int64) * 4
    cnt = body[leaf, 5].astype(np.int64)
    r0 = first // 8
    np.testing.assert_array_equal(nodes_i[leaf, 1], r0)
    np.testing.assert_array_equal(
        nodes_i[leaf, 3], ((first + cnt + 7) // 8 - r0 + 15) // 16)


def check_kernel(out, run, tile, skip=None, ties=False):
    """The kernel's outputs against the JAX kernel's, on every tile but
    `skip` (tile-major lanes). ties: a mesh with shared edges, where a ray
    through an edge hits two triangles at the same t (to the last bit,
    which XLA's FMAs can move): slots may differ at such ties, on at most
    1% of the lanes."""
    bt, bs, st = (x.numpy() for x in out)
    j_t, j_s, j_st = run["out"]
    j_st = j_st[::8, :5].astype(np.int32)
    assert st.shape == (SIZE * SIZE // tile, 5) and (bs >= 0).sum() > 100
    assert (st[:, 3:] == 0).all() and (j_st[:, 3:] == 0).all()
    lanes = np.ones(bs.shape, bool)
    tiles = np.ones(st.shape[0], bool)
    if skip is not None:
        lanes[skip * tile:(skip + 1) * tile] = False
        tiles[skip] = False
    np.testing.assert_allclose(bt[lanes], j_t[0][lanes], rtol=1e-6, atol=0)
    same = bs[lanes] == j_s[0][lanes].astype(np.int32)
    if ties:   # the t of the differing slots agree (rtol 1e-6 above)
        assert same.mean() > 0.99 and (bs[lanes][~same] >= 0).all()
    else:
        assert same.all()
    np.testing.assert_array_equal(st[tiles, :3], j_st[tiles, :3])


def check_record(rec, ref, f, dead=None, skip=None):
    """A record against JAX's (but on the pixel lanes `skip`) and the
    brute force on the live lanes."""
    keep = np.ones(rec["hit"].shape, bool) if skip is None else ~skip
    _assert_hits({k: rec[k][torch.as_tensor(keep)] for k in ("hit", "t",
                                                             "tri")},
                 {k: ref[k][keep] for k in ("hit", "t", "tri")})
    if skip is None:
        np.testing.assert_array_equal(rec["tile_stats"].numpy(),
                                      ref["tile_stats"].astype(np.int32))
    hit, t = _bruteforce(f["tv"], f["o"], f["d"])
    live = (torch.ones_like(hit) if dead is None
            else torch.as_tensor(~dead))
    assert torch.equal(rec["hit"][live], hit[live])
    assert not rec["hit"][~live].any()
    both = rec["hit"] & live
    np.testing.assert_allclose(rec["t"][both].numpy(), t[both].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n, tile, engine, want", [
    (1024, 256, "stream2", "stream2"), (1024, 512, "stream2", "stream2"),
    (1024, 1024, "stream2", "stream"), (768, 256, "stream2", "stream"),
    (768, 256, "mxu", "mxu")])
def test_packet_mode_stream2_rule(fx, n, tile, engine, want):  # noqa: F811
    """Both packages run K7 only on whole pairs of tiles, else K3."""
    assert jpk.packet_mode(fx["jt"], n, tile, engine) == want
    assert tpk.packet_mode(fx["pt"], n, tile, engine) == want


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k7_matches_jax(fx, jax_runs, case):  # noqa: F811
    """The plain K7 on the JAX kernel's own inputs: equal slots and stats
    lanes 0-2 (lanes 3-4 zero), t to the last bit (rtol 1e-6); in the
    dead-lane case on every tile but SIGN_TILE."""
    tile, dead = CASES[case]
    args, layout = port_args(fx, tile, dead)
    assert layout == ("blocks", SIZE, SIZE, *tpk.tile_shape(tile))
    check_inputs(args, jax_runs[case], fx["pt"])
    out = tpk.packet_stream2(*args, tile=tile)
    check_kernel(out, jax_runs[case], tile, SIGN_TILE if dead else None)
    if dead:   # a dead left half, a dead right half, no live lane
        st = out[2].numpy()
        live = ~dead_lanes().reshape(SIZE, SIZE)
        assert st[0, 2] == live[8:16, 0:16].sum() > 0 and st[0, 0] > 0
        assert st[1, 2] == live[0:8, 16:32].sum() > 0 and st[1, 0] > 0
        assert (st[3] == 0).all()


@pytest.mark.parametrize("case", list(CASES))
def test_traverse_packet_stream2_matches_jax_and_bruteforce(
        fx, jax_runs, case):  # noqa: F811
    tile, dead = CASES[case]
    kw = {"active": torch.as_tensor(~dead_lanes())} if dead else {}
    rec = tpk.traverse_packet(fx["pt"], fx["o"], fx["d"], (SIZE, SIZE),
                              tile, engine="stream2", **kw)
    ref = jax_runs[case]["rec"]
    if not dead:
        check_record(rec, ref, fx)
        return
    sign = sign_lanes(tile)
    check_record(rec, ref, fx, dead_lanes(), sign)
    # the JAX kernel's miss: live lanes whose brute-force hit it loses, all
    # on the tile whose left half is dead
    hit, _ = _bruteforce(fx["tv"], fx["o"], fx["d"])
    lost = hit.numpy() & ~ref["hit"] & ~dead_lanes()
    assert lost.any() and not (lost & ~sign).any()


def test_stream2_on_a_wave_of_odd_tiles_runs_k3(fx):  # noqa: F811
    """A wave that is not whole pairs of tiles runs "stream" in both
    packages' packet_mode, and the port's result is its K3 result."""
    for image_shape, tile in (((SIZE, SIZE), 1024), (None, 256)):
        o, d = fx["o"], fx["d"]
        if image_shape is None:
            o, d = o[:768], d[:768]
        n = o.shape[0]
        assert jpk.packet_mode(fx["jt"], n, tile, "stream2") == "stream"
        rec = tpk.traverse_packet(fx["pt"], o, d, image_shape, tile,
                                  engine="stream2")
        ref = tpk.traverse_packet(fx["pt"], o, d, image_shape, tile)
        for k in rec:
            assert torch.equal(rec[k], ref[k]), k


def test_empty_leaf_terrain(terrain):
    """Empty leaves, some at odd quad starts (one chunk there, by the JAX
    kernel's row arithmetic): the plain K7 equals JAX's kernel (stats
    exactly, slots but at shared-edge ties), and the records JAX's and the
    brute force."""
    nt = terrain["pt"].node_table.numpy()
    empty = (nt[:, 7] >= 4) & (nt[:, 11] == 0)
    assert empty.any() and (empty & (nt[:, 10] % 2 == 1)).any()
    (run,) = spy_runs(
        pytest.MonkeyPatch.context, jpk, "_packet_call_stream2",
        [lambda: jpk.traverse_packet(
            terrain["jt"], terrain["jt"].quads, terrain["orig"],
            terrain["dirs"], image_shape=(SIZE, SIZE), tile=256,
            engine="stream2")])
    args, _ = port_args(terrain, 256)
    check_inputs(args, run, terrain["pt"])
    check_kernel(tpk.packet_stream2(*args, tile=256), run, 256, ties=True)
    rec = tpk.traverse_packet(terrain["pt"], terrain["o"], terrain["d"],
                              (SIZE, SIZE), 256, engine="stream2")
    check_record(rec, run["rec"], terrain)


def chain_table(depth):
    """A [depth + 2, 16] node table (the packed node table's first 16
    columns) whose interval walk grows the stack one entry a level, for
    rays that travel along +z from z < 0: split i (axis z, plane z = 0)
    has the near child i + 1 and the far child depth + 1, an empty leaf,
    both live; node depth is an empty leaf. The walk pops depth splits,
    then 1 + depth empty leaves."""
    t = np.zeros((depth + 2, 16), np.float32)
    t[:, 0:3], t[:, 3:6] = -10.0, 10.0
    t[:depth, 7] = 2.0
    t[:depth, 8] = np.arange(1, depth + 1)
    t[:depth, 9] = depth + 1
    t[depth:, 7] = 4.0
    return t


class _Table:
    """The fields of a tree that stream_nodes reads."""

    def __init__(self, t):
        self.node_table = torch.as_tensor(t)
        self.chunk_start = None


def guard_call(engine, table, rows, orig_t, dir_t, act, tile):
    tree = _Table(table)
    if engine == "stream2":
        return tpk.packet_stream2(*tpk.stream2_nodes(tree), rows, orig_t,
                                  dir_t, act, tile=tile)
    call = tpk.packet_stream if engine == "stream" else tpk.packet_queue
    return call(*tpk.stream_nodes(tree), rows, orig_t, dir_t, act, tile=tile,
                so=False)


@pytest.mark.parametrize("engine", ["stream", "queue", "stream2"])
def test_stack_overflow_raises(fx, engine):  # noqa: F811
    """A walk that would pass the 128-entry stack raises RuntimeError
    (the plain K3, K5, K7); below the limit the same walk runs."""
    args, _ = port_args(fx, 256)
    rows, orig_t, dir_t, act = args[2:]
    st = guard_call(engine, chain_table(100), rows, orig_t, dir_t, act,
                    256)[2]
    assert (st[:, 0] == 201).all() and (st[:, 1] == 0).all()
    with pytest.raises(RuntimeError, match="overflowed"):
        guard_call(engine, chain_table(200), rows, orig_t, dir_t, act, 256)


@pytest.mark.parametrize("bad", ["dtype", "tile", "rows", "device"])
def test_packet_stream2_rejects_bad_arguments(fx, bad):  # noqa: F811
    args, _ = port_args(fx, 256)
    args = list(args)
    tile = 256
    if bad == "dtype":
        args[0] = args[0].float()
    elif bad == "tile":
        tile = 768
    elif bad == "rows":
        args[2] = args[2][:64]
    else:
        args[5] = args[5].to("meta")
    with pytest.raises(ValueError, match="packet_stream2"):
        tpk.packet_stream2(*args, tile=tile)


# K7's tiles: those of every kd walk wrapper (packet._walk_takes); which of
# them run on a cluster of 8 blocks (multiples of 256, 2 threads a lane)
# or on one block is the kernel's choice, read on the card
# (packet_stream2_shape, chip_smoke.py phase 2)
STREAM2_TILES = ([(t, True) for t in (32, 128, 224, 256, 480, 512, 1024,
                                      1536, 2048, 4096)]
                 + [(t, False) for t in (0, 48, 544, 768, 4352, 8192)])


@pytest.mark.parametrize("tile,taken", STREAM2_TILES)
def test_stream2_tile_rule(tile, taken):
    """packet_stream2 takes whole warps up to 4096 and multiples of 512
    above 512, the rule of every kd walk, and refuses other tiles on the
    host as on the card. A taken tile of dead lanes does no walk."""
    n = max(tile, 32)
    nodes_i = torch.tensor([[4, 0, 0, 0]], dtype=torch.int32)
    args = (nodes_i, torch.zeros(7), torch.zeros((128, 16)),
            torch.zeros((3, n)), torch.zeros((3, n)), torch.zeros(n))
    assert tpk._walk_takes(tile) is taken
    if not taken:
        with pytest.raises(ValueError, match=f"packet_stream2: tile {tile}"):
            tpk.packet_stream2(*args, tile=tile)
        return
    _, best_slot, stats = tpk.packet_stream2(*args, tile=tile)
    assert (best_slot == -1).all() and (stats == 0).all()


def _cu_constant(stem, name):
    src = (_cuda.CSRC_DIR / f"{stem}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("tile", [t for t in range(256, 4097, 256)
                                  if tpk._walk_takes(t)])
def test_stream2_cluster_half_map(tile):
    """packet_stream2.cu's lane -> block -> half map, replayed for every
    tile the cluster form takes (a multiple of 256): block `rank` of
    kCluster owns the tile's lanes rank * tile / kCluster + tid / kSplit
    (kSplit neighbouring threads a lane, whole warps, at most 1024 threads),
    and half_lanes puts a lane in the right half where lane >= tile / 2.
    So blocks 0-3 hold the left half and 4-7 the right, no block straddles
    the two, every lane has kSplit threads, and the halves are the plain
    version's (packet_stream2_reference: lanes [0, tile / 2) and
    [tile / 2, tile))."""
    k_c = _cu_constant("packet_stream2", "kCluster")
    k_s = _cu_constant("packet_stream2", "kSplit")
    assert (k_c, k_s) == (8, 2)
    lanes = tile // k_c
    threads = lanes * k_s
    assert threads % 32 == 0 and threads <= 1024
    seen = np.zeros(tile, np.int64)
    plain_right = np.arange(tile) >= tile // 2
    for rank in range(k_c):
        lane = rank * lanes + np.arange(threads) // k_s
        right = lane >= tile // 2        # half_lanes(..., lane0, ...)
        assert (right == (rank >= k_c // 2)).all()
        assert (right == plain_right[lane]).all()
        np.add.at(seen, lane, 1)
    assert (seen == k_s).all()
