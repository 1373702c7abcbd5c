"""Packet tracing of coherent ray tiles against a kd-tree (the port's part
of clpathtracer_tpu/ops/packet.py): the stream, queue, legacy and wide
engines, their host and prepass code, and the shared-origin tables, gate
frustum planes and pixel-block layouts that the window engine
(ops/plist.py) shares.

traverse_packet cuts a wave into tiles of `tile` rays (square or 1:2 pixel
blocks of a frame, else consecutive rays) and runs K3 on them: one
interval walk of the kd-tree per tile, leaf triangles streamed in windows
of 128 records, each window culled before its dense test by one of

* the strip prepass (_strip_masks: per-strip slab and corner-frustum
  tests of every window, on the device, as torch ops) for unjittered
  shared-origin pixel frames;
* the packet interval against the window's AABB, with the tile's corner
  frustum planes for shared-origin pixel tiles;
* nothing, without window tables.

K3 is CUDA on the GPU (ops/csrc/packet_stream.cu, packet_stream) and its
plain version (packet_stream_reference) on the CPU. precision="bf16" runs
the bf16 preview K4, K3's kernel with a bf16 dense test (MT records, the
AABB cull only); engine="queue" runs K5 (ops/csrc/packet_queue.cu,
packet_queue), the same walk decoupled from the dense test by a ring of
QUEUE_DEPTH window copies in flight. engine="legacy" runs the JAX
package's v1 walk (ops/csrc/packet_v1.cu, packet_legacy): a stack walk
over binary nodes culled against the packet bounds, children ordered by
the packet's direction sign, t_upper the largest best t after every leaf;
K6a tests a leaf's own records in order from the resident array, K6b
streams its unculled 128-record windows; engine="wide" runs K9
(packet_wide), the same idea over the 8-wide supernodes of accel/wide.py
with K6b's leaf stream. engine="stream2" runs K7 (ops/csrc/
packet_stream2.cu, packet_stream2) on whole pairs of tiles, else K3: K3's
interval walk with each tile culled in halves (an interval and a t_upper
per half, a leaf's chunks tested only for the halves that reach it), no
window cull; engine="mxu" runs K8 (ops/packet_mxu.py): K3's walk, no
cull, each 128-triangle chunk tested in plane form. The winners
re-resolve t/u/v with one exact Moller-Trumbore per ray. The JAX
package's TPU scalar-memory packing (6-bit window counts, the 900 KB
budget) and its environment switches are not ported: the culls and
engines are explicit arguments at the JAX defaults. Every walk's
128-entry stack is guarded: a walk that would pass it raises
RuntimeError, on the card after the launch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from clpathtracer_tpu_torch.accel.sah import CHUNK_ROWS
from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.utils.profiling import span

BIG = 3.4e38        # "no hit" distance (f32-representable)
INV_BIG = 1e30      # clamp for 1/d of a zero direction component
TILE = 1024         # default rays per packet tile
STACK_DEPTH = 128   # entries of the walk's stack
TUP_MASK = 3        # t_upper refreshes after a leaf on every 4th pop
GATE_LANES = 512    # half-gate mode: the dense test runs per 512-lane gate
QUEUE_DEPTH = 8     # K5: windows in flight (the JAX default qdepth)
PRECISIONS = ("f32", "bf16")
BF16_MISS = 3.0e38  # the bf16 preview's miss value (bf16 max is ~3.39e38)
WARP = 32           # lanes of a warp: 32 consecutive lanes of a gate or tile
# FP32 operations per MT pair test, counted from ops/csrc/pair_tests.cuh::
# mt_hit, which leaves its test early. A pair rejected at det > 0 costs 15
# (p = d x e2: 6 mul, 3 sub; det: 3 mul, 2 add; 1 compare); at the u test
# 27 (1 reciprocal, 3 sub, 4 mul, 2 add, 2 compares more); at the v test
# 45 (q: 6 mul, 3 sub; v: 4 mul, 2 add; u + v; 2 compares more); past it
# 53 (t: 4 mul, 2 add; 2 compares more).
MT_EXIT_OPS = (15, 27, 45, 53)
_WIN_RECS = CHUNK_ROWS * 8
_INT_MAX = torch.iinfo(torch.int32).max
# (ray, record) pairs per dense step of the plain K3: bounds its
# temporaries to a few hundred MB
_REF_PAIRS = 1 << 22
# kernel modes (ops/csrc/packet_stream.cu)
_NO_CULL, _CULL, _CULL_FRUSTUM, _STRIPS = range(4)
# The JAX package's rule for choosing between its two legacy kernels: the
# node table (64 B per node) and the records (64 B each) resident when both
# fit this TPU VMEM budget (K6a), else the node table alone (K6b). Kept as
# that rule, so that engine="legacy" runs the kernel JAX runs; it is not a
# limit of the card.
VMEM_BUDGET = 12 * 1024 * 1024
# v1 kernel engines (ops/csrc/packet_v1.cu)
_V1_RESIDENT, _V1_STREAM, _V1_WIDE = range(3)


# ---------------------------------------------------------------------------
# shared-origin tables
# ---------------------------------------------------------------------------


def so_affine_tables(tris16: torch.Tensor) -> torch.Tensor:
    """Origin-independent shared-origin (SO) tables: [4, S, 16] f32
    (B0, B1, B2, B3) such that B0 + ox*B1 + oy*B2 + oz*B3 is the SO record
    of every triangle for a ray origin o.

    For rays that share the origin o, with a = v0 - o, b = v1 - o,
    c = v2 - o, a direction d hits a front face iff the signed volumes
    S1 = d.(a x b), S2 = d.(b x c), S3 = d.(c x a) are all <= 0 with
    S1 + S2 + S3 = d.n < 0, and then t = (a.n) / (d.n). Each of a x b,
    b x c, c x a and a.n is affine in o, so the tables are built once per
    scene.

    Record layout: cols 0-2 ab, 3-5 bc, 6-8 ca, 9 d0 = a.n, 10 tri_id,
    11-15 zero. The slot space is that of `tris16` (one record per row).
    Pad records (tri_id < 0) are all zero, so every S and d.n is exactly 0
    and the strict d.n < 0 test rejects them.

    Conditioning: the affine form rounds v0 x e1 and o x e1 separately, so
    edge tests lose ~|v0||o|/|a x e1| relative accuracy; rare edge-grazing
    winners can flip against a general Moller-Trumbore test. t, u and v
    re-resolve exactly from the winning slot.
    """
    v0, e1, e2, tid = (tris16[:, 0:3], tris16[:, 3:6], tris16[:, 6:9],
                       tris16[:, 9:10])
    n = vm.cross(e1, e2)
    c01 = vm.cross(v0, e1)
    c02 = vm.cross(v0, e2)
    g = e2 - e1
    z1 = torch.zeros_like(tid)
    z5 = torch.zeros((tris16.shape[0], 5), dtype=tris16.dtype,
                     device=tris16.device)

    # d(o x e)/d o_k for k = x, y, z
    def cx(e):
        return torch.stack([torch.zeros_like(e[:, 0]), -e[:, 2], e[:, 1]], 1)

    def cy(e):
        return torch.stack([e[:, 2], torch.zeros_like(e[:, 0]), -e[:, 0]], 1)

    def cz(e):
        return torch.stack([-e[:, 1], e[:, 0], torch.zeros_like(e[:, 0])], 1)

    b0 = torch.cat([c01, c02 - c01 + n, -c02,
                    vm.dot(v0, n)[:, None], tid, z5], dim=1)

    def bk(ck, nk):
        return torch.cat([-ck(e1), -ck(g), ck(e2), -nk[:, None], z1, z5],
                         dim=1)

    tabs = torch.stack([b0, bk(cx, n[:, 0]), bk(cy, n[:, 1]),
                        bk(cz, n[:, 2])])
    return torch.where(tid[None] < 0.0, 0.0, tabs)


def so_rows(tris16: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """The SO records [S, 16] for one shared ray origin [3], computed per
    frame from the MT records tris16 [S, 16] (clpathtracer_tpu/ops/
    packet.py::so_rows): the record layout of so_affine_tables, built
    from a = v0 - o first, so the crosses are Moller-Trumbore's own
    intermediates (w1 = a x e1, w2 = a x e2, n = e1 x e2; ab = w1,
    bc = w2 - w1 + n, ca = -w2, d0 = a.n) and keep its conditioning.
    Sentinel rows (tri_id < 0) are all zero. The route of a tree without
    SO tables; so_combine of the tables is the route of a tree with them."""
    o = origin.to(torch.float32).reshape(1, 3)
    v0, e1, e2, tid = (tris16[:, 0:3], tris16[:, 3:6], tris16[:, 6:9],
                       tris16[:, 9:10])
    a = v0 - o
    w1 = vm.cross(a, e1)
    w2 = vm.cross(a, e2)
    nrm = vm.cross(e1, e2)
    out = torch.cat([w1, w2 - w1 + nrm, -w2, vm.dot(a, nrm)[:, None], tid,
                     torch.zeros((tris16.shape[0], 5), dtype=tris16.dtype,
                                 device=tris16.device)], dim=1)
    return torch.where(tid < 0.0, 0.0, out)


def so_combine(so_base: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """The per-frame SO records [S, 16] for one shared ray origin [3]:
    B0 + ox*B1 + oy*B2 + oz*B3, summed left to right (the combine that
    clpathtracer_tpu/ops/plist.py::traverse_plist does inline)."""
    return (so_base[0] + origin[0] * so_base[1]
            + origin[1] * so_base[2] + origin[2] * so_base[3])


def pad_records(tris16: torch.Tensor, pad_value: float = -1.0):
    """Records [T, 16] padded with rows of `pad_value` to a multiple of 8
    and to at least CHUNK_ROWS*8 rows, so that every window of the clamped
    grid lies inside (clpathtracer_tpu/ops/packet.py::_pad_rows8, without
    its fold into 128-lane rows). -1 rows have tri_id < 0; 0 rows are
    rejected by the SO test's strict d.n < 0."""
    t_rows = tris16.shape[0]
    target = max((t_rows + 7) // 8 * 8, CHUNK_ROWS * 8)
    if target == t_rows:
        return tris16
    return torch.cat([tris16, torch.full((target - t_rows, 16), pad_value,
                                         dtype=tris16.dtype,
                                         device=tris16.device)])


# ---------------------------------------------------------------------------
# pair tests of the plain kernel versions
# ---------------------------------------------------------------------------


def so_pairs(r, dx, dy, dz):
    """The shared-origin signed-volume pair test
    (clpathtracer_tpu/ops/packet.py::_mt_chunk_math_so, its order of
    operations) over broadcast shapes: r [..., >= 10] SO records, dx/dy/dz
    direction components. Returns (ok, t) with t = BIG where rejected."""
    s1 = dx * r[..., 0] + dy * r[..., 1] + dz * r[..., 2]
    s2 = dx * r[..., 3] + dy * r[..., 4] + dz * r[..., 5]
    s3 = dx * r[..., 6] + dy * r[..., 7] + dz * r[..., 8]
    dsum = s1 + s2 + s3
    d0 = r[..., 9]
    ok = ((torch.maximum(torch.maximum(s1, s2), s3) <= 0.0)
          & (dsum < 0.0) & (d0 < 0.0))
    # rejection by select: dsum == 0 gives inf/nan quotients
    return ok, torch.where(ok, d0 / dsum, BIG)


def mt_pairs(r, ox, oy, oz, dx, dy, dz, tally=None, tested=None,
             dtype=torch.float32, lane_dim=-1):
    """The general Moller-Trumbore pair test with backface cull
    (clpathtracer_tpu/ops/packet.py::_mt_chunk_math, its order of
    operations) over broadcast shapes: r [..., >= 10] records (v0, e1, e2,
    tri_id). Returns (ok, t) with t = BIG where rejected.

    dtype=torch.bfloat16 is the bf16 preview (compute_dtype=bfloat16):
    records and rays cast to bf16 once, every operation on bf16 tensors
    (computed in f32, rounded to bf16), t back in f32; a t that rounds to
    BF16_MISS or more is a miss.

    tally (optional int64 [3] tensor): adds the counts of the pairs that
    pass det > 0, then also 0 <= u <= 1, then also v >= 0 and u + v <= 1:
    the CUDA test's early exits, which set the work these inputs need.
    tested (optional bool, broadcastable): the pairs the kernel tests; the
    tally counts only those. A tally of 7 lanes also counts what warps
    issue (warp_ops): in lanes 3-6 the (warp, record) groups with a tested
    pair, and those whose deepest tested lane passes det, u, v; a warp is
    32 consecutive lanes along dimension lane_dim of the broadcast shape."""
    if dtype != torch.float32:
        r = r[..., :10].to(dtype)
        ox, oy, oz, dx, dy, dz = (x.to(dtype) for x in (ox, oy, oz, dx, dy,
                                                        dz))
    e1x, e1y, e1z = r[..., 3], r[..., 4], r[..., 5]
    e2x, e2y, e2z = r[..., 6], r[..., 7], r[..., 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    invd = 1.0 / torch.where(det == 0.0, 1.0, det)
    tx, ty, tz = ox - r[..., 0], oy - r[..., 1], oz - r[..., 2]
    u = (tx * px + ty * py + tz * pz) * invd
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * invd
    tt = (e2x * qx + e2y * qy + e2z * qz) * invd
    pass_det = det > 0.0
    pass_u = pass_det & (u >= 0.0) & (u <= 1.0)
    pass_v = pass_u & (v >= 0.0) & (u + v <= 1.0)
    ok = pass_v & (tt > 0.0) & (r[..., 9] >= 0.0)
    if tally is not None:
        counted = [pass_det, pass_u, pass_v]
        if tested is not None:
            counted = [c & tested for c in counted]
        tally[:3].add_(torch.stack([c.sum() for c in counted]))
        if tally.numel() == 7:
            on = (torch.ones_like(pass_det) if tested is None
                  else tested.expand_as(pass_det))
            tally[3:].add_(torch.stack([_warp_any(c, lane_dim).sum()
                                        for c in (on, *counted)]))
    if dtype == torch.float32:
        return ok, torch.where(ok, tt, BIG)
    t = torch.where(ok, tt, BF16_MISS).float()
    ok = ok & (t < BF16_MISS)
    return ok, torch.where(ok, t, BIG)


def _warp_any(x, lane_dim):
    """Whether any of each WARP consecutive lanes of x along lane_dim is
    set: the lanes' dimension moved last and cut into warps."""
    x = x.movedim(lane_dim, -1)
    return x.reshape(*x.shape[:-1], -1, WARP).any(dim=-1)


def mt_ops(tests, tally, exit_ops=MT_EXIT_OPS):
    """FP32 operations of `tests` MT pairs: each pair weighted by the early
    exit it takes (tally: the pairs that pass det, u, v; its first three
    lanes are read)."""
    passed = [tests, *(int(x) for x in tally[:3])]
    left = [passed[i] - passed[i + 1] for i in range(3)] + [passed[3]]
    return sum(c * w for c, w in zip(left, exit_ops))


def warp_ops(tally, exit_ops=MT_EXIT_OPS):
    """The FP32 lane operations that warps issue for the pairs a 7-lane
    tally (mt_pairs) counted: a warp runs each record to its deepest tested
    lane's exit, so a (warp, record) group costs WARP times that exit's
    operations. Against mt_ops of the same pairs (each lane at its own
    exit), the ratio is what the early exits' divergence within warps
    costs."""
    return WARP * mt_ops(int(tally[3]), tally[4:7], exit_ops)


# ---------------------------------------------------------------------------
# packet interval helpers: array-generic (torch tensors for the strip
# prepass, numpy float32 scalars and arrays for the plain K3's walk), in
# the JAX package's order of operations
# ---------------------------------------------------------------------------


def _ops(x):
    """(where, minimum, maximum, -INV_BIG, INV_BIG) for x's library, the
    constants in f32 for numpy (a float64 constant would promote)."""
    if isinstance(x, torch.Tensor):
        return torch.where, torch.minimum, torch.maximum, -INV_BIG, INV_BIG
    return (np.where, np.minimum, np.maximum, np.float32(-INV_BIG),
            np.float32(INV_BIG))


def _packet_bounds_masked(rays, act):
    """Conservative bounds of each packet over its ACTIVE lanes: rays =
    (ox, oy, oz, dx, dy, dz), each [..., L]; act [..., L] (> 0 active).
    Returns (obnd, ibnd): per axis (origin lo, origin hi) and (clipped
    inverse-direction lo, hi), each [...]. A packet without an active
    lane gets (BIG, -BIG) and (INV_BIG, -INV_BIG)."""
    ox, oy, oz, dx, dy, dz = rays
    on = act > 0.0

    def mm(x):
        return (torch.where(on, x, BIG).amin(dim=-1),
                torch.where(on, x, -BIG).amax(dim=-1))

    def inv_mm(dc):
        inv = torch.clamp(1.0 / dc, -INV_BIG, INV_BIG)
        return (torch.where(on, inv, INV_BIG).amin(dim=-1),
                torch.where(on, inv, -INV_BIG).amax(dim=-1))

    return (mm(ox), mm(oy), mm(oz)), (inv_mm(dx), inv_mm(dy), inv_mm(dz))


def _axis_interval(lo_a, hi_a, ob, ib):
    """Conservative [min t_near, max t_far] for one axis over the whole
    packet; a non-uniform direction sign leaves the axis unbounded."""
    where, mn, mx, neg, pos_big = _ops(lo_a)
    ol, oh = ob
    il, ih = ib
    uniform = il * ih > 0.0
    pos = il > 0.0
    nearb = where(pos, lo_a, hi_a)
    farb = where(pos, hi_a, lo_a)

    def prods(b):
        c1 = (b - ol) * il
        c2 = (b - ol) * ih
        c3 = (b - oh) * il
        c4 = (b - oh) * ih
        return mn(mn(c1, c2), mn(c3, c4)), mx(mx(c1, c2), mx(c3, c4))

    near_min, _ = prods(nearb)
    _, far_max = prods(farb)
    return where(uniform, near_min, neg), where(uniform, far_max, pos_big)


def _box_interval(lo_xyz, hi_xyz, obnd, ibnd):
    """Packet-conservative [t_enter, t_exit] of AABBs given the per-axis
    packet bounds (lo_xyz / hi_xyz: 3 scalars or arrays each)."""
    _, mn, mx, _, _ = _ops(lo_xyz[0])
    ivs = [_axis_interval(lo_xyz[a], hi_xyz[a], obnd[a], ibnd[a])
           for a in range(3)]
    return (mx(mx(ivs[0][0], ivs[1][0]), ivs[2][0]),
            mn(mn(ivs[0][1], ivs[1][1]), ivs[2][1]))


def _axinfo(obnd, ibnd):
    """Per-axis packet constants for split-plane intervals: (inv_lo,
    inv_hi, orig_lo, orig_hi, sign-uniform, near-is-lo)."""
    return [(ibnd[a][0], ibnd[a][1], obnd[a][0], obnd[a][1],
             ibnd[a][0] * ibnd[a][1] > 0.0, ibnd[a][0] + ibnd[a][1] > 0.0)
            for a in range(3)]


def _split_plane_interval(axinfo, axis, split):
    """Packet-conservative [t_min, t_max] of the crossing of one axis
    plane, and whether the low child is the near child. A non-uniform
    direction sign leaves the plane unbounded."""
    where, mn, mx, neg, pos_big = _ops(split)
    il, ih, ol, oh, uni, nlo = axinfo[axis]
    c1 = (split - ol) * il
    c2 = (split - ol) * ih
    c3 = (split - oh) * il
    c4 = (split - oh) * ih
    tp_min = where(uni, mn(mn(c1, c2), mn(c3, c4)), neg)
    tp_max = where(uni, mx(mx(c1, c2), mx(c3, c4)), pos_big)
    return tp_min, tp_max, nlo


# ---------------------------------------------------------------------------
# pixel-block layouts, frustum planes and the strip prepass
# ---------------------------------------------------------------------------


def _frustum_rows(dir_b: torch.Tensor, origin: torch.Tensor, tile: int,
                  th: int, tw: int) -> torch.Tensor:
    """Per-tile pinhole frustum planes: [n_tiles, 16] f32 rows of 4 unit
    outward plane normals (12), the shared origin (3) and a pad (1).

    A tile's lanes are a th x tw pixel block in row-major order, so its
    corner rays are lanes (0, tw-1, (th-1)*tw, tile-1). Degenerate edges
    (zero cross) give a zero normal, which never culls."""
    nt = dir_b.shape[0] // tile
    d2 = dir_b.reshape(nt, tile, 3)
    c = d2[:, [0, tw - 1, (th - 1) * tw, tile - 1], :]           # [nt, 4, 3]
    ns = []
    for a, b in ((0, 1), (1, 3), (3, 2), (2, 0)):
        o0, o1 = (i for i in range(4) if i not in (a, b))
        n = vm.cross(c[:, a], c[:, b])
        s = vm.dot(n, c[:, o0] + c[:, o1])[:, None]
        n = torch.where(s > 0.0, -n, n)          # interior dirs: n . d <= 0
        nn = vm.length(n)[:, None]
        ns.append(torch.where(nn > 1e-20, n / torch.clamp(nn, min=1e-30),
                              0.0))
    o = origin.reshape(1, 3).to(torch.float32).expand(nt, 3)
    return torch.cat(ns + [o, torch.zeros((nt, 1), dtype=torch.float32,
                                          device=dir_b.device)], dim=1)


def _blockify(x: torch.Tensor, h: int, w: int, th: int,
              tw: int) -> torch.Tensor:
    """Row-major [h*w, ...] -> tile-major: each (th, tw) pixel block is
    contiguous, its lanes in row-major order."""
    tail = x.shape[1:]
    x = x.reshape(h // th, th, w // tw, tw, *tail)
    return x.transpose(1, 2).reshape(h * w, *tail)


def _unblockify(x: torch.Tensor, h: int, w: int, th: int,
                tw: int) -> torch.Tensor:
    tail = x.shape[1:]
    x = x.reshape(h // th, w // tw, th, tw, *tail)
    return x.transpose(1, 2).reshape(h * w, *tail)


def _blockify_strips(x, h, w, th, tw, bh=8, bw=16):
    """Row-major [h*w, ...] -> tile-major with each (th, tw) tile's lanes
    grouped into (bh, bw)-pixel strips: tile (ti, tj) holds its
    (th//bh) x (tw//bw) grid of strips consecutively, each strip
    row-major. Every aligned bh*bw-lane group of a tile is then a compact
    pixel block with its own tight direction cone."""
    tail = x.shape[1:]
    gh, gw = th // bh, tw // bw
    x = x.reshape(h // th, gh, bh, w // tw, gw, bw, *tail)
    x = x.permute(0, 3, 1, 4, 2, 5, *range(6, 6 + len(tail)))
    return x.reshape(h * w, *tail)


def _unblockify_strips(x, h, w, th, tw, bh=8, bw=16):
    tail = x.shape[1:]
    gh, gw = th // bh, tw // bw
    x = x.reshape(h // th, w // tw, gh, gw, bh, bw, *tail)
    x = x.permute(0, 2, 4, 1, 3, 5, *range(6, 6 + len(tail)))
    return x.reshape(h * w, *tail)


def _strip_masks(chunk_bnd, dir_bs, origin, n_strips, bh=8, bw=16):
    """The strip prepass of K3's strips mode, as torch ops on the
    tensors' device: per tile, a window bitmask [n_tiles, W] i32 (bit s:
    strip s of the tile must test window w) and the conservative entry
    distance [n_tiles, W] f32 (least t_enter over the keeping strips, BIG
    when none keeps).

    Every (strip, window) pair gets the slab test over the strip's
    direction range from the shared origin and the exact 4-plane corner
    frustum with a relative slack (clpathtracer_tpu/ops/packet.py::
    _strip_masks, its order of operations). A window is kept on any doubt,
    so the hits equal an unculled walk's. chunk_bnd: [W, 6]; dir_bs:
    [N, 3] in strip order (_blockify_strips); origin [3]. Dead lanes are
    not handled: callers use it on fully active frames."""
    lanes = bh * bw
    lo = [chunk_bnd[None, :, j] for j in range(3)]                 # [1, W]
    hi = [chunk_bnd[None, :, 3 + j] for j in range(3)]
    o = origin.reshape(3).to(torch.float32)
    d = dir_bs.reshape(-1, lanes, 3)                               # [S, L, 3]
    n_s = d.shape[0]
    t_en = torch.full((n_s, 1), -INV_BIG, device=d.device)
    t_ex = torch.full((n_s, 1), INV_BIG, device=d.device)
    for ax in range(3):
        inv = torch.clamp(1.0 / d[:, :, ax], -INV_BIG, INV_BIG)
        il = inv.amin(dim=1, keepdim=True)                         # [S, 1]
        ih = inv.amax(dim=1, keepdim=True)
        uniform = il * ih > 0.0
        pos = il > 0.0
        nearb = torch.where(pos, lo[ax], hi[ax])                   # [S, W]
        farb = torch.where(pos, hi[ax], lo[ax])
        near_min = torch.minimum((nearb - o[ax]) * il, (nearb - o[ax]) * ih)
        far_max = torch.maximum((farb - o[ax]) * il, (farb - o[ax]) * ih)
        t_en = torch.maximum(t_en, torch.where(uniform, near_min, -INV_BIG))
        t_ex = torch.minimum(t_ex, torch.where(uniform, far_max, INV_BIG))
    keep = (t_en <= t_ex) & (t_ex > 0.0)                           # [S, W]

    fr = _frustum_rows(dir_bs, o, lanes, bh, bw)                   # [S, 16]
    for p in range(4):
        n = [fr[:, 3 * p + j:3 * p + j + 1] for j in range(3)]     # [S, 1]
        sup = torch.zeros_like(t_en)
        slack = torch.zeros_like(t_en)
        for ax in range(3):
            c = torch.where(n[ax] > 0.0, lo[ax], hi[ax]) - o[ax]
            sup = sup + n[ax] * c
            slack = slack + torch.abs(c)
        keep = keep & (sup <= 1e-5 * slack)

    n_tiles = n_s // n_strips
    bits = keep.reshape(n_tiles, n_strips, -1).to(torch.int32)
    shifts = torch.arange(n_strips, dtype=torch.int32, device=d.device)
    mask = (bits << shifts[None, :, None]).sum(dim=1, dtype=torch.int32)
    ten = torch.where(keep, t_en, BIG).reshape(n_tiles, n_strips, -1)
    return mask.contiguous(), ten.amin(dim=1).contiguous()


# ---------------------------------------------------------------------------
# node tables
# ---------------------------------------------------------------------------


def require_quad_tree(tree, name):
    """Raise ValueError for a tree whose leaves are not padded to blocks
    of 4 records: the packet engines read the quad-unit layout (lane 10 of
    the node table) and its window tables. Such a tree (build_kd_tree's
    tri_block != 4) takes the rope walk, ops/traverse.py::traverse."""
    if getattr(tree, "tri_block", 4) != 4:
        raise ValueError(f"{name}: a tri_block={tree.tri_block} tree; the "
                         "packet engines read tri_block 4 trees only (walk "
                         "it with ops/traverse.py::traverse)")


def stream_nodes(tree):
    """K3's node tables from the packed node table, on its device
    (clpathtracer_tpu/ops/packet.py::_smem_nodes without the TPU's bit
    packing): nodes_i [M, 4] i32 = (flags, child_lo, child_hi, 0) for a
    split and (flags, first record row r0, first window win0, window
    count) for a leaf, flags = axis + 4*is_leaf; nodes_f [6 + M] f32 = the
    root AABB, then each node's split value."""
    require_quad_tree(tree, "stream_nodes")
    nt = tree.node_table
    flags = nt[:, 7].to(torch.int32)
    is_leaf = flags >= 4
    cl = nt[:, 8].to(torch.int32)
    ch = nt[:, 9].to(torch.int32)
    qs = nt[:, 10].to(torch.int32)
    cnt = nt[:, 11].to(torch.int32)
    first = qs * 4
    r0 = first // 8
    r_end = (first + cnt + 7) // 8
    nwin = torch.where(cnt > 0, (r_end - r0 + CHUNK_ROWS - 1) // CHUNK_ROWS,
                       0)
    win0 = (tree.chunk_start.to(torch.int32) if tree.chunk_start is not None
            else torch.zeros_like(flags))
    nodes_i = torch.stack([flags, torch.where(is_leaf, r0, cl),
                           torch.where(is_leaf, win0, ch),
                           torch.where(is_leaf, nwin, 0)], dim=1)
    nodes_f = torch.cat([nt[0, 0:6], nt[:, 6]])
    return nodes_i.contiguous(), nodes_f.contiguous()


# ---------------------------------------------------------------------------
# kernel K3 and its plain version
# ---------------------------------------------------------------------------


def _kernel_mode(cbnd, frustum, masks):
    if masks is not None:
        return _STRIPS
    if cbnd is None:
        return _NO_CULL
    return _CULL_FRUSTUM if frustum is not None else _CULL


def _walk_takes(tile: int) -> bool:
    """Whether the kd walk wrappers take `tile` rays a tile: a multiple of
    32 up to 4096 and of 512 above 512. K5 (ops/csrc/packet_queue.cu), K6a,
    K6b and K9 (ops/csrc/packet_v1.cu), K7 (ops/csrc/packet_stream2.cu) and
    K8 (ops/csrc/packet_mxu.cu) launch every such tile; which of them run
    on a cluster is the kernel's choice (packet_queue_shape,
    packet_v1_shape, packet_stream2_shape, packet_mxu_shape)."""
    return 0 < tile <= 4096 and tile % 32 == 0 and (tile <= 512
                                                   or tile % 512 == 0)


def _check_stream_args(nodes_i, nodes_f, rows, orig_t, dir_t, act, tile,
                       cbnd, frustum, masks, ten, n_strips,
                       name="packet_stream"):
    tensors = dict(nodes_i=nodes_i, nodes_f=nodes_f, rows=rows,
                   orig_t=orig_t, dir_t=dir_t, act=act, cbnd=cbnd,
                   frustum=frustum, masks=masks, ten=ten)
    tensors = {k: v for k, v in tensors.items() if v is not None}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for arg, t in tensors.items():
        want = torch.int32 if arg in ("nodes_i", "masks") else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {want} "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    n = act.shape[0]
    m = nodes_i.shape[0]
    if not _walk_takes(tile) or n % tile:
        raise ValueError(f"{name}: tile {tile} must be a multiple of 32 "
                         "that divides the rays, at most 4096, and a "
                         f"multiple of 512 above 512 ({n} rays)")
    if nodes_i.shape != (m, 4) or nodes_f.shape != (6 + m,):
        raise ValueError(f"{name}: nodes_i {tuple(nodes_i.shape)} / nodes_f "
                         f"{tuple(nodes_f.shape)} are not [M, 4] / [6 + M]")
    if rows is not None and (rows.dim() != 2 or rows.shape[1] != 16
                             or rows.shape[0] % 8
                             or rows.shape[0] < _WIN_RECS):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} is not [T, 16] "
                         f"with T a multiple of 8 and at least {_WIN_RECS}"
                         " (pad_records)")
    if orig_t.shape != (3, n) or dir_t.shape != (3, n) or act.dim() != 1:
        raise ValueError(f"{name}: orig_t {tuple(orig_t.shape)} / dir_t "
                         f"{tuple(dir_t.shape)} / act {tuple(act.shape)} "
                         "do not match")
    n_tiles = n // tile
    if masks is not None:
        w = masks.shape[1] if masks.dim() == 2 else -1
        if masks.shape != (n_tiles, w) or ten is None \
                or ten.shape != masks.shape or not 1 <= n_strips <= 31 \
                or tile % n_strips:
            raise ValueError(f"{name}: masks / ten / n_strips do not "
                             f"match {n_tiles} tiles")
    elif cbnd is not None:
        if cbnd.dim() != 2 or cbnd.shape[1] != 6:
            raise ValueError(f"{name}: cbnd {tuple(cbnd.shape)} is not "
                             "[W, 6]")
        if frustum is not None and frustum.shape != (n_tiles, 16):
            raise ValueError(f"{name}: frustum {tuple(frustum.shape)} is "
                             f"not [{n_tiles}, 16]")
    elif frustum is not None:
        raise ValueError(f"{name}: the frustum cull needs cbnd")


def _check_precision(precision, so=False, frustum=None, masks=None):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    if precision == "bf16" and (so or frustum is not None
                                or masks is not None):
        raise ValueError("the bf16 preview (K4) takes MT records with the "
                         "AABB cull or none: no SO rows, frustum or strips")


def _launch_walk(entry, tile, n, inputs, ints):
    """Launch a walk kernel's C entry (ops/_cuda.py::SIGNATURES) on the
    current stream of the inputs' device: the inputs' pointers (None for
    an absent table), the outputs' (best_t [n] f32, best_slot [n] i32,
    stats [n / tile, 5] i32, then a zeroed i32 flag the kernel sets when
    its stack overflows), the ints, the stream. Returns the outputs;
    raises when the launch fails or (_check_overflow) the flag is set."""
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    fn = load_kernels().fns[entry]
    device = inputs[0].device
    out = (torch.empty((n,), dtype=torch.float32, device=device),
           torch.empty((n,), dtype=torch.int32, device=device),
           torch.empty((n // tile, 5), dtype=torch.int32, device=device))
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in inputs),
                 *(t.data_ptr() for t in (*out, flag)), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err} (N={n}, "
                           f"tile={tile}, arguments {ints})")
    _check_overflow(entry, flag, n, tile)
    return out


def _check_overflow(entry, flag, n, tile):
    """Raise when a walk kernel set its overflow flag. Reading the flag
    waits for the kernel: one host synchronisation per launch."""
    if int(flag.item()):
        raise RuntimeError(f"{entry}: the walk's stack of {STACK_DEPTH} "
                           f"entries overflowed (N={n}, tile={tile})")


def packet_stream(nodes_i, nodes_f, rows, orig_t, dir_t, act, *, tile: int,
                  so: bool, cbnd=None, frustum=None, masks=None, ten=None,
                  n_strips: int = 0, precision: str = "f32"):
    """Nearest hit of every ray of every packet tile through the kd-tree
    (K3; replaces clpathtracer_tpu/ops/packet.py::_kernel_stream_smem;
    with precision="bf16" K4, the bf16 preview of _kernel_stream).

    nodes_i / nodes_f: stream_nodes; rows: [T, 16] padded records
    (pad_records: SO rows when `so`, else raw (v0, e1, e2, tri_id));
    orig_t / dir_t: [3, N] tile-major rays; act: [N] f32, > 0 for an
    active lane (dead lanes take no hits and leave the packet bounds; a
    tile without an active lane does no walk). The window cull is the
    strip masks (masks / ten [n_tiles, W] from _strip_masks, n_strips
    strips per tile; when every strip is a 512-lane gate the dense test
    of a window runs per gate whose bit is set), else the AABBs cbnd
    [W, 6] with optional frustum rows [n_tiles, 16] (_frustum_rows), else
    none.

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [n_tiles, 5] i32 = node pops, windows streamed, active lanes, windows
    culled, dense executions; 0 in the bf16 preview, as the TPU kernel
    writes it). Ties: see ops/csrc/packet_stream.cu.

    precision="bf16": the dense test in bf16 (mt_pairs with
    dtype=torch.bfloat16) on MT records with the AABB cull or none; the
    walk stays f32.

    A CPU tensor runs the plain version (packet_stream_reference); a CUDA
    tensor launches ops/csrc/packet_stream.cu on the current stream or
    raises, also when the walk's stack overflows. `packet_stream.launches`
    counts K3's launches and `packet_stream.bf16_launches` K4's."""
    _check_stream_args(nodes_i, nodes_f, rows, orig_t, dir_t, act, tile,
                       cbnd, frustum, masks, ten, n_strips)
    _check_precision(precision, so, frustum, masks)
    device = act.device
    if device.type == "cpu":
        return packet_stream_reference(
            nodes_i, nodes_f, rows, orig_t, dir_t, act, tile=tile, so=so,
            cbnd=cbnd, frustum=frustum, masks=masks, ten=ten,
            n_strips=n_strips, precision=precision)
    if device.type != "cuda":
        raise ValueError(f"packet_stream: no kernel for device {device}")
    out = _launch_walk(
        "packet_stream_launch", tile, act.shape[0],
        (nodes_i, nodes_f, rows, orig_t, dir_t, act, cbnd, frustum, masks,
         ten),
        (act.shape[0], tile, rows.shape[0] // 8,
         masks.shape[1] if masks is not None else 0,
         _kernel_mode(cbnd, frustum, masks),
         n_strips if masks is not None else 0, int(so),
         int(precision == "bf16")))
    if precision == "bf16":
        packet_stream.bf16_launches += 1
    else:
        packet_stream.launches += 1
    return out


packet_stream.launches = 0
packet_stream.bf16_launches = 0


def packet_stream_reference(nodes_i, nodes_f, rows, orig_t, dir_t, act, *,
                            tile: int, so: bool, cbnd=None, frustum=None,
                            masks=None, ten=None, n_strips: int = 0,
                            precision: str = "f32", tally=None):
    """Plain torch version of packet_stream: same signature, same outputs,
    stats included, on any device.

    The walk runs per tile on the host in numpy float32 scalars (the
    kernel's f32 arithmetic), a leaf's window decisions as numpy arrays;
    the kept windows' dense tests run on the tensors' device as torch ops,
    several windows at a time (within a leaf nothing the decisions read
    changes). tally: see mt_pairs (MT form only)."""
    _check_precision(precision, so, frustum, masks)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    n = act.shape[0]
    n_tiles = n // tile
    dev = act.device
    mode = _kernel_mode(cbnd, frustum, masks)
    half = mode == _STRIPS and tile // n_strips == GATE_LANES
    host = {"ni": nodes_i.cpu().numpy(), "nf": nodes_f.cpu().numpy(),
            "cb": None if cbnd is None else cbnd.cpu().numpy(),
            "fr": None if frustum is None else frustum.cpu().numpy(),
            "mk": None if masks is None else masks.cpu().numpy(),
            "tn": None if ten is None else ten.cpu().numpy()}

    recs = rows[:, :10]

    def walk(ti, ob, ib, n_act, tile_rays, on):
        bt, bs, st = _walk_tile(host, ti, ob, ib, n_act, recs, tile_rays, on,
                                so, mode, half, n_strips, rows.shape[0] // 8,
                                tally, dtype)
        return bt, bs, st[:4] + ((0,) if precision == "bf16" else st[4:])
    return _per_tile(walk, orig_t, dir_t, act, tile)


def _guard(stack):
    """The walks' stack guard: a split whose two pushes could pass
    STACK_DEPTH entries raises, as the kernels' overflow flag makes their
    wrappers do."""
    if len(stack) + 2 > STACK_DEPTH:
        raise RuntimeError(f"packet walk: the stack of {STACK_DEPTH} "
                           "entries overflowed")


def _per_tile(walk, orig_t, dir_t, act, tile):
    """The plain kernels' frame: the packet bounds of every tile, then
    walk(tile index, origin bounds, inverse-direction bounds, active
    lanes, the tile's 6 ray rows, its active mask) -> (best_t, best_slot,
    stats) per tile, gathered as the kernels return them."""
    n = act.shape[0]
    n_tiles = n // tile
    dev = act.device
    rays = [orig_t[i].reshape(n_tiles, tile) for i in range(3)] \
        + [dir_t[i].reshape(n_tiles, tile) for i in range(3)]
    act_t = act.reshape(n_tiles, tile)
    obnd, ibnd = _packet_bounds_masked(rays, act_t)
    obnd = [[b.cpu().numpy() for b in ax] for ax in obnd]
    ibnd = [[b.cpu().numpy() for b in ax] for ax in ibnd]
    n_act = (act_t > 0.0).sum(dim=1).cpu().numpy()
    best_t = torch.full((n_tiles, tile), BIG, dtype=torch.float32,
                        device=dev)
    best_slot = torch.full((n_tiles, tile), -1, dtype=torch.int32,
                           device=dev)
    stats = np.zeros((n_tiles, 5), np.int64)
    for ti in np.flatnonzero(n_act):   # a tile without active lanes: no walk
        ob = [(ax[0][ti], ax[1][ti]) for ax in obnd]
        ib = [(ax[0][ti], ax[1][ti]) for ax in ibnd]
        bt, bs, st = walk(ti, ob, ib, int(n_act[ti]),
                          [r[ti] for r in rays], act_t[ti] > 0.0)
        best_t[ti] = bt
        best_slot[ti] = torch.where(bt < BIG, bs, -1)
        stats[ti] = st
    return (best_t.reshape(-1), best_slot.reshape(-1),
            torch.as_tensor(stats.astype(np.int32), device=dev))


def _walk_tile(host, ti, ob, ib, n_act, recs, rays, on, so, mode, half,
               n_strips, n_rows, tally, dtype=torch.float32):
    """One tile of the plain K3: (best_t [L], best_slot [L], stats [5])."""
    f32 = np.float32
    ni, nf = host["ni"], host["nf"]
    tile = on.shape[0]
    dev = on.device
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    axinfo = _axinfo(ob, ib)
    rt_lo, rt_hi = _box_interval(nf[0:3], nf[3:6], ob, ib)
    stack = ([(0, rt_lo, rt_hi)]
             if rt_lo <= rt_hi and rt_hi > 0.0 and n_act > 0 else [])
    t_upper = f32(BIG)
    nv = nl = nc = nsm = 0
    gate_of_lane = torch.arange(tile, device=dev) // GATE_LANES
    while stack:
        node, tlo, thi = stack.pop()
        nv += 1
        if not (tlo <= np.minimum(thi, t_upper) and thi > 0.0):
            continue
        flags, a, b, c = (int(x) for x in ni[node])
        if flags >= 4:
            kept = _leaf_windows(host, ti, b, c, ob, ib, tlo, thi, t_upper,
                                 mode)
            nl += kept.shape[0]
            if mode != _NO_CULL:
                nc += c - kept.shape[0]
            if half:
                gates = host["mk"][ti, b + kept].astype(np.int64)
                nsm += sum(int(((gates >> g) & 1).sum())
                           for g in range(n_strips))
                lane_on = ((torch.as_tensor(gates, device=dev)[:, None]
                            >> gate_of_lane[None, :]) & 1).bool() & on
            else:
                nsm += kept.shape[0]
                lane_on = on.expand(kept.shape[0], tile)
            row0 = np.minimum(a + kept * CHUNK_ROWS, n_rows - CHUNK_ROWS)
            bt, bs = _dense_windows(recs, row0, rays, lane_on, so, bt, bs,
                                    tally, dtype)
            if (nv & TUP_MASK) == 0:
                t_upper = f32(torch.where(on, bt, -BIG).amax().item())
        else:
            _push_children(stack, axinfo, nf, node, flags, a, b, tlo, thi,
                           t_upper)
    return bt, bs, (nv, nl, n_act, nc, nsm)


def _push_children(stack, axinfo, nf, node, flags, a, b, tlo, thi, t_upper):
    """A split's live children onto the walk's stack, far child first."""
    tp_min, tp_max, nlo = _split_plane_interval(axinfo, flags & 3,
                                                nf[6 + node])
    near, far = (a, b) if nlo else (b, a)
    far_lo = np.maximum(tlo, tp_min)
    near_hi = np.minimum(thi, tp_max)
    _guard(stack)
    if far_lo <= np.minimum(thi, t_upper):
        stack.append((far, far_lo, thi))
    if tlo <= np.minimum(near_hi, t_upper):
        stack.append((near, tlo, near_hi))


def _leaf_windows(host, ti, win0, nwin, ob, ib, tlo, thi, t_upper, mode):
    """The leaf's windows the tile streams, in order ([K] int64 indices
    into the leaf's windows)."""
    w = np.arange(nwin)
    if mode == _NO_CULL or nwin == 0:
        return w
    tup = np.minimum(thi, t_upper)
    if mode == _STRIPS:
        keep = ((host["mk"][ti, win0 + w] != 0)
                & (host["tn"][ti, win0 + w] <= tup))
        return w[keep]
    cb = host["cb"][win0 + w]                                      # [K, 6]
    lo = [cb[:, j] for j in range(3)]
    hi = [cb[:, 3 + j] for j in range(3)]
    t_en, t_ex = _box_interval(lo, hi, ob, ib)
    keep = (t_en <= tup) & (t_ex >= tlo) & (t_ex > 0.0)
    if mode == _CULL_FRUSTUM:
        fr = host["fr"][ti]
        for p in range(4):
            c = [np.where(fr[3 * p + j] > 0.0, lo[j], hi[j]) - fr[12 + j]
                 for j in range(3)]
            sup = fr[3 * p] * c[0] + fr[3 * p + 1] * c[1] \
                + fr[3 * p + 2] * c[2]
            slack = np.float32(1e-5) * (np.abs(c[0]) + np.abs(c[1])
                                        + np.abs(c[2]))
            keep = keep & (sup <= slack)
    return w[keep]


def _dense_windows(recs, row0, rays, lane_on, so, bt, bs, tally,
                   dtype=torch.float32):
    """Dense test of windows (first record rows row0 [K], in stream
    order) against a tile's rays, merged into (bt, bs) with the kernel's
    tie rule. lane_on: [K, L] bool, the lanes each window tests; dtype:
    the MT test's (mt_pairs)."""
    k_all = row0.shape[0]
    if k_all == 0:
        return bt, bs
    tile = bt.shape[0]
    dev = bt.device
    ox, oy, oz, dx, dy, dz = (r[None, None, :] for r in rays)
    rec_in_win = torch.arange(_WIN_RECS, device=dev)
    row_ids = torch.arange(CHUNK_ROWS, device=dev)
    in_row = torch.arange(8, device=dev)
    step = max(1, _REF_PAIRS // (_WIN_RECS * tile))
    for k0 in range(0, k_all, step):
        rec0 = torch.as_tensor(row0[k0:k0 + step] * 8, device=dev)   # [K]
        k = rec0.shape[0]
        r = recs[rec0[:, None] + rec_in_win][:, :, None, :]   # [K, 128, 1, 10]
        tested = lane_on[k0:k0 + k][:, None, :]                # [K, 1, L]
        if so:
            ok, t = so_pairs(r, dx, dy, dz)
        else:
            ok, t = mt_pairs(r, ox, oy, oz, dx, dy, dz, tally, tested,
                             dtype)
        t = torch.where(ok & tested, t, BIG).reshape(k, CHUNK_ROWS, 8, tile)
        # per row of 8: least t, the row's last record among equal t
        t_row = t.amin(dim=2)                                  # [K, 16, L]
        i_row = torch.where(t == t_row[:, :, None], in_row[:, None],
                            -1).amax(dim=2)
        s_row = rec0[:, None, None] + row_ids[:, None] * 8 + i_row
        # per window: least t, the lowest row among equal t
        ct = t_row.amin(dim=1)                                 # [K, L]
        cs = torch.where(t_row == ct[:, None], s_row, _INT_MAX).amin(dim=1)
        # across windows in order: the later window wins at equal t
        m = ct.amin(dim=0)                                     # [L]
        last = torch.where(ct == m, torch.arange(k, device=dev)[:, None],
                           -1).amax(dim=0)
        s_m = cs.gather(0, last[None]).squeeze(0).to(torch.int32)
        take = (m < BIG) & (m <= bt)
        bt = torch.where(take, m, bt)
        bs = torch.where(take, s_m, bs)
    return bt, bs


# ---------------------------------------------------------------------------
# kernel K5 and its plain version
# ---------------------------------------------------------------------------


def packet_queue(nodes_i, nodes_f, rows, orig_t, dir_t, act, *, tile: int,
                 so: bool, cbnd=None):
    """Nearest hit of every ray of every packet tile through the kd-tree
    with the walk decoupled from the dense test by a ring of QUEUE_DEPTH
    window copies in flight (K5; replaces clpathtracer_tpu/ops/packet.py::
    _kernel_queue and _kernel_queue_smem).

    Arguments as packet_stream's, with the AABB cull cbnd [W, 6] or none;
    always f32. Returns (best_t [N] f32, best_slot [N] i32 with -1 on a
    miss, stats [n_tiles, 5] i32 = node pops, windows tested, active
    lanes, windows culled at the cursor or skipped at the drain, 0). The
    schedule: see ops/csrc/packet_queue.cu.

    A CPU tensor runs the plain version (packet_queue_reference); a CUDA
    tensor launches ops/csrc/packet_queue.cu on the current stream (on a
    cluster of 8 blocks a tile of 256k rays, 2 threads a lane, each block
    with its own ring of QUEUE_DEPTH windows) or raises, also when the
    walk's stack overflows or the card refuses the launch.
    `packet_queue.launches` counts kernel launches."""
    _check_stream_args(nodes_i, nodes_f, rows, orig_t, dir_t, act, tile,
                       cbnd, None, None, None, 0, name="packet_queue")
    device = act.device
    if device.type == "cpu":
        return packet_queue_reference(nodes_i, nodes_f, rows, orig_t, dir_t,
                                      act, tile=tile, so=so, cbnd=cbnd)
    if device.type != "cuda":
        raise ValueError(f"packet_queue: no kernel for device {device}")
    out = _launch_walk(
        "packet_queue_launch", tile, act.shape[0],
        (nodes_i, nodes_f, rows, orig_t, dir_t, act, cbnd),
        (act.shape[0], tile, rows.shape[0] // 8, int(so)))
    packet_queue.launches += 1
    return out


packet_queue.launches = 0


def packet_queue_reference(nodes_i, nodes_f, rows, orig_t, dir_t, act, *,
                           tile: int, so: bool, cbnd=None, tally=None):
    """Plain torch version of packet_queue: same signature, same outputs,
    stats included, on any device.

    Each tile's walk and ring schedule replay on the host in numpy float32
    scalars (_queue_tile); a drain's dense tests run as one batch of torch
    ops on the tensors' device (t_upper is fixed within a drain). tally:
    see mt_pairs (MT form only)."""
    host = {"ni": nodes_i.cpu().numpy(), "nf": nodes_f.cpu().numpy(),
            "cb": None if cbnd is None else cbnd.cpu().numpy()}
    recs = rows[:, :10]

    def walk(ti, ob, ib, n_act, tile_rays, on):
        return _queue_tile(host, ob, ib, n_act, recs, tile_rays, on, so,
                           rows.shape[0] // 8, tally)
    return _per_tile(walk, orig_t, dir_t, act, tile)


def _queue_tile(host, ob, ib, n_act, recs, rays, on, so, n_rows, tally):
    """One tile of the plain K5: (best_t [L], best_slot [L], stats [5]).

    The ring holds (first row, t_enter, t_exit, leaf t_lo, leaf t_hi) of
    each window in flight, oldest first; a window's box interval is
    computed once, when its leaf opens (t_enter = -INV_BIG, t_exit =
    INV_BIG without window tables, where only the leaf interval is
    re-checked at the drain)."""
    f32 = np.float32
    ni, nf, cb = host["ni"], host["nf"], host["cb"]
    tile = on.shape[0]
    dev = on.device
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    axinfo = _axinfo(ob, ib)
    rt_lo, rt_hi = _box_interval(nf[0:3], nf[3:6], ob, ib)
    stack = ([(0, rt_lo, rt_hi)]
             if rt_lo <= rt_hi and rt_hi > 0.0 and n_act > 0 else [])
    t_upper = f32(BIG)
    ring = []
    wcur = wend = lrow0 = 0
    ltlo, lthi = f32(0.0), f32(BIG)
    t_en = t_ex = None        # the open leaf's windows' box intervals
    nv = nl = nc = 0

    def keeps(en, ex, lo, hi):
        return en <= np.minimum(hi, t_upper) and ex >= lo and ex > 0.0
    while stack or wcur < wend or ring:
        # produce: until the ring is full or the walk is exhausted
        while len(ring) < QUEUE_DEPTH and (wcur < wend or stack):
            if wcur < wend:
                w = wcur
                if cb is not None:
                    while w < wend and not keeps(t_en[w], t_ex[w], ltlo,
                                                 lthi):
                        w += 1
                nc += w - wcur
                if w < wend:
                    ring.append((min(lrow0 + w * CHUNK_ROWS,
                                     n_rows - CHUNK_ROWS),
                                 t_en[w], t_ex[w], ltlo, lthi))
                wcur = w + 1
                continue
            node, tlo, thi = stack.pop()
            nv += 1
            if not (tlo <= np.minimum(thi, t_upper) and thi > 0.0):
                continue
            flags, a, b, c = (int(x) for x in ni[node])
            if flags < 4:
                _push_children(stack, axinfo, nf, node, flags, a, b, tlo,
                               thi, t_upper)
                continue
            wcur, wend, lrow0, ltlo, lthi = 0, c, a, tlo, thi
            if cb is not None:
                box = cb[b:b + c]
                t_en, t_ex = _box_interval([box[:, j] for j in range(3)],
                                           [box[:, 3 + j] for j in range(3)],
                                           ob, ib)
            else:
                t_en = np.full(c, -INV_BIG, np.float32)
                t_ex = np.full(c, INV_BIG, np.float32)
        # consume: all when the walk is exhausted, else keep half flying
        done = not (wcur < wend or stack)
        ndrain = (len(ring) if done
                  else max(len(ring) - QUEUE_DEPTH // 2, 1))
        batch, ring = ring[:ndrain], ring[ndrain:]
        if cb is not None:
            kept = [e[0] for e in batch if keeps(*e[1:])]
        else:
            kept = [e[0] for e in batch if e[3] <= np.minimum(e[4], t_upper)]
        nl += len(kept)
        nc += len(batch) - len(kept)
        bt, bs = _dense_windows(recs, np.asarray(kept, np.int64), rays,
                                on.expand(len(kept), tile), so, bt, bs,
                                tally)
        t_upper = f32(torch.where(on, bt, -BIG).amax().item())
    return bt, bs, (nv, nl, n_act, nc, 0)


# ---------------------------------------------------------------------------
# the v1 kernels K6a, K6b, K9 and their plain versions
# ---------------------------------------------------------------------------


def _check_v1_args(table, width, recs, orig_t, dir_t, tile, engine, name):
    padded = engine != _V1_RESIDENT   # K6b's and K9's windows: 128 rows
    tensors = dict(table=table, recs=recs, orig_t=orig_t, dir_t=dir_t)
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for arg, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"torch.float32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    n = orig_t.shape[1] if orig_t.dim() == 2 else -1
    if not _walk_takes(tile) or n % tile:
        raise ValueError(f"{name}: tile {tile} must be a multiple of 32 "
                         "that divides the rays, at most 4096, and a "
                         f"multiple of 512 above 512 ({n} rays)")
    if table.dim() != 2 or table.shape[1] != width or table.shape[0] == 0:
        raise ValueError(f"{name}: table {tuple(table.shape)} is not "
                         f"[M, {width}]")
    if recs.dim() != 2 or recs.shape[1] != 16 or (padded and (
            recs.shape[0] % 8 or recs.shape[0] < _WIN_RECS)):
        raise ValueError(f"{name}: recs {tuple(recs.shape)} is not [T, 16]"
                         + (f" with T a multiple of 8 and at least "
                            f"{_WIN_RECS} (pad_records)" if padded else ""))
    if orig_t.shape != (3, n) or dir_t.shape != (3, n):
        raise ValueError(f"{name}: orig_t {tuple(orig_t.shape)} / dir_t "
                         f"{tuple(dir_t.shape)} are not [3, N]")


def packet_legacy(table16, recs, orig_t, dir_t, *, tile: int,
                  resident: bool):
    """Nearest hit of every ray of every packet tile through the v1 walk
    of the kd-tree: K6a (resident=True; replaces clpathtracer_tpu/ops/
    packet.py::_kernel) or K6b (replaces _kernel_tri_stream).

    table16: [M, 16] f32, node_table[:, :16] (lo xyz, hi xyz, split,
    flags, child_lo, child_hi, quad start, triangle count); recs: [T, 16]
    records, as they are for K6a, pad_records for K6b; orig_t / dir_t:
    [3, N] tile-major rays. Every lane takes part: there is no active
    mask, as in the JAX package's legacy kernels.

    The walk: a stack of nodes from the root; a popped node is live when
    its box's packet interval (the bounds of all lanes) has t_enter <=
    t_exit, t_exit > 0 and t_enter <= t_upper; a live split pushes the
    far child, then the near one, ordered by the sign of the packet's
    inverse-direction sum on its axis; a live leaf is tested and t_upper
    becomes the largest best t over the tile's lanes. K6a tests the leaf's
    records in order, the later record winning at equal t; K6b streams
    the leaf's 128-record windows on the clamped grid of pad_records,
    none culled, with _mt_chunk_math's tie rule (see ops/csrc/
    packet_v1.cu).

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [n_tiles, 5] i32 = node pops, leaves tested (K6a) or windows streamed
    (K6b), 0, 0, 0).

    A CPU tensor runs the plain version (packet_legacy_reference); a CUDA
    tensor launches ops/csrc/packet_v1.cu on the current stream (K6a and
    K6b on a cluster of 8 blocks a tile of 256k rays, 2 threads a lane,
    the leaf's records staged in a 4-buffer cp.async ring: K6a's own
    records in chunks of 128, K6b's windows) or raises, also when the
    walk's stack overflows or the card refuses the launch; a tile that no
    launch takes raises ValueError on either device.
    `packet_legacy.resident_launches` counts K6a's launches and
    `packet_legacy.launches` K6b's."""
    name = "packet_legacy"
    engine = _V1_RESIDENT if resident else _V1_STREAM
    _check_v1_args(table16, 16, recs, orig_t, dir_t, tile, engine, name)
    device = orig_t.device
    if device.type == "cpu":
        return packet_legacy_reference(table16, recs, orig_t, dir_t,
                                       tile=tile, resident=resident)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    out = _launch_walk(
        "packet_v1_launch", tile, orig_t.shape[1],
        (table16, recs, orig_t, dir_t),
        (orig_t.shape[1], tile, recs.shape[0], engine))
    if resident:
        packet_legacy.resident_launches += 1
    else:
        packet_legacy.launches += 1
    return out


packet_legacy.launches = 0
packet_legacy.resident_launches = 0


def packet_wide(wide, recs, orig_t, dir_t, *, tile: int):
    """Nearest hit of every ray of every packet tile through the 8-wide
    supernode walk (K9; replaces clpathtracer_tpu/ops/packet.py::
    _kernel_wide).

    wide: [S, 128] f32 supernode rows (accel/wide.py::build_wide_table);
    recs: [T, 16] records padded by pad_records; orig_t / dir_t: [3, N]
    tile-major rays, every lane taking part. A popped supernode tests its
    8 child slots in order: a live internal child (the packet-interval
    test of packet_legacy) is pushed, a live leaf streams its windows as
    K6b does at once, so that its t_upper holds for the next slot.

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [n_tiles, 5] i32 = supernode pops, windows streamed, 0, 0, 0).

    A CPU tensor runs the plain version (packet_wide_reference); a CUDA
    tensor launches ops/csrc/packet_v1.cu on the current stream (on a
    cluster of 8 blocks a tile of 256k rays) or raises, also when the
    walk's stack overflows or the card refuses the launch.
    `packet_wide.launches` counts its launches."""
    name = "packet_wide"
    _check_v1_args(wide, 128, recs, orig_t, dir_t, tile, _V1_WIDE, name)
    device = orig_t.device
    if device.type == "cpu":
        return packet_wide_reference(wide, recs, orig_t, dir_t, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    out = _launch_walk(
        "packet_v1_launch", tile, orig_t.shape[1],
        (wide, recs, orig_t, dir_t),
        (orig_t.shape[1], tile, recs.shape[0], _V1_WIDE))
    packet_wide.launches += 1
    return out


packet_wide.launches = 0


def packet_legacy_reference(table16, recs, orig_t, dir_t, *, tile: int,
                            resident: bool, tally=None):
    """Plain torch version of packet_legacy: same signature, same outputs,
    stats included, on any device. The walk runs per tile on the host in
    numpy float32 scalars (the kernel's f32 arithmetic); a leaf's dense
    test runs on the tensors' device as torch ops. tally (optional int64
    [4] tensor): adds the pairs tested, then mt_pairs' three counts of the
    pairs that pass its early exits."""
    table = table16.cpu().numpy()
    n_rows = recs.shape[0] // 8
    recs10 = recs[:, :10]

    def walk(ti, ob, ib, n_act, rays, on):
        if resident:
            def leaf(qstart, count, bt, bs):
                return (*_resident_leaf(recs10, rays, qstart * 4, count, bt,
                                        bs, tally), 1)
        else:
            def leaf(qstart, count, bt, bs):
                return _stream_leaf(recs10, rays, on, qstart, count, n_rows,
                                    bt, bs, tally)
        return _binary_v1_walk(table, ob, ib, tile, on.device, leaf)
    return _per_tile(walk, orig_t, dir_t, _all_lanes(orig_t), tile)


def packet_wide_reference(wide, recs, orig_t, dir_t, *, tile: int,
                          tally=None):
    """Plain torch version of packet_wide: same signature, same outputs,
    stats included, on any device (as packet_legacy_reference, tally
    too)."""
    table = wide.cpu().numpy()
    n_rows = recs.shape[0] // 8
    recs10 = recs[:, :10]

    def walk(ti, ob, ib, n_act, rays, on):
        def leaf(qstart, count, bt, bs):
            return _stream_leaf(recs10, rays, on, qstart, count, n_rows, bt,
                                bs, tally)
        return _wide_v1_walk(table, ob, ib, tile, on.device, leaf)
    return _per_tile(walk, orig_t, dir_t, _all_lanes(orig_t), tile)


def _all_lanes(orig_t):
    """The v1 kernels' lanes: all of them (the packet bounds of every
    lane; no dead lane)."""
    return torch.ones((orig_t.shape[1],), dtype=torch.float32,
                      device=orig_t.device)


def _binary_v1_walk(table, ob, ib, tile, dev, leaf):
    """One tile of the plain K6a / K6b (clpathtracer_tpu/ops/packet.py::
    _binary_walk): (best_t [L], best_slot [L], stats [5]). leaf(quad
    start, count, bt, bs) -> (bt, bs, lane-1 count)."""
    f32 = np.float32
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    stack = [0]
    t_upper = f32(BIG)
    nv = nl = 0
    while stack:
        node = stack.pop()
        nv += 1
        f = table[node]
        t_en, t_ex = _box_interval(f[0:3], f[3:6], ob, ib)
        if not (t_en <= t_ex and t_ex > 0.0 and t_en <= t_upper):
            continue
        flags = int(f[7])
        if flags >= 4:
            bt, bs, k = leaf(int(f[10]), int(f[11]), bt, bs)
            nl += k
            t_upper = f32(bt.max().item())
            continue
        il, ih = ib[flags & 3]
        cl, ch = int(f[8]), int(f[9])
        _guard(stack)
        stack += [ch, cl] if il + ih > 0.0 else [cl, ch]   # near on top
    return bt, bs, (nv, nl, 0, 0, 0)


def _wide_v1_walk(table, ob, ib, tile, dev, leaf):
    """One tile of the plain K9 (clpathtracer_tpu/ops/packet.py::
    _kernel_wide): (best_t [L], best_slot [L], stats [5])."""
    f32 = np.float32
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    stack = [0]
    t_upper = f32(BIG)
    nv = nl = 0
    while stack:
        c = table[stack.pop()].reshape(8, 16)
        nv += 1
        # the 8 children's intervals; t_upper may fall between children
        t_en, t_ex = _box_interval([c[:, j] for j in range(3)],
                                   [c[:, 3 + j] for j in range(3)], ob, ib)
        for k in range(8):
            kind = c[k, 6]
            if not (t_en[k] <= t_ex[k] and t_ex[k] > 0.0
                    and t_en[k] <= t_upper and kind > 0.5):
                continue
            if kind < 1.5:
                if len(stack) + 1 > STACK_DEPTH:
                    raise RuntimeError(f"packet walk: the stack of "
                                       f"{STACK_DEPTH} entries overflowed")
                stack.append(int(c[k, 7]))
            else:
                bt, bs, n = leaf(int(c[k, 7]), int(c[k, 8]), bt, bs)
                nl += n
                t_upper = f32(bt.max().item())
    return bt, bs, (nv, nl, 0, 0, 0)


def _resident_leaf(recs, rays, first, count, bt, bs, tally=None):
    """K6a's leaf: the records [first, first + count) in order against
    the tile's rays, a record taken where it hits at t <= the best t so
    far, so the later record wins at equal t (in steps of at most
    _REF_PAIRS pairs, merged in order with the same rule)."""
    tile = bt.shape[0]
    ox, oy, oz, dx, dy, dz = (r[None, :] for r in rays)
    step = max(1, _REF_PAIRS // tile)
    for c0 in range(0, count, step):
        r = recs[first + c0:first + min(count, c0 + step)][:, None, :]
        if tally is not None:
            tally[0] += r.shape[0] * tile
        ok, t = mt_pairs(r, ox, oy, oz, dx, dy, dz,
                         None if tally is None else tally[1:])
        t = torch.where(ok, t, float("inf"))                   # [C, L]
        m = t.amin(dim=0)
        idx = torch.arange(r.shape[0], device=bt.device)[:, None]
        last = torch.where(ok & (t == m), idx, -1).amax(dim=0)
        take = m <= bt
        bt = torch.where(take, m, bt)
        bs = torch.where(take, (first + c0 + last).to(torch.int32), bs)
    return bt, bs


def _stream_leaf(recs, rays, on, qstart, count, n_rows, bt, bs, tally=None):
    """K6b's and K9's leaf (clpathtracer_tpu/ops/packet.py::
    _chunk_pipeline's stream_leaf): the windows of rows [first // 8,
    (first + count + 7) // 8) on the clamped grid, none culled, tested in
    order. Returns (bt, bs, windows)."""
    first = qstart * 4
    row0 = first // 8
    nch = ((first + count + 7) // 8 - row0 + CHUNK_ROWS - 1) // CHUNK_ROWS
    rows0 = np.minimum(row0 + np.arange(nch) * CHUNK_ROWS,
                       n_rows - CHUNK_ROWS)
    if tally is not None:
        tally[0] += nch * _WIN_RECS * bt.shape[0]
    bt, bs = _dense_windows(recs, rows0, rays, on.expand(nch, bt.shape[0]),
                            False, bt, bs,
                            None if tally is None else tally[1:])
    return bt, bs, nch


# ---------------------------------------------------------------------------
# kernel K7 and its plain version
# ---------------------------------------------------------------------------


def _leaf_span(tree):
    """(is_leaf, first record 4 * quad start, triangle count) per node of
    the packed node table, int32 [M] each."""
    require_quad_tree(tree, "packet walk")
    nt = tree.node_table
    return (nt[:, 7].to(torch.int32) >= 4, nt[:, 10].to(torch.int32) * 4,
            nt[:, 11].to(torch.int32))


def stream2_nodes(tree):
    """K7's node tables: stream_nodes' with a leaf's chunk count (column
    3) by the JAX kernel's row arithmetic (clpathtracer_tpu/ops/packet.py::
    _make_machine's leaf_case): ceil((ceil((first + count) / 8) - r0) /
    CHUNK_ROWS) for r0 = first // 8, so an empty leaf at an odd quad start
    gets one chunk where stream_nodes gives it no window. Column 1 of a
    leaf is r0, as in stream_nodes; column 2 is not read."""
    nodes_i, nodes_f = stream_nodes(tree)
    leaf, first, cnt = _leaf_span(tree)
    r0 = first // 8
    nch = ((first + cnt + 7) // 8 - r0 + CHUNK_ROWS - 1) // CHUNK_ROWS
    nodes_i = torch.cat([nodes_i[:, :3], torch.where(leaf, nch, 0)[:, None]],
                        dim=1)
    return nodes_i.contiguous(), nodes_f


def packet_stream2(nodes_i, nodes_f, rows, orig_t, dir_t, act, *,
                   tile: int):
    """Nearest hit of every ray of every packet tile through the kd-tree,
    each tile culled in halves (K7; replaces clpathtracer_tpu/ops/
    packet.py::_kernel_stream2).

    nodes_i / nodes_f: stream2_nodes; rows: [T, 16] raw records padded by
    pad_records; orig_t / dir_t: [3, N] tile-major rays; act: [N] f32, > 0
    for an active lane. K3's interval walk with an interval and a t_upper
    per half tile (lanes [0, tile/2) and [tile/2, tile)); a leaf's chunks
    run the dense MT test for the halves live at its pop; no window cull
    (see ops/csrc/packet_stream2.cu: a tile of 256k rays walks on a
    cluster of 8 blocks, 4 a half; packet_stream2_shape). tile: as
    _walk_takes. Always f32, MT form.

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [n_tiles, 5] i32 = node pops, chunks, active lanes, 0, 0).

    A CPU tensor runs the plain version (packet_stream2_reference); a CUDA
    tensor launches ops/csrc/packet_stream2.cu on the current stream or
    raises, also when the walk's stack overflows. `packet_stream2.launches`
    counts its launches."""
    name = "packet_stream2"
    _check_stream_args(nodes_i, nodes_f, rows, orig_t, dir_t, act, tile,
                       None, None, None, None, 0, name=name)
    device = act.device
    if device.type == "cpu":
        return packet_stream2_reference(nodes_i, nodes_f, rows, orig_t,
                                        dir_t, act, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    out = _launch_walk(
        "packet_stream2_launch", tile, act.shape[0],
        (nodes_i, nodes_f, rows, orig_t, dir_t, act),
        (act.shape[0], tile, rows.shape[0] // 8))
    packet_stream2.launches += 1
    return out


packet_stream2.launches = 0


def packet_stream2_reference(nodes_i, nodes_f, rows, orig_t, dir_t, act, *,
                             tile: int, tally=None):
    """Plain torch version of packet_stream2: same signature, same
    outputs, stats included, on any device. Each tile's half-split walk
    runs on the host in numpy float32 scalars (_stream2_tile); a leaf's
    chunks run their dense tests as one batch of torch ops on the tensors'
    device (nothing the walk reads changes within a leaf).

    tally (optional int64 [5] tensor): adds the pairs tested, mt_pairs'
    three counts of the pairs that pass its early exits, and the chunk
    steps that tested one half only."""
    host = {"ni": nodes_i.cpu().numpy(), "nf": nodes_f.cpu().numpy()}
    recs = rows[:, :10]
    n_rows = rows.shape[0] // 8

    def walk(ti, ob, ib, n_act, tile_rays, on):
        return _stream2_tile(host, n_act, recs, tile_rays, on, n_rows, tally)
    with np.errstate(over="ignore"):   # a dead half's bounds are +-1e30
        return _per_tile(walk, orig_t, dir_t, act, tile)


def _stream2_tile(host, n_act, recs, rays, on, n_rows, tally):
    """One tile of the plain K7 (clpathtracer_tpu/ops/packet.py::
    _make_machine): (best_t [L], best_slot [L], stats [5]). A stack entry
    is (node, t_lo left, t_hi left, t_lo right, t_hi right)."""
    f32 = np.float32
    ni, nf = host["ni"], host["nf"]
    tile = on.shape[0]
    h = tile // 2
    dev = on.device
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    right = torch.arange(tile, device=dev) >= h
    on_h = (on & ~right, on & right)
    obnd, ibnd = _packet_bounds_masked([r.reshape(2, h) for r in rays],
                                       on.reshape(2, h).float())
    obnd = [[b.cpu().numpy() for b in ax] for ax in obnd]
    ibnd = [[b.cpu().numpy() for b in ax] for ax in ibnd]
    ob = [[(ax[0][s], ax[1][s]) for ax in obnd] for s in (0, 1)]
    ib = [[(ax[0][s], ax[1][s]) for ax in ibnd] for s in (0, 1)]
    axinfo = [_axinfo(ob[s], ib[s]) for s in (0, 1)]
    seed = []
    for s in (0, 1):
        lo, hi = _box_interval(nf[0:3], nf[3:6], ob[s], ib[s])
        if not bool(on_h[s].any()):
            hi = f32(-BIG)          # an empty half never goes live
        seed += [lo, hi]
    stack = ([(0, *seed)] if any(seed[2 * s] <= seed[2 * s + 1]
                                 and seed[2 * s + 1] > 0.0 for s in (0, 1))
             else [])
    tu = [f32(BIG), f32(BIG)]
    nv = nl = 0
    while stack:
        node, *iv = stack.pop()
        nv += 1
        live = [bool(iv[2 * s] <= np.minimum(iv[2 * s + 1], tu[s])
                     and iv[2 * s + 1] > 0.0) for s in (0, 1)]
        if not any(live):
            continue
        flags, a, b, c = (int(x) for x in ni[node])
        if flags >= 4:
            nl += c
            if c == 0:
                continue
            go = (on_h[0] & live[0]) | (on_h[1] & live[1])
            if tally is not None:
                tally[0] += c * _WIN_RECS * int(go.sum())
                tally[4] += c * (live[0] != live[1])
            rows0 = np.minimum(a + np.arange(c) * CHUNK_ROWS,
                               n_rows - CHUNK_ROWS)
            bt, bs = _dense_windows(recs, rows0, rays, go.expand(c, tile),
                                    False, bt, bs,
                                    None if tally is None else tally[1:4])
            if (nv & TUP_MASK) == 0:
                for s in (0, 1):
                    if live[s]:
                        tu[s] = f32(torch.where(on_h[s], bt, -BIG).amax()
                                    .item())
            continue
        _guard(stack)
        split = nf[6 + node]
        near_iv, far_iv = [], []     # [lo, hi] of each child for each half
        for s in (0, 1):
            p_min, p_max, nlo = _split_plane_interval(axinfo[s], flags & 3,
                                                      split)
            n_iv = (iv[2 * s], np.minimum(iv[2 * s + 1], p_max))
            f_iv = (np.maximum(iv[2 * s], p_min), iv[2 * s + 1])
            if s == 0:
                l_nlo = bool(nlo)
            elif bool(nlo) != l_nlo:   # the right half's near child is far
                n_iv, f_iv = f_iv, n_iv
            near_iv.append(n_iv)
            far_iv.append(f_iv)
        near, far = (a, b) if l_nlo else (b, a)   # the left half's order
        for child, ivs in ((far, far_iv), (near, near_iv)):
            if any(lo <= np.minimum(hi, tu[s])
                   for s, (lo, hi) in enumerate(ivs)):
                stack.append((child, *ivs[0], *ivs[1]))
    return bt, bs, (nv, nl, n_act, 0, 0)


# ---------------------------------------------------------------------------
# host entry
# ---------------------------------------------------------------------------


def packet_mode(tree, n_rays: int, tile: int = TILE, engine: str = "auto"):
    """The engine traverse_packet runs, or None when it cannot run (no
    tree, a wave that is not whole tiles, a legacy node table beyond
    VMEM_BUDGET, "wide" without a wide table), as the JAX package's
    packet_mode picks it:

    * "auto" and "stream": "stream" (K3, or K4 in the bf16 preview); the
      JAX package's "auto" leaves the stream engine only when its tables
      exceed the TPU's VMEM budget, which the card does not have;
    * "queue": "queue" (K5);
    * "stream2": "stream2" (K7) when the wave is whole pairs of tiles
      (the TPU kernel steps two tiles at once), else "stream";
    * "mxu": "mxu" (K8);
    * "legacy": the JAX package's v1 selection, "vmem" (K6a) when the
      node table and the records fit VMEM_BUDGET at 64 B each, else
      "tri_stream" (K6b) when the node table does;
    * "wide": "wide" (K9) when the tree has a wide table (the JAX
      package's CLPT_WIDE=1)."""
    require_quad_tree(tree, "traverse_packet")
    if tree is None or tree.node_table is None or n_rays % tile:
        return None
    if engine in ("auto", "stream"):
        return "stream"
    if engine == "stream2":
        return "stream2" if n_rays % (2 * tile) == 0 else "stream"
    if engine in ("queue", "mxu"):
        return engine
    if engine == "legacy":
        table_bytes = tree.num_nodes * 16 * 4
        tri_bytes = tree.tri_indices.shape[0] * 16 * 4
        if table_bytes + tri_bytes <= VMEM_BUDGET:
            return "vmem"
        return "tri_stream" if table_bytes <= VMEM_BUDGET else None
    if engine == "wide":
        return "wide" if tree.wide_table is not None else None
    raise ValueError(f"unknown packet engine {engine!r}")


def tile_shape(tile: int):
    """A tile's pixel block: square when possible, else 1:2 (512 rays ->
    16x32 pixels)."""
    th = tw = math.isqrt(tile)
    if th * tw != tile:
        th = math.isqrt(tile // 2)
        tw = 2 * th
    return th, tw


def _pixel_blocks(image_shape, tile: int):
    """(h, w, th, tw) when the frame image_shape = (h, w) divides into
    tile_shape pixel blocks of `tile` rays, else None (consecutive
    rays)."""
    th, tw = tile_shape(tile)
    if (image_shape is not None and th * tw == tile
            and image_shape[0] % th == 0 and image_shape[1] % tw == 0):
        return (*image_shape, th, tw)
    return None


def packet_rays(orig, dir, image_shape=None, tile: int = TILE, active=None):
    """The rays of a walk kernel: (orig_t, dir_t [3, N] f32 tile-major,
    act [N] f32, layout), pixel-blocked when image_shape divides into
    tile_shape blocks (layout ("blocks", h, w, th, tw)), else in wave
    order (layout None); act is 1 where `active` is None."""
    act = (torch.ones((orig.shape[0],), dtype=torch.float32,
                      device=orig.device)
           if active is None else active.to(torch.float32))
    blocks = _pixel_blocks(image_shape, tile)
    if blocks is not None:
        orig, dir, act = (_blockify(x, *blocks) for x in (orig, dir, act))
    return (orig.T.to(torch.float32).contiguous(),
            dir.T.to(torch.float32).contiguous(), act.contiguous(),
            None if blocks is None else ("blocks", *blocks))


def v1_kernel_args(tree, orig, dir, image_shape=None, tile: int = TILE,
                   mode: str = "tri_stream"):
    """The host side of traverse_packet's legacy and wide branches for
    mode "vmem" (K6a), "tri_stream" (K6b) or "wide" (K9): (args, layout)
    with packet_legacy(*args, tile=tile, resident=mode == "vmem") or
    packet_wide(*args, tile=tile) the kernel call and layout as
    packet_rays'. The records: tree.tris as they are for K6a, pad_records
    for K6b and K9; the rays pixel-blocked when image_shape divides into
    tiles."""
    require_quad_tree(tree, "v1_kernel_args")
    orig_t, dir_t, _, layout = packet_rays(orig, dir, image_shape, tile)
    table = (tree.wide_table if mode == "wide"
             else tree.node_table[:, :16].contiguous())
    recs = tree.tris if mode == "vmem" else pad_records(tree.tris)
    return (table, recs, orig_t, dir_t), layout


def stream2_kernel_args(tree, orig, dir, image_shape=None, tile: int = TILE,
                        active=None):
    """The host side of traverse_packet's stream2 branch (K7): (args,
    layout) with packet_stream2(*args, tile=tile) the kernel call and
    layout as packet_rays'. The MT records padded by pad_records,
    stream2_nodes, the rays pixel-blocked when image_shape divides into
    tiles, the active mask; no SO form, window cull, strips or frustum, as
    in the JAX package's stream2 branch."""
    orig_t, dir_t, act, layout = packet_rays(orig, dir, image_shape, tile,
                                           active)
    return (*stream2_nodes(tree), pad_records(tree.tris), orig_t, dir_t,
            act), layout


def stream_kernel_args(tree, orig, dir, image_shape=None, tile: int = TILE,
                       active=None, shared_origin: bool = False,
                       grid_dirs: bool = False, strips: bool = True,
                       frustum: bool = True, chunk_cull: bool = True):
    """The host side and prepass of traverse_packet's stream branch:
    (args, kwargs, layout) with packet_stream(*args, **kwargs) the K3 call
    and layout = None (rays in wave order), ("blocks", h, w, th, tw) or
    ("strips", h, w, th, tw, bh, bw) for putting the results back in wave
    order.

    The SO form runs when shared_origin (the caller's promise that every
    origin equals orig[0]), its records so_combine of the tree's SO tables
    or, on a tree without them, so_rows of its records (the JAX package's
    per-frame pass); otherwise the MT form. Strips mode (strips=True) runs
    on fully active unjittered (grid_dirs) shared-origin pixel frames with
    window tables, with 512-lane gates when tile >= 1024; else the AABB
    cull (chunk_cull), with the corner frustum (frustum=True) on such
    frames."""
    n = orig.shape[0]
    blocks = _pixel_blocks(image_shape, tile)
    blocked = blocks is not None
    h, w, th, tw = blocks if blocked else (None, None, *tile_shape(tile))
    cbnd = tree.chunk_bnd if chunk_cull else None
    act = (torch.ones((n,), dtype=torch.float32, device=orig.device)
           if active is None else active.to(torch.float32))
    if not shared_origin:
        rows = pad_records(tree.tris)
    elif tree.so_base is not None:
        rows = so_combine(tree.so_base, orig[0].to(torch.float32))
    else:
        rows = pad_records(so_rows(tree.tris, orig[0]), pad_value=0.0)
    nodes_i, nodes_f = stream_nodes(tree)
    kw = dict(tile=tile, so=shared_origin)
    if (shared_origin and blocked and grid_dirs and active is None
            and cbnd is not None
            and th % 8 == 0 and tw % 16 == 0 and tile % 128 == 0
            and strips):
        bh, bw = ((16, 32) if tile >= 1024 and th % 16 == 0 and tw % 32 == 0
                  else (8, 16))
        n_strips = tile // (bh * bw)
        orig_b = _blockify_strips(orig, h, w, th, tw, bh, bw)
        dir_b = _blockify_strips(dir, h, w, th, tw, bh, bw).to(torch.float32)
        masks, ten = _strip_masks(cbnd, dir_b, orig[0], n_strips, bh, bw)
        kw.update(masks=masks, ten=ten, n_strips=n_strips)
        layout = ("strips", h, w, th, tw, bh, bw)
    else:
        if blocked:
            orig_b = _blockify(orig, h, w, th, tw)
            dir_b = _blockify(dir, h, w, th, tw).to(torch.float32)
            act = _blockify(act, h, w, th, tw)
            layout = ("blocks", h, w, th, tw)
        else:
            orig_b, dir_b, layout = orig, dir.to(torch.float32), None
        if cbnd is not None:
            kw["cbnd"] = cbnd
            if shared_origin and blocked and grid_dirs and frustum:
                kw["frustum"] = _frustum_rows(dir_b, orig[0], tile, th, tw)
    args = (nodes_i, nodes_f, rows, orig_b.T.to(torch.float32).contiguous(),
            dir_b.T.contiguous(), act.contiguous())
    return args, kw, layout


def _to_wave_order(x, layout):
    if layout is None:
        return x
    if layout[0] == "strips":
        return _unblockify_strips(x, *layout[1:])
    return _unblockify(x, *layout[1:])


def traverse_packet(tree, orig, dir, image_shape=None, tile: int = TILE,
                    engine: str = "auto", active=None,
                    precision: str = "f32", shared_origin: bool = False,
                    grid_dirs: bool = False, strips: bool = True,
                    frustum: bool = True, chunk_cull: bool = True):
    """Packet-trace a coherent wave through the kd-tree (the stream,
    queue, legacy and wide branches of clpathtracer_tpu/ops/packet.py::
    traverse_packet).

    tree: accel/sah.py::FlatKdTree with window tables (attach_chunk_info)
    and, for the SO form, SO tables (attach_so_tables). image_shape:
    (height, width) of a row-major pixel wave; when it divides into
    tile-sized pixel blocks the tiles are blocks, else consecutive rays.
    active: optional [N] bool; dead lanes never hit and leave the packet
    bounds, a tile of dead lanes does no walk (sort dead rays to the tail
    first). shared_origin, grid_dirs, strips, frustum, chunk_cull: see
    stream_kernel_args; the defaults are the JAX package's.

    engine "auto" / "stream" runs K3; "stream2" runs K7 on a wave of whole
    pairs of tiles (else K3, as packet_mode picks) and "mxu" K8; both take
    the MT records and the active mask and ignore precision (they compute
    in f32), shared_origin, grid_dirs, strips, frustum and chunk_cull, as
    in the JAX package. "queue" runs K5 with the SO form
    when shared_origin (so_combine of the tree's SO tables, or the
    per-frame so_rows on a tree without them, as K3), the AABB cull when
    it has window tables (and chunk_cull), never strips or the frustum.
    "legacy" runs K6a or K6b by the JAX package's byte rule (packet_mode)
    and "wide" K9 (the JAX package's CLPT_WIDE=1); as in the JAX package
    they take the MT records of every lane and ignore active,
    shared_origin, grid_dirs, strips, frustum, chunk_cull and precision:
    dead lanes join the packet bounds and can report hits.
    precision "bf16" (the stream engine's preview) runs K4: MT records,
    the AABB cull, no strips, frustum or SO form; hit comes from its
    winner slot and t/u/v from the f32 re-resolve, so a bf16 false hit
    stays a hit. The queue computes in f32 whatever the precision, but
    takes the MT form under "bf16", as the JAX package does.

    Returns hit, t, tri, u, v ([N]) and tile_stats [n_tiles, 5] (node
    pops, windows streamed, active lanes, windows culled, dense
    executions; K4 and K5 write 0 in the last; K6a, K6b and K9 write node
    (K9: supernode) pops, leaves (K6a) or windows streamed, then 0s; K7
    and K8 node pops, chunks, active lanes, 0, 0)."""
    n = orig.shape[0]
    _check_precision(precision)
    mode = packet_mode(tree, n, tile, engine)
    if mode is None:
        raise ValueError(f"traverse_packet: engine {engine!r} cannot run: "
                         f"{n} rays are not whole tiles of {tile}, there is "
                         "no tree, or the tree lacks the engine's tables")
    if mode in ("stream2", "mxu"):
        if mode == "stream2":
            args, layout = stream2_kernel_args(tree, orig, dir, image_shape,
                                               tile, active)
            _, best_slot, tile_stats = packet_stream2(*args, tile=tile)
        else:
            from clpathtracer_tpu_torch.ops.packet_mxu import (
                mxu_kernel_args, packet_mxu)
            args, layout = mxu_kernel_args(tree, orig, dir, image_shape,
                                           tile, active)
            _, best_slot, tile_stats = packet_mxu(*args, tile=tile)
        return _resolve_stream_winners(
            tree, _to_wave_order(best_slot, layout), orig, dir, tile_stats)
    if mode in ("vmem", "tri_stream", "wide"):
        args, layout = v1_kernel_args(tree, orig, dir, image_shape, tile,
                                      mode)
        if mode == "wide":
            _, best_slot, tile_stats = packet_wide(*args, tile=tile)
        else:
            _, best_slot, tile_stats = packet_legacy(
                *args, tile=tile, resident=mode == "vmem")
        return _resolve_stream_winners(
            tree, _to_wave_order(best_slot, layout), orig, dir, tile_stats)
    if mode == "queue" or precision == "bf16":
        # the JAX package's VMEM-table and queue calls: no strips, no
        # frustum; the SO form only in f32
        strips = frustum = False
        shared_origin = shared_origin and precision == "f32"
    with span("prepass"):
        args, kw, layout = stream_kernel_args(
            tree, orig, dir, image_shape, tile, active, shared_origin,
            grid_dirs, strips, frustum, chunk_cull)
    if mode == "queue":
        _, best_slot, tile_stats = packet_queue(*args, **kw)
    else:
        _, best_slot, tile_stats = packet_stream(*args, precision=precision,
                                                 **kw)
    best_slot = _to_wave_order(best_slot, layout)
    return _resolve_stream_winners(tree, best_slot, orig, dir, tile_stats)


def _resolve_stream_winners(tree, best_slot, orig, dir, tile_stats):
    """Re-resolve the winner slots (wave order): exact f32 t/u/v from one
    Moller-Trumbore per ray on the winner's record."""
    from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
    hit = best_slot >= 0
    sel = tree.tris[best_slot.clamp(0, tree.tris.shape[0] - 1).long()]
    _, t, u, v = _mt_pre(sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], orig, dir)
    return {
        "hit": hit,
        "t": torch.where(hit, t, BIG),
        "tri": torch.where(hit, sel[:, 9].to(torch.int32), -1),
        "u": torch.where(hit, u, 0.0),
        "v": torch.where(hit, v, 0.0),
        "tile_stats": tile_stats,
    }
