"""How the Hopper schedules of K10 (plist_super.cu::plist_gathered_kernel)
and K11 (plist_subgate.cu::plist_subgate_kernel) split and order their
work, replayed in Python and held to the plain versions. No JAX, no card:
the kernels themselves run only on the card (chip_smoke.py phases 29-33,
38); these replays pin down the schedule that they implement.

K10: a gate's table streams through a ring of two pieces (a chunk of cwin
windows, or half of one above PIECE_RECS records); piece q + 1 is copied
before piece q is tested, so the first piece of a chunk that the break then
refuses is copied but never tested. Each lane's records are split over
KSPLIT threads, each testing a contiguous share of the piece window by
window; their winners merge by (t, slot) after every chunk.

K11: each sub-gate walks the gate's shared list with its own cursor and
t_upper; its next window is fixed by the t_upper from before the current
one is tested and copied while it is tested, so every copy is tested. The
stats row is 4 x the most windows of the gate's four sub-gates.

Tolerance: exact (the replays run the plain pair tests of ops/packet.py,
which round as the kernels do)."""

import pytest
import torch

from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                generate_rays)
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.ops.packet import (BIG, _blockify,
                                               _blockify_strips, so_combine,
                                               so_pairs)
from clpathtracer_tpu_torch.scene.procedural import terrain_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]
H, W = 32, 64            # 4 gates of 16x32 pixels
KSPLIT = 2               # threads a lane of the SO forms (kSplit<false>)
PIECE_RECS = 2048        # plist_super.cu::kPieceRecs
INT_MAX = torch.iinfo(torch.int32).max


def _scene(win_rows):
    """A small terrain seen from above (every ray hits), its windows at
    win_rows with SO rows, the rays in gate order and in sub-gate order."""
    sc = terrain_mesh(4000, seed=0, extent=10.0, device=CPU)
    mwin = plist.attach_so(plist.build_morton_windows(
        sc.tri_corners(), win_rows, device=CPU))
    cam = Camera.create(POS, FWD, device=CPU)
    orig, dirs = generate_rays(cam_matrix(cam, H), W, H)
    dir_b = _blockify(dirs, H, W, plist.GH, plist.GW)
    dir_bs = _blockify_strips(dirs, H, W, plist.GH, plist.GW, plist.SBH,
                              plist.SBW)
    return mwin, so_combine(mwin.so_base, orig[0]), orig[0], dir_b, dir_bs


def _merge(bt, bs):
    """(t, slot) least over the threads (dim 0) of each lane: merge_split."""
    t = bt.amin(dim=0)
    s = torch.where(bt == t, bs, INT_MAX).amin(dim=0)
    return t, s


def _first_wins(bt, bs):
    """A merge that keeps thread 0's winner at equal t: not the kernels'."""
    t = bt.amin(dim=0)
    h = (bt == t).to(torch.int8).argmax(dim=0)
    return t, bs.gather(0, h[None])[0]


def _test_share(bt, bs, recs, slot0, d):
    """One thread's records recs [n, 16] at slots slot0.. against the
    lane rays d [3, lanes], into its winners bt/bs [lanes]."""
    ok, t = so_pairs(recs[None, :, :10], d[0][:, None], d[1][:, None],
                     d[2][:, None])
    slot = torch.where(ok, slot0 + torch.arange(recs.shape[0]), INT_MAX)
    t_min = t.amin(dim=1)
    s_min = torch.where(t == t_min[:, None], slot, INT_MAX).amin(dim=1)
    take = (t_min < bt) | ((t_min == bt) & (s_min < bs))
    bt[take], bs[take] = t_min[take], s_min[take]


def k10_replay(ten, ids, table, dir_t, t0, win_rows, cwin, merge=_merge):
    """plist_gathered_kernel's schedule. Returns (best_t, best_slot,
    stats, log): log[g] = (pieces copied, pieces tested, chunks, pieces of
    the table)."""
    n_gates, kmax = ten.shape
    win_tris = win_rows * 8
    chunk = cwin * win_tris
    piece = chunk if chunk <= PIECE_RECS else chunk // 2
    per_chunk = chunk // piece
    n_chunks = kmax // cwin
    n_pieces = n_chunks * per_chunk
    share = piece // KSPLIT
    d = dir_t.reshape(3, n_gates, plist.GATE)
    out_t, out_s, stats, log = [], [], [], []
    for g in range(n_gates):
        bt = torch.full((KSPLIT, plist.GATE), BIG)
        bs = torch.full((KSPLIT, plist.GATE), INT_MAX, dtype=torch.int64)
        t0g = t0.reshape(n_gates, plist.GATE)[g]
        tup = min(BIG, float(t0g.max()))
        alive = n_chunks > 0 and float(ten[g, 0]) <= tup
        copied, tested, c, q = ([0] if alive else []), [], 0, 0
        while alive:
            if q + 1 < n_pieces:
                copied.append(q + 1)   # before piece q is tested
            tested.append(q)
            for h in range(KSPLIT):
                lo = q * piece + h * share
                r = lo
                while r < lo + share:    # window by window
                    k = r // win_tris
                    in_win = r - k * win_tris
                    n = min(lo + share - r, win_tris - in_win)
                    _test_share(bt[h], bs[h], table[g, r:r + n],
                                int(ids[g, k]) * win_tris + in_win, d[:, g])
                    r += n
            q += 1
            if q % per_chunk == 0:
                c += 1
                t, s = merge(bt, bs)
                bt[:], bs[:] = t, s
                tup = float(torch.minimum(t, t0g).max())
                alive = c < n_chunks and float(ten[g, c * cwin]) <= tup
        out_t.append(bt[0])
        out_s.append(torch.where(bt[0] < BIG, bs[0], -1))
        stats.append([0, c * cwin, plist.GATE, 0, c * cwin])
        log.append((copied, tested, c, n_pieces))
    return (torch.cat(out_t), torch.cat(out_s).to(torch.int32),
            torch.tensor(stats, dtype=torch.int32), log)


def _gathered(win_rows, kmax):
    mwin, rows, o, dir_b, _ = _scene(win_rows)
    table, ids, ten, _ = plist.gate_lists_gathered(
        mwin.win_bnd, dir_b, o, rows, win_rows, kmax)
    return table, ids, ten, dir_b.T.contiguous()


@pytest.mark.parametrize("win_rows,cwin", [(1, 3), (64, 5)],
                         ids=["shares-cross-windows", "half-chunk-pieces"])
def test_k10_shares_merge_by_t_then_slot(win_rows, cwin):
    """(a) A chunk whose entry ids descend and whose pairs tie in t across
    the threads' shares: entries 0 and 1 of each gate both hold the window
    that the most of its rays hit, under ids that descend, and shares run
    across window ends (1 x 8-record windows, chunks of 3: 12 records a
    share), or pieces are half chunks (64 x 8 records, chunks of 5: 2560
    records, pieces of 1280, shares of 640 that end mid-window). The merged
    winners equal plist_gathered_reference; a merge that keeps thread 0's
    winner at equal t does not."""
    kmax = 2 * cwin
    table, ids, ten, dir_t = _gathered(win_rows, kmax)
    wt = win_rows * 8
    t0 = torch.full((ten.shape[0] * plist.GATE,), BIG)
    first = plist.plist_gathered_reference(ten, ids, table, dir_t, t0,
                                           win_rows=win_rows, cwin=cwin)
    table, ids = table.clone(), ids.clone()
    for g in range(ten.shape[0]):
        win = first[1][g * plist.GATE:(g + 1) * plist.GATE] // wt
        popular = int(torch.mode(win[win >= 0]).values)
        k = int((ids[g] == popular).nonzero()[0])
        table[g, :2 * wt] = table[g, k * wt:(k + 1) * wt].repeat(2, 1)
    ids[:, :cwin] = int(ids.max()) + torch.arange(cwin, 0, -1,
                                                  dtype=torch.int32)
    ref = plist.plist_gathered_reference(ten, ids, table, dir_t, t0,
                                         win_rows=win_rows, cwin=cwin)
    got = k10_replay(ten, ids, table, dir_t, t0, win_rows, cwin)
    for a, b in zip(got[:3], ref):
        assert torch.equal(a, b)
    # entry 1's copy of a record ties entry 0's and wins by its lower slot
    in_e1 = ref[1] // wt == ids[:, 1].repeat_interleave(plist.GATE)
    assert int(in_e1.sum()) > 0
    naive = k10_replay(ten, ids, table, dir_t, t0, win_rows, cwin,
                       merge=_first_wins)
    assert torch.equal(naive[0], ref[0])
    assert not torch.equal(naive[1], ref[1])


@pytest.mark.parametrize("kmax", [4, 64])
def test_k10_ring_copies_at_most_one_piece_ahead(kmax):
    """(b) The ring's order on a tiny windows scene (win_rows 2, cwin 2):
    the pieces tested are 0, 1, ... in order, as many chunks as the
    stats' chunks*cwin say; the copies are those pieces and at most one
    more (the next chunk's first piece, copied before the break), never
    past the table's kmax / cwin chunks."""
    win_rows, cwin = 2, 2
    table, ids, ten, dir_t = _gathered(win_rows, kmax)
    t0 = torch.full((ten.shape[0] * plist.GATE,), BIG)
    ref = plist.plist_gathered_reference(ten, ids, table, dir_t, t0,
                                         win_rows=win_rows, cwin=cwin)
    *got, log = k10_replay(ten, ids, table, dir_t, t0, win_rows, cwin)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ends = set()
    for g, (copied, tested, chunks, n_pieces) in enumerate(log):
        assert tested == list(range(len(tested)))
        assert chunks * cwin == int(ref[2][g, 1])
        assert copied[:len(tested)] == tested
        assert len(copied) <= len(tested) + 1
        assert max(copied) < n_pieces
        ends.add("table end" if len(copied) == len(tested) else "break")
    # kmax 4: every gate reads its whole table; 64: every gate breaks
    assert ends == ({"table end"} if kmax == 4 else {"break"})


def k11_replay(key, pay, rows, dir_t, win_rows):
    """plist_subgate_kernel's schedule, one sub-gate a block. Returns
    (best_t, best_slot, stats, windows [G, 4], copies [G, 4])."""
    n_gates, list_len = key.shape
    win_tris = win_rows * 8
    lanes = plist.GATE // plist.SUB
    share = win_tris // KSPLIT
    d = dir_t.reshape(3, n_gates, plist.SUB, lanes)
    recs = rows.reshape(-1, win_tris, 16)

    def next_entry(j, tup, sbit):
        for i in range(j, list_len):
            if float(key[g, i]) > tup:
                return list_len
            if int(pay[g, i]) & sbit:
                return i
        return list_len
    out_t = torch.full((n_gates, plist.SUB, lanes), BIG)
    out_s = torch.full((n_gates, plist.SUB, lanes), -1, dtype=torch.int64)
    ns = torch.zeros((n_gates, plist.SUB), dtype=torch.int32)
    copies = torch.zeros_like(ns)
    for g in range(n_gates):
        for s in range(plist.SUB):
            bt = torch.full((KSPLIT, lanes), BIG)
            bs = torch.full((KSPLIT, lanes), INT_MAX, dtype=torch.int64)
            tup = BIG
            j = next_entry(0, tup, 1 << s)
            copies[g, s] += int(j < list_len)
            while j < list_len:
                jn = next_entry(j + 1, tup, 1 << s)   # before window j
                copies[g, s] += int(jn < list_len)
                wid = int(pay[g, j]) >> 4
                for h in range(KSPLIT):
                    _test_share(bt[h], bs[h],
                                recs[wid, h * share:(h + 1) * share],
                                wid * win_tris + h * share, d[:, g, s])
                ns[g, s] += 1
                t, sl = _merge(bt, bs)
                bt[:], bs[:] = t, sl
                tup = float(t.max())
                j = jn
            out_t[g, s] = bt[0]
            out_s[g, s] = torch.where(bt[0] < BIG, bs[0], -1)
    most = ns.amax(dim=1) * plist.SUB
    stats = torch.stack([torch.zeros_like(most), most,
                         torch.full_like(most, plist.GATE),
                         torch.zeros_like(most), most], dim=1)
    return (out_t.reshape(-1), out_s.reshape(-1).to(torch.int32), stats, ns,
            copies)


def test_k11_subgate_streams_and_stats():
    """(c) A gate where one sub-gate needs no window (its need bit cleared
    from every entry of gate 0): the blocks' walks (one a sub-gate, its own
    cursor and t_upper, 2 threads a lane) equal plist_subgate_reference;
    every window copied is tested; each sub-gate's windows are its stream
    over _subgate_lists + _window_stream; the stats row is 4 x the most
    windows of the gate's four, and the sub-gate without a window misses
    on all its lanes."""
    win_rows = 2
    mwin, rows, o, _, dir_bs = _scene(win_rows)
    key, pay = plist.gate_lists4(mwin.win_bnd, dir_bs, o)
    idle = 2
    pay = pay.clone()
    pay[0] &= ~(1 << idle)
    dir_t = dir_bs.T.contiguous()
    ref = plist.plist_subgate_reference(key, pay, rows, dir_t,
                                        win_rows=win_rows)
    t, s, stats, ns, copies = k11_replay(key, pay, rows, dir_t, win_rows)
    for a, b in zip((t, s, stats), ref):
        assert torch.equal(a, b)
    assert torch.equal(copies, ns)
    lanes = plist.GATE // plist.SUB
    sub_key, sub_wid = plist._subgate_lists(key, pay)
    _, _, sub_ns = plist._window_stream(
        sub_key, sub_wid, plist._records(rows, win_rows * 8),
        plist._group_test(None, dir_t, lanes),
        torch.full((key.shape[0] * plist.SUB, lanes), BIG), win_rows * 8)
    sub_ns = sub_ns.reshape(-1, plist.SUB)
    assert torch.equal(sub_ns, ns)
    assert int(ns[0, idle]) == 0 and int(ns[0].max()) > 0
    assert torch.equal(ref[2][:, 1], sub_ns.amax(dim=1) * plist.SUB)
    idle_lanes = slice(idle * lanes, (idle + 1) * lanes)
    assert bool((ref[1][:plist.GATE][idle_lanes] == -1).all())
