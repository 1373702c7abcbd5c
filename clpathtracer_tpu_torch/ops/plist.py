"""Prepass-list engine (port of clpathtracer_tpu/ops/plist.py): shared-
origin primary gates in four stream schedules, and sorted bounce bundles.

Pipeline:

  * build (host, once per scene): an equal-count median split orders the
    triangles; records [S, 16] are packed in that order and cut into
    windows of win_rows*8 records, padded to whole supers of SUPER
    windows; per-window AABBs; shared-origin tables (so_affine_tables) and
    fused resolve rows on the device.
  * prepass (plain torch, per wave): per-(gate, window) keys, the
    conservative entry distance (+inf where culled):
    - primary gates (traverse_plist), each a 16x32 pixel block with one
      origin: the slab interval of the gate's direction range plus the
      corner-frustum planes (_win_keys), dilated for jittered samples;
    - bounce bundles (traverse_plist_bundle), 512 consecutive rays of a
      Morton-sorted wave (ops/sort.py): interval-arithmetic slabs over the
      bundle's origin and inverse-direction ranges (_bundle_keys).
    Each schedule sorts its own list by key per gate: supers of SUPER
    windows with need bits (gate_lists_super), single windows
    (gate_lists), the first kmax windows gathered into a private table
    (gate_lists_gathered), or windows with the need bits of four 8x16
    sub-gates (gate_lists4).
  * kernels: per gate, bundle or sub-gate, stream the sorted list, test
    the windows it names densely, stop when the next key exceeds t_upper.
    - K1 (plist_super): supers, the shared-origin signed-volume test; its
      kcap form streams at most kcap entries a gate (the two-phase
      engine's first phase, _plist_two_phase);
    - K1' (plist_super_mt): supers, general Moller-Trumbore with per-lane
      origins and t0 seeds;
    - K2 (plist_window): single windows, SO or MT;
    - K10 (plist_gathered): the private tables in chunks of cwin windows,
      SO;
    - K11 (plist_subgate): four 128-ray sub-gates per gate, each with its
      own cursor and t_upper, SO or MT.
    CUDA on the GPU (ops/csrc/plist_super.cu: K1, K1', K2, K10;
    ops/csrc/plist_subgate.cu: K11); their plain torch versions
    (plist_*_reference) on the CPU.
  * resolve: one row gather of the winner's fused record, an exact
    Moller-Trumbore re-resolve of t/u/v, and the shade attributes.

Lists are flat [G, L] tensors (key f32, ids, bits and payloads i32) and
slots are int32 rows of the [S, 16] record array. The JAX package's
environment switches of the schedule (CLPT_PLIST_SUPER, CLPT_PLIST_GATHER)
are traverse_plist's arguments here; its other knobs are constants at its
defaults (gate 16x32 pixels, t_upper refreshed after every entry).
CLPT_PLIST_KCAP, the two-phase straggler engine (K1's kcap form, then the
grid DDA of ops/grid_walk.py), is traverse_plist(kcap=, grid=); d0cull, a
measured negative, is not ported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from clpathtracer_tpu_torch.accel.sah import pack_quads_host
from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.struct import TensorStruct
from clpathtracer_tpu_torch.ops.packet import (
    BIG, INV_BIG, _blockify, _blockify_strips, _frustum_rows, _unblockify,
    _unblockify_strips, mt_pairs, so_affine_tables, so_combine, so_pairs)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre

GATE = 512        # rays per gate: a GH x GW pixel block
GH = 16
GW = GATE // GH
SUPER = 16        # windows per super-list entry
WIN_ROWS = 16     # window size in units of 8 records (128 triangles)
SUB = 4           # K11: sub-gates per gate, each an SBH x SBW pixel block
SBH, SBW = 8, 16
KMAX_CAP = 1024   # K10: most entries of a gate's gathered table
# K10: most records staged per chunk (cwin * win_rows * 8): 192 KB of
# shared memory at 48 B a record
CHUNK_RECS = 4096
_INT_MAX = torch.iinfo(torch.int32).max
# pairs (ray x triangle) per step of the plain kernel version: bounds its
# temporaries to a few hundred MB at any gate count
_REF_PAIRS = 1 << 22


@dataclasses.dataclass(frozen=True)
class MortonWindows(TensorStruct):
    """Window structure of the prepass-list engine.

    tris: [S, 16] f32 triangle records (v0, e1, e2, tri_id, pad) in window
      order; S is a multiple of win_rows*8*SUPER. Pad records have
      tri_id -1.
    tri_id: [S] i32 triangle id of each record (-1 for pads).
    win_bnd: [W, 6] f32 per-window AABB (lo xyz, hi xyz); pad windows
      carry an empty box (+1e30 / -1e30) that every gate culls.
    slot_of_tri: [T] i32 triangle id -> record slot.
    so_base: optional [4, S, 16] shared-origin tables (attach_so).
    resolve_rows: optional [S, 32] fused resolve+shade rows
      (attach_resolve).
    """

    tris: torch.Tensor
    tri_id: torch.Tensor
    win_bnd: torch.Tensor
    slot_of_tri: torch.Tensor
    so_base: torch.Tensor = None
    resolve_rows: torch.Tensor = None
    win_rows: int = WIN_ROWS

    @property
    def num_windows(self) -> int:
        return self.win_bnd.shape[0]


# ---------------------------------------------------------------------------
# host build
# ---------------------------------------------------------------------------


def median_order(tri_verts: np.ndarray, span: int) -> np.ndarray:
    """Equal-count recursive median split of triangle centroids: split the
    widest-extent axis at the multiple-of-`span` index nearest the median,
    recurse, emit depth-first left to right. Every window but the global
    tail holds `span` triangles of one convex cell, and consecutive
    windows nest (tight super hulls)."""
    c = tri_verts.mean(axis=1).astype(np.float32)
    n = c.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n, dtype=np.int64)]
    while stack:
        seg = stack.pop()
        m = seg.shape[0]
        if m <= span:
            out[pos:pos + m] = seg
            pos += m
            continue
        cc = c[seg]
        ax = int(np.argmax(cc.max(axis=0) - cc.min(axis=0)))
        nwin = (m + span - 1) // span
        half = int(np.clip(round(m / 2 / span), 1, nwin - 1)) * span
        part = np.argpartition(cc[:, ax], half)
        stack.append(seg[part[half:]])   # right half (emitted second)
        stack.append(seg[part[:half]])
    assert pos == n
    return out


def build_morton_windows(tri_verts: np.ndarray, win_rows: int = WIN_ROWS, *,
                         device) -> MortonWindows:
    """Host build: median order, record packing, window AABBs, padded to
    whole supers of SUPER windows. tri_verts: [T, 3, 3] corners in
    face-winding order (Scene.tri_corners)."""
    tv = np.asarray(tri_verts, np.float32)
    span = win_rows * 8
    perm = median_order(tv, span)
    t = tv[perm]
    n = t.shape[0]
    pad = -n % (span * SUPER)
    ids = np.concatenate([perm, np.full(pad, -1, np.int64)])
    rows16 = pack_quads_host(ids, tv)
    vmin = t.min(axis=1)
    vmax = t.max(axis=1)
    if pad:
        vmin = np.concatenate([vmin, np.full((pad, 3), 1e30, np.float32)])
        vmax = np.concatenate([vmax, np.full((pad, 3), -1e30, np.float32)])
    w = vmin.shape[0] // span
    bnd = np.concatenate([vmin.reshape(w, span, 3).min(axis=1),
                          vmax.reshape(w, span, 3).max(axis=1)], axis=1)
    sot = np.full((n,), -1, np.int32)
    valid = ids >= 0
    sot[ids[valid]] = np.nonzero(valid)[0].astype(np.int32)

    def dev(x):
        return torch.as_tensor(x, device=device)
    return MortonWindows(tris=dev(rows16), tri_id=dev(ids.astype(np.int32)),
                         win_bnd=dev(bnd), slot_of_tri=dev(sot),
                         win_rows=win_rows)


def attach_so(mwin: MortonWindows) -> MortonWindows:
    """Attach the shared-origin tables, built on mwin's device."""
    return mwin.replace(so_base=so_affine_tables(mwin.tris))


def build_resolve_rows(tris16: torch.Tensor, tri_id: torch.Tensor,
                       shade_rows: torch.Tensor) -> torch.Tensor:
    """Fused resolve+shade rows [S, 32] f32, one per record slot: lanes
    0:10 are the geometry record (v0, e1, e2, tri_id), lanes 10:25 the
    triangle's baked shade row (n0, n1, n2, albedo, emission; see
    Scene.bake_shading), lanes 25:32 zero. Pad slots carry zero shade
    lanes. One gather then resolves a winner and its shading."""
    safe = tri_id.clamp(0, shade_rows.shape[0] - 1).long()
    sh = torch.where((tri_id >= 0)[:, None], shade_rows[safe][:, :15], 0.0)
    pad = torch.zeros((tris16.shape[0], 7), dtype=tris16.dtype,
                      device=tris16.device)
    return torch.cat([tris16[:, :10], sh, pad], dim=1)


def attach_resolve(mwin: MortonWindows, shade_rows) -> MortonWindows:
    """Attach fused resolve rows. shade_rows: the scene's baked [T, 16]
    shade table (Scene.bake_shading), on mwin's device."""
    if shade_rows is None:
        return mwin
    return mwin.replace(
        resolve_rows=build_resolve_rows(mwin.tris, mwin.tri_id, shade_rows))


# ---------------------------------------------------------------------------
# prepass: per-gate sorted super lists
# ---------------------------------------------------------------------------


def _win_keys(win_bnd, d, o, bh: int, bw: int,
              dilate_px: float = 0.0) -> torch.Tensor:
    """Per-(gate, window) keys: the conservative entry distance where the
    gate must test the window, +inf where it is culled. d: [N, L, 3]
    directions of N gates of L rays, each a bh x bw pixel block; o: [3]
    shared origin. The cull is the slab interval of the gate's inverse
    direction range plus the exact corner-frustum planes; it keeps a
    window on any doubt, so testing the finite entries equals an unculled
    dense sweep. Returns [N, W].

    dilate_px > 0: the directions carry subpixel jitter of up to that many
    pixels around the pixel grid (spp > 1 samples). Each frustum plane
    test relaxes by dilate_px times the gate's pixel angle, measured from
    its own corner directions, so a window is culled only when the whole
    box lies more than that angle outside the plane."""
    n_pk, n_lanes, _ = d.shape
    o = o.reshape(3).to(torch.float32)
    lo = [win_bnd[None, :, j] for j in range(3)]
    hi = [win_bnd[None, :, 3 + j] for j in range(3)]

    t_en = torch.full((n_pk, 1), -INV_BIG, device=d.device)
    t_ex = torch.full((n_pk, 1), INV_BIG, device=d.device)
    for ax in range(3):
        # 1/(+-0) is +-inf, clamped like the JAX package's clip
        inv = torch.clamp(1.0 / d[:, :, ax], -INV_BIG, INV_BIG)
        il = inv.amin(dim=1, keepdim=True)
        ih = inv.amax(dim=1, keepdim=True)
        uniform = il * ih > 0.0
        pos = il > 0.0
        nearb = torch.where(pos, lo[ax], hi[ax]) - o[ax]
        farb = torch.where(pos, hi[ax], lo[ax]) - o[ax]
        near_min = torch.minimum(nearb * il, nearb * ih)
        far_max = torch.maximum(farb * il, farb * ih)
        t_en = torch.maximum(t_en, torch.where(uniform, near_min, -INV_BIG))
        t_ex = torch.minimum(t_ex, torch.where(uniform, far_max, INV_BIG))
    keep = (t_en <= t_ex) & (t_ex > 0.0)

    margin = 1e-5
    if dilate_px:
        def sin_between(a, b):              # unit directions: |a x b|
            cr = vm.cross(a, b)
            return torch.sqrt((cr * cr).sum(dim=-1))
        c0, c1, c2 = d[:, 0], d[:, bw - 1], d[:, (bh - 1) * bw]
        px_ang = torch.maximum(sin_between(c0, c1) / max(bw - 1, 1),
                               sin_between(c0, c2) / max(bh - 1, 1))
        margin = margin + float(dilate_px) * px_ang[:, None]      # [N, 1]
    fr = _frustum_rows(d.reshape(-1, 3), o, n_lanes, bh, bw)     # [N, 16]
    for p in range(4):
        n = [fr[:, 3 * p + j:3 * p + j + 1] for j in range(3)]
        sup = torch.zeros_like(t_en)
        slack = torch.zeros_like(t_en)
        for ax in range(3):
            cc = torch.where(n[ax] > 0.0, lo[ax], hi[ax]) - o[ax]
            sup = sup + n[ax] * cc
            slack = slack + torch.abs(cc)
        keep = keep & (sup <= margin * slack)

    return torch.where(keep, torch.clamp(t_en, min=0.0), float("inf"))


def _bundle_keys(win_bnd, orig_b, dir_b) -> torch.Tensor:
    """Per-(bundle, window) keys for arbitrary ray bundles (no shared
    origin, no pixel grid): the slab test in interval arithmetic over the
    bundle's per-axis origin range [olo, ohi] and inverse-direction range
    [il, ih]. The entry key lower-bounds every lane's entry distance and
    the exit upper-bounds every lane's exit, so a culled window (entry >
    exit, or exit <= 0) misses every lane. An axis whose inverse
    directions change sign contributes nothing. orig_b/dir_b: [B, L, 3].
    Returns [B, W] (+inf = culled); the cull is only as tight as the
    bundle is coherent, so callers sort the wave first."""
    lo = [win_bnd[None, :, j] for j in range(3)]
    hi = [win_bnd[None, :, 3 + j] for j in range(3)]
    n_b = orig_b.shape[0]
    t_en = torch.full((n_b, 1), -INV_BIG, device=orig_b.device)
    t_ex = torch.full((n_b, 1), INV_BIG, device=orig_b.device)
    for ax in range(3):
        # 1/(+-0) is +-inf, clamped like the JAX package's clip
        inv = torch.clamp(1.0 / dir_b[:, :, ax], -INV_BIG, INV_BIG)
        il = inv.amin(dim=1, keepdim=True)
        ih = inv.amax(dim=1, keepdim=True)
        olo = orig_b[:, :, ax].amin(dim=1, keepdim=True)
        ohi = orig_b[:, :, ax].amax(dim=1, keepdim=True)
        uniform = il * ih > 0.0
        pos = il > 0.0
        nearb = torch.where(pos, lo[ax], hi[ax])
        farb = torch.where(pos, hi[ax], lo[ax])
        na, nb = nearb - ohi, nearb - olo
        fa, fb = farb - ohi, farb - olo
        near_lo = torch.minimum(torch.minimum(na * il, na * ih),
                                torch.minimum(nb * il, nb * ih))
        far_hi = torch.maximum(torch.maximum(fa * il, fa * ih),
                               torch.maximum(fb * il, fb * ih))
        t_en = torch.maximum(t_en, torch.where(uniform, near_lo, -INV_BIG))
        t_ex = torch.minimum(t_ex, torch.where(uniform, far_hi, INV_BIG))
    keep = (t_en <= t_ex) & (t_ex > 0.0)
    return torch.where(keep, torch.clamp(t_en, min=0.0), float("inf"))


def gate_lists_super(win_bnd, dir_g, origin, dilate_px: float = 0.0):
    """Per-gate sorted super lists. dir_g: [G*GATE, 3] gate-major
    directions (_blockify); origin: [3]; dilate_px: the jitter bound of
    _win_keys. Returns (key [G, Ls] f32, sid [G, Ls] i32, bits [G, Ls]
    i32), each gate's entries in ascending key order: key = min over the
    super's needed windows of the entry key (+inf when the gate needs none
    of them: the sorted tail), sid = super id, bits = one need bit per
    window of the super."""
    n_gates = dir_g.shape[0] // GATE
    d = dir_g.reshape(n_gates, GATE, 3).to(torch.float32)
    key_w = _win_keys(win_bnd, d, origin, GH, GW, dilate_px)     # [G, W]
    return _super_pack(key_w)


def _bundle_lists(win_bnd, orig_b, dir_b):
    """Sorted super lists of 512-ray bundles (the gate_lists_super
    contract) from _bundle_keys. orig_b/dir_b: [B, GATE, 3]."""
    return _super_pack(_bundle_keys(win_bnd, orig_b, dir_b))


def _super_pack(key_w: torch.Tensor):
    """Reduce per-window keys [G, W] to sorted super lists (the
    gate_lists_super contract). The order of equal keys is free."""
    n_gates, w = key_w.shape
    spad = -w % SUPER
    if spad:
        key_w = torch.cat([key_w, torch.full((n_gates, spad), float("inf"),
                                             device=key_w.device)], dim=1)
    kw = key_w.reshape(n_gates, -1, SUPER)
    key = kw.amin(dim=2)
    shifts = torch.arange(SUPER, dtype=torch.int32, device=key_w.device)
    bits = (torch.isfinite(kw).to(torch.int32) << shifts).sum(
        dim=2, dtype=torch.int32)
    key, order = torch.sort(key, dim=1, stable=True)
    return key, order.to(torch.int32), bits.gather(1, order)


def gate_lists(win_bnd, dir_g, origin, dilate_px: float = 0.0):
    """Per-gate sorted window lists, K2's input. dir_g: [G*GATE, 3]
    gate-major directions (_blockify); origin: [3]; dilate_px: the jitter
    bound of _win_keys. Returns (key [G, W] f32, wid [G, W] i32), each
    gate's windows in ascending key order, equal keys in window order,
    culled windows (+inf) at the tail. The JAX package packs the same
    lists into [G, C, 8, 128] chunks of f32-exact row ids; here they stay
    flat, with int32 window ids."""
    n_gates = dir_g.shape[0] // GATE
    d = dir_g.reshape(n_gates, GATE, 3).to(torch.float32)
    return _sort_windows(_win_keys(win_bnd, d, origin, GH, GW, dilate_px))


def _sort_windows(key_w: torch.Tensor):
    """One key+payload sort of per-window keys [G, W] (the gate_lists
    contract)."""
    key, order = torch.sort(key_w, dim=1, stable=True)
    return key, order.to(torch.int32)


def gathered_sizes(win_rows: int, kmax: int = None, cwin: int = None):
    """K10's (kmax, cwin) as the JAX package resolves them (plist.py:
    635-640): kmax defaults to max(1024 // win_rows, 8) entries, cwin to
    max(32 // win_rows, 1) windows a chunk; kmax rounds up to a multiple
    of lcm(8, cwin) (the JAX package's SMEM packing; a chunk count that
    truncated would drop windows), at most KMAX_CAP."""
    for arg, v in (("kmax", kmax), ("cwin", cwin)):
        if v is not None and v < 1:
            raise ValueError(f"{arg} {v} is not a positive count")
    cwin = int(cwin) if cwin else max(32 // win_rows, 1)
    kmax = int(kmax) if kmax else max(1024 // win_rows, 8)
    q = math.lcm(8, cwin)
    return min(-(-kmax // q) * q, KMAX_CAP // q * q), cwin


def gate_lists_gathered(win_bnd, dir_g, origin, rows, win_rows: int,
                        kmax: int, dilate_px: float = 0.0):
    """Prepass of K10: each gate's first kmax windows by key, gathered
    into a private table. dir_g, origin, dilate_px: as gate_lists; rows:
    [S, 16] SO records (so_combine). Returns (table [G, kmax*win_rows*8,
    16] f32, ids [G, kmax] i32, ten [G, kmax] f32, overflow): entry k of
    gate g is window ids[g, k] at key ten[g, k], its records at rows
    [k*win_rows*8, (k+1)*win_rows*8) of table[g]; overflow is a 0-d bool
    tensor, True when some gate needs more than kmax windows. Entries past
    a gate's need (pads) carry key +inf and window 0, whose rows the table
    holds for them. The table is one index_select of whole windows.

    A divergence from the JAX package (ADVICE r5 #1): its ids keep the
    raw sorted window ids of the pads (clpathtracer_tpu/ops/plist.py:1262)
    while its table holds window 0's rows there, so a pad tested inside a
    taken chunk reports slots of a window it did not test. Here a pad's id
    is window 0, the window it holds: slots agree with what was tested.
    Hits and t are the same: window 0 is either needed by the gate (the
    same records at the same slots again) or culled for it, and the cull
    is conservative, so no ray of the gate hits it."""
    n_gates = dir_g.shape[0] // GATE
    d = dir_g.reshape(n_gates, GATE, 3).to(torch.float32)
    key, wid = _sort_windows(_win_keys(win_bnd, d, origin, GH, GW,
                                       dilate_px))
    return (*_gather_table(key, wid, rows, win_rows, kmax),
            _overflows(key, kmax))


def _overflows(key: torch.Tensor, kmax: int) -> torch.Tensor:
    """Whether some gate of sorted lists [G, W] needs more than kmax
    windows (a finite key past entry kmax), as a 0-d bool tensor."""
    return torch.isfinite(key[:, kmax:]).any()


def _gather_table(key, wid, rows, win_rows: int, kmax: int):
    """(table, ids, ten) of gate_lists_gathered from sorted lists."""
    n_gates, w = key.shape
    if w < kmax:        # fewer windows than entries: pads to the end
        key = torch.cat([key, torch.full((n_gates, kmax - w), float("inf"),
                                         device=key.device)], dim=1)
        wid = torch.cat([wid, torch.zeros((n_gates, kmax - w),
                                          dtype=wid.dtype,
                                          device=wid.device)], dim=1)
    ten = key[:, :kmax].contiguous()
    ids = torch.where(torch.isfinite(ten), wid[:, :kmax], 0).contiguous()
    win_tris = win_rows * 8
    table = rows.reshape(-1, win_tris, 16).index_select(
        0, ids.reshape(-1).long()).reshape(n_gates, kmax * win_tris, 16)
    return table, ids, ten


def gate_lists4(win_bnd, dir_g, origin):
    """Per-gate sorted lists of K11 with the need bits of four sub-gates.
    dir_g: [G*GATE, 3] in _blockify_strips order (each consecutive 128
    lanes one SBH x SBW sub-gate, each 512 one gate); origin: [3]. Returns
    (key [G, W] f32, pay [G, W] i32) in ascending key order, equal keys in
    window order: key = the least entry key over the sub-gates that need
    the window (+inf when none does: the sorted tail), pay = window id << 4
    | need bits (bit s: sub-gate s). The JAX package's payload is an
    f32-exact wid*16 + bits; here an int32."""
    lanes = GATE // SUB
    d = dir_g.reshape(-1, lanes, 3).to(torch.float32)
    key_s = _win_keys(win_bnd, d, origin, SBH, SBW)           # [G*SUB, W]
    key_s = key_s.reshape(-1, SUB, key_s.shape[1])
    shifts = torch.arange(SUB, dtype=torch.int32,
                          device=key_s.device)[:, None]
    bits = (torch.isfinite(key_s).to(torch.int32) << shifts).sum(
        dim=1, dtype=torch.int32)
    key, order = torch.sort(key_s.amin(dim=1), dim=1, stable=True)
    return key, (order.to(torch.int32) << 4) | bits.gather(1, order)


# ---------------------------------------------------------------------------
# kernels: K1 and K1' (super lists), K2 (window lists), K10 (gathered
# tables), K11 (sub-gates)
# ---------------------------------------------------------------------------

_INT_ARGS = ("sid", "bits", "wid", "ids", "pay")


def _check_tensors(name, **tensors):
    """One device; each tensor contiguous, int32 (ids, bits, payloads) or
    f32. None entries (an absent orig_t) are skipped."""
    tensors = {k: t for k, t in tensors.items() if t is not None}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for arg, t in tensors.items():
        want = torch.int32 if arg in _INT_ARGS else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{want} tensor, got {t.dtype} {tuple(t.shape)}")


def _check_lists(name, **lists):
    """The gate lists share one [G > 0, L] shape."""
    shapes = {k: tuple(t.shape) for k, t in lists.items()}
    first = next(iter(lists.values()))
    if first.dim() != 2 or first.shape[0] == 0 \
            or len(set(shapes.values())) != 1:
        raise ValueError(f"{name}: {'/'.join(lists)} must share one "
                         f"[G>0, L] shape, got {shapes}")


def _check_sizes(name, win_rows, rows, recs, n, dir_t, t0=None,
                 orig_t=None):
    """win_rows in [1, 64]; rows [S, 16] with S a multiple of `recs`; the
    ray arrays of n rays."""
    if not 1 <= win_rows <= 64:
        raise ValueError(f"{name}: win_rows {win_rows} not in [1, 64]")
    if rows.dim() != 2 or rows.shape[1] != 16 or rows.shape[0] % recs:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} is not [S, 16] "
                         f"with S a multiple of {recs}")
    if dir_t.shape != (3, n) or (t0 is not None and t0.shape != (n,)) \
            or (orig_t is not None and orig_t.shape != (3, n)):
        shapes = {k: tuple(t.shape) for k, t in
                  (("dir_t", dir_t), ("t0", t0), ("orig_t", orig_t))
                  if t is not None}
        raise ValueError(f"{name}: ray arrays {shapes} do not match {n} "
                         "rays")


def _on_cpu(name, device) -> bool:
    """True: run the plain version (the caller chose the CPU); False:
    launch the kernel (CUDA); anything else raises."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    return False


def _launch(entry, name, n_gates, inputs, ints):
    """Launch the C entry `entry` of ops/csrc/ on the current stream: the
    input tensors, then best_t [N] f32, best_slot [N] i32 and stats [G, 5]
    i32, which it allocates, then n_gates and `ints`."""
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    fn = load_kernels().fns[entry]
    device = inputs[0].device
    n = n_gates * GATE
    best_t = torch.empty((n,), dtype=torch.float32, device=device)
    best_slot = torch.empty((n,), dtype=torch.int32, device=device)
    stats = torch.empty((n_gates, 5), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in inputs), best_t.data_ptr(),
                 best_slot.data_ptr(), stats.data_ptr(), n_gates, *ints,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"(G={n_gates}, {ints})")
    return best_t, best_slot, stats


def _check_super(name, key, sid, bits, rows, dir_t, t0, win_rows,
                 orig_t=None):
    _check_tensors(name, key=key, sid=sid, bits=bits, rows=rows, dir_t=dir_t,
                   t0=t0, orig_t=orig_t)
    _check_lists(name, key=key, sid=sid, bits=bits)
    _check_sizes(name, win_rows, rows, win_rows * 8 * SUPER,
                 key.shape[0] * GATE, dir_t, t0, orig_t)


def plist_super(key, sid, bits, rows, dir_t, t0, *, win_rows: int,
                kcap: int = 0):
    """Nearest shared-origin hit of every ray over its gate's sorted super
    list (K1; replaces clpathtracer_tpu/ops/plist.py::_kernel_plist_super).

    key/sid/bits: [G, Ls] from gate_lists_super; rows: [S, 16] SO records
    (so_combine); dir_t: [3, G*512] gate-major directions; t0: [G*512]
    per-ray t upper-bound seeds (BIG for primary rays). sid entries must be
    valid super ids of `rows` (gate_lists_super guarantees it). kcap > 0:
    the kcap form, a gate streams at most its first kcap entries (the first
    phase of _plist_two_phase; plist.py:1015-1032).

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [G, 5] i32 = (0, windows, 512, supers, windows), counting what was
    streamed). Ties in t go to the lowest slot.

    A CPU tensor runs the plain version (plist_super_reference); a CUDA
    tensor launches ops/csrc/plist_super.cu on the current stream or
    raises. `plist_super.launches` counts kernel launches without a cap,
    `plist_super.kcap_launches` those of the kcap form."""
    _check_super("plist_super", key, sid, bits, rows, dir_t, t0, win_rows)
    if _on_cpu("plist_super", key.device):
        return plist_super_reference(key, sid, bits, rows, dir_t, t0,
                                     win_rows=win_rows, kcap=kcap)
    out = _launch("plist_super_launch", "plist_super", key.shape[0],
                  (key, sid, bits, rows, dir_t, t0),
                  (key.shape[1], win_rows, _jcap(kcap, key.shape[1])))
    if kcap > 0:
        plist_super.kcap_launches += 1
    else:
        plist_super.launches += 1
    return out


plist_super.launches = 0
plist_super.kcap_launches = 0


def plist_super_mt(key, sid, bits, rows, orig_t, dir_t, t0, *,
                   win_rows: int, kcap: int = 0):
    """Nearest Moller-Trumbore hit of every ray over its bundle's sorted
    super list (K1'; replaces clpathtracer_tpu/ops/plist.py::
    _kernel_plist_super with so=False).

    key/sid/bits: [G, Ls] from _bundle_lists or gate_lists_super; rows:
    [S, 16] raw triangle records (v0, e1, e2, tri_id); orig_t/dir_t:
    [3, G*512] per-lane origins and directions (dead lanes: direction 0);
    t0: [G*512] per-lane t upper-bound seeds (BIG for a live ray, 0 for a
    dead one). Hits need det > 0 (front faces), 0 <= u, v, u + v <= 1,
    t > 0 and tri_id >= 0. kcap: as plist_super.

    Returns (best_t, best_slot, stats) as plist_super does; ties in t go to
    the lowest slot. A CPU tensor runs the plain version
    (plist_super_mt_reference); a CUDA tensor launches
    ops/csrc/plist_super.cu on the current stream or raises.
    `plist_super_mt.launches` counts kernel launches without a cap,
    `plist_super_mt.kcap_launches` those of the kcap form."""
    _check_super("plist_super_mt", key, sid, bits, rows, dir_t, t0,
                 win_rows, orig_t)
    if _on_cpu("plist_super_mt", key.device):
        return plist_super_mt_reference(key, sid, bits, rows, orig_t, dir_t,
                                        t0, win_rows=win_rows, kcap=kcap)
    out = _launch("plist_super_mt_launch", "plist_super_mt", key.shape[0],
                  (key, sid, bits, rows, orig_t, dir_t, t0),
                  (key.shape[1], win_rows, _jcap(kcap, key.shape[1])))
    if kcap > 0:
        plist_super_mt.kcap_launches += 1
    else:
        plist_super_mt.launches += 1
    return out


plist_super_mt.launches = 0
plist_super_mt.kcap_launches = 0


def plist_window(key, wid, rows, dir_t, t0, *, win_rows: int, orig_t=None):
    """Nearest hit of every ray over its gate's sorted window list (K2;
    replaces clpathtracer_tpu/ops/plist.py::_kernel_plist, both forms).

    key/wid: [G, L] from gate_lists; rows: [S, 16] with S a multiple of
    win_rows*8 (any window count, whole supers or not): SO records
    (so_combine) when orig_t is None, else the raw triangle records with
    orig_t [3, G*512] per-lane origins (the MT form, K1''s test); dir_t:
    [3, G*512] gate-major directions; t0: [G*512] seeds as K1's. wid
    entries must be valid window ids of `rows` (gate_lists guarantees it).

    Windows are tested in list order; window j+1 is taken if its key <=
    the t_upper from before window j was tested (the TPU kernel's
    prefetch decision). Returns (best_t, best_slot, stats [G, 5] = (0,
    windows, 512, 0, windows)); ties in t go to the lowest slot.

    A CPU tensor runs the plain version (plist_window_reference); a CUDA
    tensor launches ops/csrc/plist_super.cu on the current stream or
    raises. `plist_window.launches` counts kernel launches of both
    forms."""
    _check_tensors("plist_window", key=key, wid=wid, rows=rows, dir_t=dir_t,
                   t0=t0, orig_t=orig_t)
    _check_lists("plist_window", key=key, wid=wid)
    _check_sizes("plist_window", win_rows, rows, win_rows * 8,
                 key.shape[0] * GATE, dir_t, t0, orig_t)
    if _on_cpu("plist_window", key.device):
        return plist_window_reference(key, wid, rows, dir_t, t0,
                                      win_rows=win_rows, orig_t=orig_t)
    if orig_t is None:
        out = _launch("plist_window_launch", "plist_window", key.shape[0],
                      (key, wid, rows, dir_t, t0), (key.shape[1], win_rows))
    else:
        out = _launch("plist_window_mt_launch", "plist_window", key.shape[0],
                      (key, wid, rows, orig_t, dir_t, t0),
                      (key.shape[1], win_rows))
    plist_window.launches += 1
    return out


plist_window.launches = 0


def plist_gathered(ten, ids, table, dir_t, t0, *, win_rows: int, cwin: int):
    """Nearest shared-origin hit of every ray over its gate's private
    window table (K10; replaces clpathtracer_tpu/ops/plist.py::
    _kernel_plist_gath, which has the SO form only).

    ten/ids/table: from gate_lists_gathered ([G, kmax], [G, kmax],
    [G, kmax*win_rows*8, 16] SO records); cwin: windows a chunk, dividing
    kmax, at most CHUNK_RECS records a chunk; dir_t, t0: as plist_super.
    Chunk c (entries c*cwin .. c*cwin + cwin - 1) is taken while c <
    kmax/cwin and the key of its first entry <= the t_upper after chunk
    c-1; all its windows are tested, record r of entry k at slot
    ids[g, k]*win_rows*8 + r. Returns (best_t, best_slot, stats [G, 5] =
    (0, chunks*cwin, 512, 0, chunks*cwin)); ties in t go to the lowest
    slot.

    A CPU tensor runs the plain version (plist_gathered_reference); a
    CUDA tensor launches ops/csrc/plist_super.cu on the current stream or
    raises. `plist_gathered.launches` counts kernel launches."""
    _check_tensors("plist_gathered", ten=ten, ids=ids, table=table,
                   dir_t=dir_t, t0=t0)
    _check_lists("plist_gathered", ten=ten, ids=ids)
    n_gates, kmax = ten.shape
    if table.shape != (n_gates, kmax * win_rows * 8, 16) or cwin < 1 \
            or kmax % cwin or cwin * win_rows * 8 > CHUNK_RECS:
        raise ValueError(
            f"plist_gathered: table {tuple(table.shape)} is not [G, kmax*"
            f"{win_rows * 8}, 16] for {n_gates} gates of kmax {kmax}, or "
            f"cwin {cwin} does not divide kmax or stages more than "
            f"{CHUNK_RECS} records")
    _check_sizes("plist_gathered", win_rows, table.reshape(-1, 16),
                 win_rows * 8, n_gates * GATE, dir_t, t0)
    if _on_cpu("plist_gathered", ten.device):
        return plist_gathered_reference(ten, ids, table, dir_t, t0,
                                        win_rows=win_rows, cwin=cwin)
    out = _launch("plist_gathered_launch", "plist_gathered", n_gates,
                  (ten, ids, table, dir_t, t0), (kmax, cwin, win_rows))
    plist_gathered.launches += 1
    return out


plist_gathered.launches = 0


def plist_subgate(key, pay, rows, dir_t, *, win_rows: int, orig_t=None):
    """Nearest hit of every ray over its gate's shared list with four
    128-ray sub-gates (K11; replaces clpathtracer_tpu/ops/plist.py::
    _kernel_plist4, both forms).

    key/pay: [G, L] from gate_lists4; rows: [S, 16] with S a multiple of
    win_rows*8, SO records when orig_t is None, else raw triangle records
    with orig_t [3, G*512] per-lane origins; dir_t: [3, G*512] in
    _blockify_strips order (lanes 128s .. 128s + 127 of a gate are
    sub-gate s).

    Each sub-gate walks the list with its own cursor and t_upper: it takes
    the next entry with its need bit, against the t_upper from before its
    current window was tested (the TPU kernel's prefetch decision), and
    stops at the first entry whose key is above that t_upper. Returns
    (best_t, best_slot, stats [G, 5] = (0, 4*ns, 512, 0, 4*ns)), ns the
    most windows any sub-gate of the gate tested; ties in t go to the
    lowest slot.

    A CPU tensor runs the plain version (plist_subgate_reference); a CUDA
    tensor launches ops/csrc/plist_subgate.cu on the current stream or
    raises. `plist_subgate.launches` counts kernel launches of both
    forms."""
    _check_tensors("plist_subgate", key=key, pay=pay, rows=rows, dir_t=dir_t,
                   orig_t=orig_t)
    _check_lists("plist_subgate", key=key, pay=pay)
    _check_sizes("plist_subgate", win_rows, rows, win_rows * 8,
                 key.shape[0] * GATE, dir_t, None, orig_t)
    if _on_cpu("plist_subgate", key.device):
        return plist_subgate_reference(key, pay, rows, dir_t,
                                       win_rows=win_rows, orig_t=orig_t)
    if orig_t is None:
        out = _launch("plist_subgate_launch", "plist_subgate", key.shape[0],
                      (key, pay, rows, dir_t), (key.shape[1], win_rows))
    else:
        out = _launch("plist_subgate_mt_launch", "plist_subgate",
                      key.shape[0], (key, pay, rows, orig_t, dir_t),
                      (key.shape[1], win_rows))
    plist_subgate.launches += 1
    return out


plist_subgate.launches = 0


# ---------------------------------------------------------------------------
# plain versions: the kernels' stream loops as torch ops, vectorised over
# groups of rays (gates, bundles or sub-gates) in chunks that bound memory
# ---------------------------------------------------------------------------


def _group_test(orig_t, dir_t, lanes, tally=None):
    """The plain pair test of groups of `lanes` rays: test(g, r) gives
    (ok, t) [A, lanes, n] of the groups g [A] against records r
    [A, n, >= 10], t = BIG where rejected: the SO test when orig_t is
    None, else the MT test (tally: see plist_super_mt_reference)."""
    d = dir_t.reshape(3, -1, lanes)
    if orig_t is None:
        def test(g, r):
            return so_pairs(r[:, None], *(d[ax, g][:, :, None]
                                          for ax in range(3)))
        return test
    o = orig_t.reshape(3, -1, lanes)

    def test(g, r):
        return mt_pairs(r[:, None], *(o[ax, g][:, :, None] for ax in range(3)),
                        *(d[ax, g][:, :, None] for ax in range(3)), tally,
                        lane_dim=-2)
    return test


def _take_nearest(bt, bs, g, ok, t_m, slot):
    """Merge the tested pairs ok/t_m [A, lanes, n] of groups g, whose
    records have slots slot [A, n], into their winners bt/bs [M, lanes]:
    (min t, then min slot)."""
    s_m = torch.where(ok, slot[:, None, :], _INT_MAX)
    t_min = t_m.amin(dim=2)
    s_min = torch.where(t_m == t_min[..., None], s_m, _INT_MAX).amin(dim=2)
    take = (t_min < bt[g]) | ((t_min == bt[g]) & (s_min < bs[g]))
    bt[g] = torch.where(take, t_min, bt[g])
    bs[g] = torch.where(take, s_min, bs[g])


def _by_chunks(n_groups, lanes, win_tris, run):
    """run(g0, g1) on chunks of groups small enough that a window's pairs
    stay under _REF_PAIRS; each output concatenated over the chunks."""
    chunk = max(1, _REF_PAIRS // (lanes * win_tris))
    parts = [run(g0, min(g0 + chunk, n_groups))
             for g0 in range(0, n_groups, chunk)]
    return [torch.cat(p) for p in zip(*parts)]


def _start(t0g, n_entries, first_key):
    """Per-group start of a stream: (best t, best slot, count, t_upper,
    alive), t_upper = min(BIG, max t0)."""
    m, lanes = t0g.shape
    dev = t0g.device
    tup = torch.clamp(t0g.amax(dim=1), max=BIG)
    alive = (first_key() <= tup if n_entries
             else torch.zeros((m,), dtype=torch.bool, device=dev))
    return (torch.full((m, lanes), BIG, device=dev),
            torch.full((m, lanes), _INT_MAX, dtype=torch.int32, device=dev),
            torch.zeros((m,), dtype=torch.int32, device=dev), tup, alive)


def _outputs(bt, bs, a, b):
    """(best_t [N], best_slot [N] with -1 on a miss, stats [G, 5] =
    (0, a, 512, b, a))."""
    best_slot = torch.where(bt < BIG, bs, -1)
    stats = torch.stack([torch.zeros_like(a), a, torch.full_like(a, GATE), b,
                         a], dim=1)
    return bt.reshape(-1), best_slot.reshape(-1), stats


def _records(rows, win_tris):
    return rows.reshape(-1, win_tris, 16)[:, :, :10]    # [W, win_tris, 10]


def plist_super_reference(key, sid, bits, rows, dir_t, t0, *, win_rows: int,
                          kcap: int = 0):
    """Plain torch version of plist_super: same signature, same outputs,
    stats included, on any device."""
    return _super_reference(key, sid, bits, rows,
                            _group_test(None, dir_t, GATE), t0, win_rows,
                            kcap)


def plist_super_mt_reference(key, sid, bits, rows, orig_t, dir_t, t0, *,
                             win_rows: int, kcap: int = 0, tally=None):
    """Plain torch version of plist_super_mt: same signature, same
    outputs, stats included, on any device.

    tally (optional int64 [3] tensor on the device): adds the counts of the
    tested (ray, record) pairs that pass det > 0, then also 0 <= u <= 1,
    then also v >= 0 and u + v <= 1: the kernel's early exits, which set
    the work these inputs need. A tally of 7 lanes also counts what the
    warps issue (packet.py::mt_pairs, warp_ops)."""
    return _super_reference(key, sid, bits, rows,
                            _group_test(orig_t, dir_t, GATE, tally), t0,
                            win_rows, kcap)


def _jcap(kcap: int, list_len: int) -> int:
    """The entries a gate may stream: all, or the first kcap (kcap > 0)."""
    return list_len if kcap <= 0 else min(kcap, list_len)


def _super_reference(key, sid, bits, rows, test, t0, win_rows, kcap=0):
    """K1's stream loop. All gates still alive at step j have consumed
    exactly j entries, so a chunk of gates steps the sorted entries
    together with a per-gate alive mask, which reproduces the kernel's
    break and so its stats. kcap > 0 stops every stream before entry
    kcap."""
    win_tris = win_rows * 8
    recs = _records(rows, win_tris)
    t0g = t0.reshape(-1, GATE)
    slot_in_win = torch.arange(win_tris, dtype=torch.int32, device=t0.device)

    def run(g0, g1):
        k, s_, b_ = key[g0:g1], sid[g0:g1], bits[g0:g1]
        list_len = _jcap(kcap, k.shape[1])
        bt, bs, ns, tup, alive = _start(t0g[g0:g1], list_len,
                                        lambda: k[:, 0])
        nw = torch.zeros_like(ns)
        j = 0
        while bool(alive.any()):
            a = alive.nonzero().squeeze(1)
            s, b = s_[a, j], b_[a, j]
            for w in range(SUPER):
                need = ((b >> w) & 1).bool()
                nw[a] += need.to(torch.int32)
                if not bool(need.any()):
                    continue
                g = a[need]
                win = s[need].long() * SUPER + w
                ok, t_m = test(g + g0, recs[win])
                _take_nearest(bt, bs, g, ok, t_m,
                              win[:, None].to(torch.int32) * win_tris
                              + slot_in_win)
            ns[a] += 1
            tup[a] = torch.minimum(bt[a], t0g[g0 + a]).amax(dim=1)
            j += 1
            if j == list_len:
                break
            alive[a] = k[a, j] <= tup[a]
        return bt, bs, ns, nw
    bt, bs, ns, nw = _by_chunks(key.shape[0], GATE, win_tris, run)
    return _outputs(bt, bs, nw, ns)


def _window_stream(key, wid, recs, test, t0g, win_tris):
    """The stream loop of K2 and of K11's sub-gates over groups of rays:
    per group, the windows of its sorted list (key/wid [M, L]) in order,
    window j+1 taken if its key <= the t_upper from before window j was
    tested. Returns (best t, best slot, windows tested) per group."""
    slot_in_win = torch.arange(win_tris, dtype=torch.int32, device=key.device)

    def run(g0, g1):
        k, w_ = key[g0:g1], wid[g0:g1]
        list_len = k.shape[1]
        bt, bs, ns, tup, alive = _start(t0g[g0:g1], list_len,
                                        lambda: k[:, 0])
        j = 0
        while bool(alive.any()):
            a = alive.nonzero().squeeze(1)
            nxt = (k[a, j + 1] <= tup[a] if j + 1 < list_len
                   else torch.zeros_like(a, dtype=torch.bool))
            win = w_[a, j].long()
            ok, t_m = test(a + g0, recs[win])
            _take_nearest(bt, bs, a, ok, t_m,
                          win[:, None].to(torch.int32) * win_tris
                          + slot_in_win)
            ns[a] += 1
            tup[a] = torch.minimum(bt[a], t0g[g0 + a]).amax(dim=1)
            alive[a] = nxt
            j += 1
        return bt, bs, ns
    return _by_chunks(key.shape[0], t0g.shape[1], win_tris, run)


def plist_window_reference(key, wid, rows, dir_t, t0, *, win_rows: int,
                           orig_t=None):
    """Plain torch version of plist_window: same signature, same outputs,
    stats included, on any device."""
    win_tris = win_rows * 8
    bt, bs, ns = _window_stream(key, wid, _records(rows, win_tris),
                                _group_test(orig_t, dir_t, GATE),
                                t0.reshape(-1, GATE), win_tris)
    return _outputs(bt, bs, ns, torch.zeros_like(ns))


def _subgate_lists(key, pay):
    """Each sub-gate's own list from K11's shared one: the entries with
    its need bit, in list order, then +inf. Returns (key, wid) [G*SUB, L],
    sub-gate s of gate g at row g*SUB + s. Its K2 stream is the sub-gate's
    walk: the first entry past its cursor whose key is above its t_upper
    ends the walk, and every later entry that it needs lies beyond that
    key too."""
    n_gates, list_len = key.shape
    shifts = torch.arange(SUB, dtype=torch.int32,
                          device=key.device)[None, :, None]
    need = ((pay[:, None, :] >> shifts) & 1).bool()           # [G, SUB, L]
    _, order = torch.sort((~need).to(torch.int32), dim=2, stable=True)
    sub_key = torch.where(need.gather(2, order),
                          key[:, None].expand(-1, SUB, -1).gather(2, order),
                          float("inf"))
    sub_wid = (pay >> 4)[:, None].expand(-1, SUB, -1).gather(2, order)
    return (sub_key.reshape(n_gates * SUB, list_len),
            sub_wid.reshape(n_gates * SUB, list_len))


def plist_subgate_reference(key, pay, rows, dir_t, *, win_rows: int,
                            orig_t=None):
    """Plain torch version of plist_subgate: same signature, same
    outputs, stats included, on any device."""
    win_tris = win_rows * 8
    lanes = GATE // SUB
    n_gates = key.shape[0]
    sub_key, sub_wid = _subgate_lists(key, pay)
    t0g = torch.full((n_gates * SUB, lanes), BIG, device=key.device)
    bt, bs, ns = _window_stream(sub_key, sub_wid, _records(rows, win_tris),
                                _group_test(orig_t, dir_t, lanes), t0g,
                                win_tris)
    most = ns.reshape(n_gates, SUB).amax(dim=1) * SUB
    return _outputs(bt, bs, most, torch.zeros_like(most))


def plist_gathered_reference(ten, ids, table, dir_t, t0, *, win_rows: int,
                             cwin: int):
    """Plain torch version of plist_gathered: same signature, same
    outputs, stats included, on any device."""
    n_gates, kmax = ten.shape
    win_tris = win_rows * 8
    n_chunks = kmax // cwin
    recs = table.reshape(n_gates, kmax, win_tris, 16)[..., :10]
    test = _group_test(None, dir_t, GATE)
    t0g = t0.reshape(-1, GATE)
    slot_in_win = torch.arange(win_tris, dtype=torch.int32, device=t0.device)

    def run(g0, g1):
        bt, bs, nc, tup, alive = _start(t0g[g0:g1], n_chunks,
                                        lambda: ten[g0:g1, 0])
        c = 0
        while bool(alive.any()):
            a = alive.nonzero().squeeze(1)
            for k in range(c * cwin, (c + 1) * cwin):
                ok, t_m = test(a + g0, recs[g0 + a, k])
                _take_nearest(bt, bs, a, ok, t_m,
                              ids[g0 + a, k][:, None] * win_tris
                              + slot_in_win)
            nc[a] += 1
            tup[a] = torch.minimum(bt[a], t0g[g0 + a]).amax(dim=1)
            c += 1
            if c == n_chunks:
                break
            alive[a] = ten[g0 + a, c * cwin] <= tup[a]
        return bt, bs, nc
    bt, bs, nc = _by_chunks(n_gates, GATE, win_tris, run)
    return _outputs(bt, bs, nc * cwin, torch.zeros_like(nc))


# ---------------------------------------------------------------------------
# host entries and winner resolution
# ---------------------------------------------------------------------------


def traverse_plist(mwin: MortonWindows, orig, dir, image_shape,
                   dilate_px: float = 0.0, *, supers: bool = True,
                   gathered: bool = False, kmax: int = None,
                   cwin: int = None, kcap: int = 0, grid=None):
    """Trace shared-origin pixel-grid primary rays (generate_rays order)
    through the windows. orig/dir: [H*W, 3], every origin equal to
    orig[0]; dilate_px: a bound on the rays' subpixel jitter plus slack
    (0 for pixel-grid rays; see _win_keys).

    The stream schedule (the JAX package's CLPT_PLIST_SUPER and
    CLPT_PLIST_GATHER switches, as arguments):
      * supers (the default): sorted super lists, K1 with shared-origin
        tables attached, else K1' on the raw records; on windows that are
        not whole supers K2 instead, as in the JAX package;
      * supers=False: one sorted entry per window, K2 (SO, or MT without
        SO tables);
      * gathered=True: each gate's first kmax windows gathered into a
        private table and streamed in chunks of cwin windows, K10. It has
        an SO form only: without SO tables it raises ValueError (the JAX
        package downgrades such a call quietly; ADVICE r5 #2). kmax and
        cwin resolve as gathered_sizes says. When some gate needs more
        than kmax windows (one host read of the prepass's overflow flag,
        the counterpart of the JAX package's lax.cond), the whole frame
        runs K1 instead, or K2 on windows that are not whole supers: the
        launch counters show which kernel ran;
      * kcap > 0 with a grid (accel/grid.py::UniformGrid of the same
        triangles): the two-phase straggler engine (_plist_two_phase), K1
        (K1' without SO tables) streams at most kcap entries a gate and the
        grid DDA (G1) finishes the unsettled rays; the explicit form of the
        JAX package's CLPT_PLIST_KCAP. It needs the super schedule on
        windows that are whole supers; otherwise, or without a grid, kcap
        > 0 raises ValueError (the JAX package runs single-phase
        quietly).

    Returns the hit record: hit, t, tri, u, v, snormal, salbedo, semission
    ([H*W] / [H*W, 3]) and tile_stats [G, 5]."""
    h, w = image_shape
    n = orig.shape[0]
    if n != h * w or h % GH or w % GW:
        raise NotImplementedError(
            f"traverse_plist needs an {h}x{w} frame of {n} rays that "
            f"divides into {GH}x{GW} gates; render_image sends other frames "
            "to the kd-tree (tree=)")
    so = mwin.so_base is not None
    whole = mwin.num_windows % SUPER == 0
    if kcap > 0 and (grid is None or gathered or not supers or not whole):
        raise ValueError(
            f"traverse_plist(kcap={kcap}) needs a grid and the super "
            "schedule on windows that are whole supers: the two-phase engine "
            "finishes its unsettled rays on the grid DDA")
    if gathered and not so:
        raise ValueError("traverse_plist(gathered=True) needs shared-origin "
                         "tables (attach_so): K10 has no Moller-Trumbore "
                         "form")
    o = orig[0]
    wr = mwin.win_rows
    dir_b = _blockify(dir, h, w, GH, GW).to(torch.float32)
    dir_t = dir_b.T.contiguous()
    t0 = torch.full((n,), BIG, device=dir.device)
    rows = so_combine(mwin.so_base, o) if so else mwin.tris
    orig_t = (None if so else
              _blockify(orig, h, w, GH, GW).to(torch.float32).T.contiguous())
    key_w = _win_keys(mwin.win_bnd, dir_b.reshape(-1, GATE, 3), o, GH, GW,
                      dilate_px)
    if gathered:
        kmax, cwin = gathered_sizes(wr, kmax, cwin)
        key, wid = _sort_windows(key_w)
        if not bool(_overflows(key, kmax)):
            table, ids, ten = _gather_table(key, wid, rows, wr, kmax)
            out = plist_gathered(ten, ids, table, dir_t, t0, win_rows=wr,
                                 cwin=cwin)
        elif whole:
            out = plist_super(*_super_pack(key_w), rows, dir_t, t0,
                              win_rows=wr)
        else:
            out = plist_window(key, wid, rows, dir_t, t0, win_rows=wr)
    elif kcap > 0:
        out = _plist_two_phase(mwin, grid, _super_pack(key_w), rows, o,
                               dir_b, dir_t, orig_t, t0, kcap)
    elif supers and whole:
        if so:
            out = plist_super(*_super_pack(key_w), rows, dir_t, t0,
                              win_rows=wr)
        else:
            out = plist_super_mt(*_super_pack(key_w), rows, orig_t, dir_t,
                                 t0, win_rows=wr)
    else:
        out = plist_window(*_sort_windows(key_w), rows, dir_t, t0,
                           win_rows=wr, orig_t=orig_t)
    _, best_slot, tile_stats = out
    best_slot = _unblockify(best_slot, h, w, GH, GW)
    return _resolve_winners(mwin, best_slot, orig, dir, tile_stats)


def _plist_two_phase(mwin: MortonWindows, grid, lists, rows, o, dir_b,
                     dir_t, orig_t, t0, kcap: int):
    """The two-phase straggler engine (clpathtracer_tpu/ops/plist.py::
    _plist_two_phase): per-gate break, then a per-ray finish.

    K1 breaks per gate, so one deep lane drags a gate's 512 rays through
    its whole list. Phase 1 streams at most kcap entries a gate (K1's kcap
    form; K1' without SO tables, orig_t given). A ray is settled when its
    best t, with 1e-4 relative slack for the SO arithmetic, is at or
    inside the key of the gate's first unstreamed entry (keys lower-bound
    every later entry; +inf past the list). Phase 2 sorts the unsettled
    rays to the front (stable: pixel order) and finishes them on the grid
    DDA with t_max = their phase-1 best (with the slack); a grid winner
    (a triangle id, mwin.slot_of_tri gives its slot) replaces the phase-1
    one when its t is strictly less. Returns (best_t, best_slot, stats) in
    gate order; stats count phase 1 only."""
    from clpathtracer_tpu_torch.ops.grid_walk import traverse_grid
    key, sid, bits = lists
    wr = mwin.win_rows
    if orig_t is None:
        bt1, bs1, ts1 = plist_super(key, sid, bits, rows, dir_t, t0,
                                    win_rows=wr, kcap=kcap)
    else:
        bt1, bs1, ts1 = plist_super_mt(key, sid, bits, rows, orig_t, dir_t,
                                       t0, win_rows=wr, kcap=kcap)
    perm, wave = two_phase_wave(key, bt1, kcap, o, dir_b)
    rec2 = traverse_grid(grid, *wave[:2], t_max=wave[2], active=wave[3])
    n_tris = mwin.slot_of_tri.shape[0]
    slot2 = torch.where(rec2["hit"],
                        mwin.slot_of_tri[rec2["tri"].clamp(0, n_tris - 1)
                                         .long()], -1)
    t2 = torch.empty_like(bt1)
    s2 = torch.empty_like(bs1)
    t2[perm] = rec2["t"]
    s2[perm] = slot2
    take2 = (s2 >= 0) & (t2 < bt1)
    return torch.where(take2, t2, bt1), torch.where(take2, s2, bs1), ts1


def two_phase_wave(key, bt1, kcap: int, o, dir_b):
    """Phase 2's wave of the two-phase engine: (perm, (orig, dir, t_max,
    active)). key: the gates' sorted keys [G, Ls]; bt1: phase 1's best t
    in gate order; o: the shared origin; dir_b: the gate-major directions.
    A ray is settled when bt1 * (1 + 1e-4) <= the key of its gate's entry
    kcap (+inf past the list); perm sorts the unsettled rays first,
    stably, and the wave is in that order with t_max = bt1 * (1 + 1e-4)
    and active = unsettled."""
    n_gates, list_len = key.shape
    key_k = (key[:, kcap] if kcap < list_len
             else torch.full((n_gates,), float("inf"), device=key.device))
    t_bound = bt1 * (1.0 + 1e-4)
    settled = t_bound <= key_k.repeat_interleave(GATE)
    _, perm = torch.sort(settled.to(torch.uint8), stable=True)
    return perm, (o.to(torch.float32).expand(perm.shape[0], 3),
                  dir_b[perm].contiguous(), t_bound[perm], ~settled[perm])


def plist4_supported(mwin: MortonWindows, n_rays: int, image_shape) -> bool:
    """Whether traverse_plist4 takes a frame: the frame checks of the JAX
    package's plist_supported (windows given, n_rays = h*w, whole 16x32
    gates). Its other two checks (plist.py:1736-1740) are TPU layout
    limits that the port does not have: the whole sorted list resident in
    700 KB of SMEM (here it stays in global memory, read through L2) and
    window ids exact in an f32 payload (here an int32)."""
    if mwin is None or image_shape is None:
        return False
    h, w = image_shape
    return n_rays == h * w and h % GH == 0 and w % GW == 0


def traverse_plist4(mwin: MortonWindows, orig, dir, image_shape):
    """Trace shared-origin pixel-grid primary rays through the sub-gate
    schedule (K11): four 8x16-pixel sub-gates per 16x32 gate, each with
    its own cursor into the gate's sorted list and its own t_upper. K11's
    SO form with shared-origin tables attached, else its MT form on the
    raw records. Same arguments (no jitter) and record contract as
    traverse_plist. No render route of the JAX package takes it; this is
    its entry point."""
    h, w = image_shape
    n = orig.shape[0]
    if not plist4_supported(mwin, n, image_shape):
        raise NotImplementedError(
            f"traverse_plist4 needs windows and an {h}x{w} frame of {n} "
            f"rays that divides into {GH}x{GW} gates")
    o = orig[0]
    dir_b = _blockify_strips(dir, h, w, GH, GW, SBH, SBW).to(torch.float32)
    key, pay = gate_lists4(mwin.win_bnd, dir_b, o)
    if mwin.so_base is not None:
        out = plist_subgate(key, pay, so_combine(mwin.so_base, o),
                            dir_b.T.contiguous(), win_rows=mwin.win_rows)
    else:
        orig_b = _blockify_strips(orig, h, w, GH, GW, SBH, SBW)
        out = plist_subgate(key, pay, mwin.tris, dir_b.T.contiguous(),
                            win_rows=mwin.win_rows,
                            orig_t=orig_b.to(torch.float32).T.contiguous())
    _, best_slot, tile_stats = out
    best_slot = _unblockify_strips(best_slot, h, w, GH, GW, SBH, SBW)
    return _resolve_winners(mwin, best_slot, orig, dir, tile_stats)


def plist_bundle_supported(mwin: MortonWindows, n_rays: int) -> bool:
    """Whether traverse_plist_bundle takes a wave of n_rays on mwin."""
    return (mwin is not None and n_rays % GATE == 0
            and mwin.num_windows % SUPER == 0)


def traverse_plist_bundle(mwin: MortonWindows, orig, dir, active=None,
                          t_max=None):
    """Trace an arbitrary wave (scattered bounce rays) through the windows:
    consecutive 512-ray bundles get interval-slab keys (_bundle_keys) and
    run K1' with per-lane origins. Same record contract as traverse_plist.

    Sort the wave first (ops/sort.py): the cull is only as good as the
    bundles are coherent. active ([N] bool, optional): dead lanes get a
    zero direction for the prepass and the kernel (det == 0 never hits)
    and t0 = 0; the resolve uses the caller's directions. t_max ([N] f32,
    optional): per-lane upper bounds on useful hits, which seed the
    kernel's break; hits beyond a lane's own t_max may still be reported
    (callers compare t)."""
    _, best_slot, tile_stats = plist_super_mt(
        *bundle_kernel_args(mwin, orig, dir, active, t_max),
        win_rows=mwin.win_rows)
    return _resolve_winners(mwin, best_slot, orig, dir, tile_stats)


def bundle_kernel_args(mwin: MortonWindows, orig, dir, active=None,
                       t_max=None):
    """The bundle prepass of traverse_plist_bundle: K1''s arguments (key,
    sid, bits, rows, orig_t, dir_t, t0) for a wave in bundle order."""
    n = orig.shape[0]
    if not plist_bundle_supported(mwin, n):
        raise ValueError(f"traverse_plist_bundle: {n} rays are not whole "
                         f"{GATE}-ray bundles, or the windows are not whole "
                         "supers")
    dirm = (torch.where(active[:, None], dir, 0.0) if active is not None
            else dir).to(torch.float32)
    orig = orig.to(torch.float32)
    key, sid, bits = _bundle_lists(mwin.win_bnd, orig.reshape(-1, GATE, 3),
                                   dirm.reshape(-1, GATE, 3))
    t0 = (torch.full((n,), BIG, device=orig.device) if t_max is None
          else t_max.to(torch.float32))
    if active is not None:
        t0 = torch.where(active, t0, 0.0)
    return (key, sid, bits, mwin.tris, orig.T.contiguous(),
            dirm.T.contiguous(), t0.contiguous())


def _resolve_winners(mwin: MortonWindows, best_slot, orig, dir,
                     tile_stats):
    """Re-resolve the kernel's winner slots (caller's ray order) to the hit
    record: the winner's exact f32 t/u/v from one Moller-Trumbore per ray
    (the kernel carries only the slot) and its shade attributes, all from
    one fused resolve-row gather."""
    out = _resolve_winners_body(mwin, best_slot, orig, dir)
    out["tile_stats"] = tile_stats
    return out


def _resolve_winners_body(mwin: MortonWindows, best_slot, orig, dir):
    if mwin.resolve_rows is None:
        raise NotImplementedError(
            "winner resolution without fused resolve rows (attach_resolve) "
            "is not ported yet: ROADMAP queue 1 item 3")
    hit = best_slot >= 0
    slot = best_slot.clamp(0, mwin.resolve_rows.shape[0] - 1).long()
    rows = mwin.resolve_rows[slot]                               # [n, 32]
    _, t, u, v = _mt_pre(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], orig, dir)
    w = torch.stack([1.0 - u - v, u, v], dim=-1)
    nrm = (w[:, 0:1] * rows[:, 10:13] + w[:, 1:2] * rows[:, 13:16]
           + w[:, 2:3] * rows[:, 16:19])
    return {
        "hit": hit,
        "t": torch.where(hit, t, BIG),
        "tri": torch.where(hit, mwin.tri_id[slot], -1),
        "u": torch.where(hit, u, 0.0),
        "v": torch.where(hit, v, 0.0),
        "snormal": vm.normalize(nrm, eps=1e-30),
        "salbedo": rows[:, 19:22],
        "semission": rows[:, 22:25],
    }
