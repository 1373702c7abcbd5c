"""Prepass-list engine (port of clpathtracer_tpu/ops/plist.py, super-list
route): shared-origin primary gates and sorted bounce bundles.

Pipeline:

  * build (host, once per scene): an equal-count median split orders the
    triangles; records [S, 16] are packed in that order and cut into
    windows of win_rows*8 records, padded to whole supers of SUPER
    windows; per-window AABBs; shared-origin tables (so_affine_tables) and
    fused resolve rows on the device.
  * prepass (plain torch, per wave), one sorted super list per 512 rays:
    - primary gates (traverse_plist), each a 16x32 pixel block with one
      origin: the slab interval of the gate's direction range plus the
      corner-frustum planes (_win_keys), dilated for jittered samples;
    - bounce bundles (traverse_plist_bundle), 512 consecutive rays of a
      Morton-sorted wave (ops/sort.py): interval-arithmetic slabs over the
      bundle's origin and inverse-direction ranges (_bundle_keys).
    Keys reduce to supers (min key, one need bit per window) and each
    list sorts by key.
  * kernels: per gate or bundle, stream the sorted supers, test the needed
    windows densely, stop when the next key exceeds t_upper.
    - K1 (plist_super): the shared-origin signed-volume test;
    - K1' (plist_super_mt): general Moller-Trumbore with per-lane origins
      and t0 seeds.
    CUDA on the GPU (ops/csrc/plist_super.cu); their plain torch versions
    (plist_super_reference, plist_super_mt_reference) on the CPU.
  * resolve: one row gather of the winner's fused record, an exact
    Moller-Trumbore re-resolve of t/u/v, and the shade attributes.

Lists are flat [G, Ls] tensors (key f32, sid i32, bits i32) and slots are
int32 rows of the [S, 16] record array. The JAX package's environment
knobs are constants here, at its defaults (gate 16x32 pixels, t_upper
refreshed after every super); the routes it keeps behind them (gathered
lists, the two-phase straggler engine, d0cull, the plain per-window list)
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clpathtracer_tpu_torch.accel.sah import pack_quads_host
from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.struct import TensorStruct
from clpathtracer_tpu_torch.ops.packet import (
    BIG, INV_BIG, _blockify, _frustum_rows, _unblockify, mt_pairs,
    so_affine_tables, so_combine, so_pairs)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre

GATE = 512        # rays per gate: a GH x GW pixel block
GH = 16
GW = GATE // GH
SUPER = 16        # windows per super-list entry
WIN_ROWS = 16     # window size in units of 8 records (128 triangles)
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


# ---------------------------------------------------------------------------
# kernels K1 (shared-origin form) and K1' (general Moller-Trumbore form)
# ---------------------------------------------------------------------------


def _check_plist_super_args(name, key, sid, bits, rows, dir_t, t0, win_rows,
                            orig_t=None):
    tensors = dict(key=key, sid=sid, bits=bits, rows=rows, dir_t=dir_t,
                   t0=t0)
    if orig_t is not None:
        tensors["orig_t"] = orig_t
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for arg, t in tensors.items():
        want = torch.int32 if arg in ("sid", "bits") else torch.float32
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous "
                             f"{want} tensor, got {t.dtype} {tuple(t.shape)}")
    if key.dim() != 2 or key.shape[0] == 0 or sid.shape != key.shape \
            or bits.shape != key.shape:
        raise ValueError(f"{name}: key/sid/bits must share one "
                         f"[G>0, Ls] shape, got {tuple(key.shape)} "
                         f"{tuple(sid.shape)} {tuple(bits.shape)}")
    if not 1 <= win_rows <= 64:
        raise ValueError(f"{name}: win_rows {win_rows} not in [1, 64]")
    n = key.shape[0] * GATE
    if rows.dim() != 2 or rows.shape[1] != 16 \
            or rows.shape[0] % (win_rows * 8 * SUPER):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} is not "
                         "[S, 16] with S a multiple of "
                         f"{win_rows * 8 * SUPER}")
    if dir_t.shape != (3, n) or t0.shape != (n,) \
            or (orig_t is not None and orig_t.shape != (3, n)):
        raise ValueError(
            f"{name}: dir_t {tuple(dir_t.shape)} / t0 {tuple(t0.shape)}"
            + ("" if orig_t is None else f" / orig_t {tuple(orig_t.shape)}")
            + f" do not match {n} rays")


def _launch(entry, name, key, sid, bits, rows, ray_t, t0, win_rows):
    """Launch a C entry of ops/csrc/plist_super.cu on the current stream.
    ray_t: the [3, N] ray arrays the entry takes after `rows`."""
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    fn = load_kernels().fns[entry]
    device = key.device
    n_gates, list_len = key.shape
    n = n_gates * GATE
    best_t = torch.empty((n,), dtype=torch.float32, device=device)
    best_slot = torch.empty((n,), dtype=torch.int32, device=device)
    stats = torch.empty((n_gates, 5), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            key.data_ptr(), sid.data_ptr(), bits.data_ptr(), rows.data_ptr(),
            *(t.data_ptr() for t in ray_t), t0.data_ptr(), best_t.data_ptr(),
            best_slot.data_ptr(), stats.data_ptr(), n_gates, list_len,
            win_rows, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"(G={n_gates}, Ls={list_len}, win_rows={win_rows})")
    return best_t, best_slot, stats


def plist_super(key, sid, bits, rows, dir_t, t0, *, win_rows: int):
    """Nearest shared-origin hit of every ray over its gate's sorted super
    list (K1; replaces clpathtracer_tpu/ops/plist.py::_kernel_plist_super).

    key/sid/bits: [G, Ls] from gate_lists_super; rows: [S, 16] SO records
    (so_combine); dir_t: [3, G*512] gate-major directions; t0: [G*512]
    per-ray t upper-bound seeds (BIG for primary rays). sid entries must be
    valid super ids of `rows` (gate_lists_super guarantees it).

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss, stats
    [G, 5] i32 = (0, windows, 512, supers, windows)). Ties in t go to the
    lowest slot.

    A CPU tensor runs the plain version (plist_super_reference); a CUDA
    tensor launches ops/csrc/plist_super.cu on the current stream or
    raises. `plist_super.launches` counts kernel launches."""
    _check_plist_super_args("plist_super", key, sid, bits, rows, dir_t, t0,
                            win_rows)
    device = key.device
    if device.type == "cpu":
        return plist_super_reference(key, sid, bits, rows, dir_t, t0,
                                     win_rows=win_rows)
    if device.type != "cuda":
        raise ValueError(f"plist_super: no kernel for device {device}")
    out = _launch("plist_super_launch", "plist_super", key, sid, bits, rows,
                  (dir_t,), t0, win_rows)
    plist_super.launches += 1
    return out


plist_super.launches = 0


def plist_super_mt(key, sid, bits, rows, orig_t, dir_t, t0, *,
                   win_rows: int):
    """Nearest Moller-Trumbore hit of every ray over its bundle's sorted
    super list (K1'; replaces clpathtracer_tpu/ops/plist.py::
    _kernel_plist_super with so=False).

    key/sid/bits: [G, Ls] from _bundle_lists or gate_lists_super; rows:
    [S, 16] raw triangle records (v0, e1, e2, tri_id); orig_t/dir_t:
    [3, G*512] per-lane origins and directions (dead lanes: direction 0);
    t0: [G*512] per-lane t upper-bound seeds (BIG for a live ray, 0 for a
    dead one). Hits need det > 0 (front faces), 0 <= u, v, u + v <= 1,
    t > 0 and tri_id >= 0.

    Returns (best_t, best_slot, stats) as plist_super does; ties in t go to
    the lowest slot. A CPU tensor runs the plain version
    (plist_super_mt_reference); a CUDA tensor launches
    ops/csrc/plist_super.cu on the current stream or raises.
    `plist_super_mt.launches` counts kernel launches."""
    _check_plist_super_args("plist_super_mt", key, sid, bits, rows, dir_t,
                            t0, win_rows, orig_t)
    device = key.device
    if device.type == "cpu":
        return plist_super_mt_reference(key, sid, bits, rows, orig_t, dir_t,
                                        t0, win_rows=win_rows)
    if device.type != "cuda":
        raise ValueError(f"plist_super_mt: no kernel for device {device}")
    out = _launch("plist_super_mt_launch", "plist_super_mt", key, sid, bits,
                  rows, (orig_t, dir_t), t0, win_rows)
    plist_super_mt.launches += 1
    return out


plist_super_mt.launches = 0


def _so_test(recs, d):
    """Plain SO test of K1: t per (gate ray, record), BIG where rejected."""
    def test(g, win):
        r = recs[win][:, None]                             # [A, 1, win, 10]
        return so_pairs(r, *(d[ax, g][:, :, None] for ax in range(3)))
    return test


def _mt_test(recs, o, d, tally=None):
    """Plain MT test of K1': t per (bundle ray, record), BIG where
    rejected. tally: see plist_super_mt_reference."""
    def test(g, win):
        r = recs[win][:, None]                             # [A, 1, win, 10]
        return mt_pairs(r, *(o[ax, g][:, :, None] for ax in range(3)),
                        *(d[ax, g][:, :, None] for ax in range(3)), tally)
    return test


def plist_super_reference(key, sid, bits, rows, dir_t, t0, *, win_rows: int):
    """Plain torch version of plist_super: same signature, same outputs,
    stats included, on any device."""
    win_tris = win_rows * 8
    recs = rows.reshape(-1, win_tris, 16)[:, :, :10]     # [W, win_tris, 10]
    d = dir_t.reshape(3, key.shape[0], GATE)
    return _reference(key, sid, bits, _so_test(recs, d), t0, win_tris)


def plist_super_mt_reference(key, sid, bits, rows, orig_t, dir_t, t0, *,
                             win_rows: int, tally=None):
    """Plain torch version of plist_super_mt: same signature, same
    outputs, stats included, on any device.

    tally (optional int64 [3] tensor on the device): adds the counts of the
    tested (ray, record) pairs that pass det > 0, then also 0 <= u <= 1,
    then also v >= 0 and u + v <= 1: the kernel's early exits, which set
    the work these inputs need."""
    win_tris = win_rows * 8
    recs = rows.reshape(-1, win_tris, 16)[:, :, :10]     # [W, win_tris, 10]
    o = orig_t.reshape(3, key.shape[0], GATE)
    d = dir_t.reshape(3, key.shape[0], GATE)
    return _reference(key, sid, bits, _mt_test(recs, o, d, tally), t0,
                      win_tris)


def _reference(key, sid, bits, test, t0, win_tris):
    """The stream loop of both plain versions. test(g, win) gives the
    accept mask and t [A, GATE, win_tris] of gates g [A] against windows
    win [A].

    Vectorised over gates, in chunks of gates to bound memory. All gates
    still alive at step j have consumed exactly j entries, so the chunk
    steps the sorted entries together with a per-gate alive mask, which
    reproduces the kernel's break and so its stats."""
    n_gates = key.shape[0]
    t0g = t0.reshape(n_gates, GATE)
    best_t = torch.empty((n_gates, GATE), dtype=torch.float32,
                         device=key.device)
    best_slot = torch.empty((n_gates, GATE), dtype=torch.int32,
                            device=key.device)
    stats = torch.zeros((n_gates, 5), dtype=torch.int32, device=key.device)
    chunk = max(1, _REF_PAIRS // (GATE * win_tris))
    for g0 in range(0, n_gates, chunk):
        g1 = min(g0 + chunk, n_gates)
        bt, bs, ns, nw = _reference_gates(
            key, sid, bits, g0, g1, test, t0g[g0:g1], win_tris)
        best_t[g0:g1] = bt
        best_slot[g0:g1] = torch.where(bt < BIG, bs, -1)
        stats[g0:g1, 1] = nw
        stats[g0:g1, 2] = GATE
        stats[g0:g1, 3] = ns
        stats[g0:g1, 4] = nw
    return best_t.reshape(-1), best_slot.reshape(-1), stats


def _reference_gates(key, sid, bits, g0, g1, test, t0g, win_tris):
    key, sid, bits = key[g0:g1], sid[g0:g1], bits[g0:g1]
    m, list_len = key.shape
    dev = key.device
    bt = torch.full((m, GATE), BIG, device=dev)
    bs = torch.full((m, GATE), _INT_MAX, dtype=torch.int32, device=dev)
    ns = torch.zeros((m,), dtype=torch.int32, device=dev)
    nw = torch.zeros((m,), dtype=torch.int32, device=dev)
    tup = torch.clamp(t0g.amax(dim=1), max=BIG)
    alive = (key[:, 0] <= tup if list_len
             else torch.zeros((m,), dtype=torch.bool, device=dev))
    slot_in_win = torch.arange(win_tris, dtype=torch.int32, device=dev)
    j = 0
    while bool(alive.any()):
        a = alive.nonzero().squeeze(1)
        s = sid[a, j]
        b = bits[a, j]
        for k in range(SUPER):
            need = ((b >> k) & 1).bool()
            nw[a] += need.to(torch.int32)
            if not bool(need.any()):
                continue
            g = a[need]
            win = s[need].long() * SUPER + k
            ok, t_m = test(g + g0, win)                      # [A, GATE, win]
            slot = (win[:, None].to(torch.int32) * win_tris
                    + slot_in_win)[:, None, :]
            s_m = torch.where(ok, slot, _INT_MAX)
            t_min = t_m.amin(dim=2)
            s_min = torch.where(t_m == t_min[..., None], s_m,
                                _INT_MAX).amin(dim=2)
            take = (t_min < bt[g]) | ((t_min == bt[g]) & (s_min < bs[g]))
            bt[g] = torch.where(take, t_min, bt[g])
            bs[g] = torch.where(take, s_min, bs[g])
        ns[a] += 1
        tup[a] = torch.minimum(bt[a], t0g[a]).amax(dim=1)
        j += 1
        if j == list_len:
            break
        alive[a] = key[a, j] <= tup[a]
    return bt, bs, ns, nw


# ---------------------------------------------------------------------------
# host entry and winner resolution
# ---------------------------------------------------------------------------


def traverse_plist(mwin: MortonWindows, orig, dir, image_shape,
                   dilate_px: float = 0.0):
    """Trace shared-origin pixel-grid primary rays (generate_rays order)
    through the super-list engine. orig/dir: [H*W, 3], every origin equal
    to orig[0]; dilate_px: a bound on the rays' subpixel jitter plus slack
    (0 for pixel-grid rays; see _win_keys). With shared-origin tables
    attached the gates run K1, else K1' on the raw records. Returns the hit
    record: hit, t, tri, u, v, snormal, salbedo, semission ([H*W] /
    [H*W, 3]) and tile_stats [G, 5]."""
    h, w = image_shape
    n = orig.shape[0]
    if n != h * w or h % GH or w % GW:
        raise NotImplementedError(
            f"traverse_plist needs an {h}x{w} frame of {n} rays that "
            f"divides into {GH}x{GW} gates; other frames are not ported")
    o = orig[0]
    dir_b = _blockify(dir, h, w, GH, GW).to(torch.float32)
    key, sid, bits = gate_lists_super(mwin.win_bnd, dir_b, o, dilate_px)
    t0 = torch.full((n,), BIG, device=dir.device)
    if mwin.so_base is not None:
        _, best_slot, tile_stats = plist_super(
            key, sid, bits, so_combine(mwin.so_base, o),
            dir_b.T.contiguous(), t0, win_rows=mwin.win_rows)
    else:
        orig_b = _blockify(orig, h, w, GH, GW).to(torch.float32)
        _, best_slot, tile_stats = plist_super_mt(
            key, sid, bits, mwin.tris, orig_b.T.contiguous(),
            dir_b.T.contiguous(), t0, win_rows=mwin.win_rows)
    best_slot = _unblockify(best_slot, h, w, GH, GW)
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
            "is not ported yet: ROADMAP queue 1 item 7")
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
