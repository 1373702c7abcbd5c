"""3-D DDA through a uniform grid (port of clpathtracer_tpu/ops/grid_walk.py).

Per ray: the slab entry into the grid's box, then one step per row of the
cell's list. In the inline layout a step reads a table row: the cell's row
(its first 7 triangles), then its spill rows (8 each). In the split layout
(the JAX package's body_split) it reads one quad row of 4 triangles, the
cell's meta row (quad start, count) giving where the list starts; the
offset inside the cell advances by 4. When a cell's list is done, the DDA
advances to the next cell on the axis whose boundary crossing t is least.
Moller-Trumbore with the det > 0 backface cull
(ops/traverse_fast.py::_mt_pre). A ray is settled once its best hit is at
or inside the current cell's exit (every later cell starts beyond it);
with t_max, once the exit reaches the bound; with any_hit, at the first
row with an accepted hit below t_max. Ties: the last minimum within a row,
and a later row's equal t wins over an earlier one's.

On the GPU this is kernel G1 (ops/csrc/grid_dda.cu): 4 threads a ray, a
row's loads issued together and the next row prefetched, a persistent
grid that takes rays from a counter (one int32 the wrapper zeroes); its
split form reads a cell's meta row once and then one record a thread of
each quad row.
The JAX package's walk is XLA, not a Pallas kernel; here it is
hand-written because the lockstep wavefront as torch ops costs hundreds
of full-width launches a wave. On the CPU the wrapper runs the plain
version, that lockstep wavefront in torch ops. The JAX package's
geometric wind-down compaction (an XLA schedule that changes no lane's
result or steps) and its CLPT_GRID_CHUNK, CLPT_GRID_MIN and CLPT_GRID_FRAC
knobs are not ported.
"""

from __future__ import annotations

import torch

from clpathtracer_tpu_torch.accel.grid import QBLOCK
from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre

BIG = 3.4e38


def _check(grid, orig, dir, t_max, active):
    n = orig.shape[0]
    if orig.shape != (n, 3) or dir.shape != (n, 3) \
            or orig.dtype != torch.float32 or dir.dtype != torch.float32:
        raise ValueError(f"traverse_grid: orig {tuple(orig.shape)} "
                         f"{orig.dtype} and dir {tuple(dir.shape)} "
                         f"{dir.dtype} must be [N, 3] float32")
    if t_max is not None and (t_max.shape != (n,)
                              or t_max.dtype != torch.float32):
        raise ValueError(f"traverse_grid: t_max {tuple(t_max.shape)} "
                         f"{t_max.dtype} is not [{n}] float32")
    if active is not None and (active.shape != (n,)
                               or active.dtype != torch.bool):
        raise ValueError(f"traverse_grid: active {tuple(active.shape)} "
                         f"{active.dtype} is not [{n}] bool")
    devices = {t.device for t in (grid.table, grid.cells, grid.quads, orig,
                                  dir, t_max, active) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"traverse_grid: tensors on several devices "
                         f"{devices}")


def traverse_grid(grid, orig, dir, *, max_iters: int = 16384, t_max=None,
                  active=None, any_hit: bool = False):
    """Trace a wave through a UniformGrid (accel/grid.py).

    orig/dir: [N, 3] f32. t_max: optional [N] f32 per-ray bound (hits at
    or beyond it are ignored; a ray stops once its cell's exit reaches
    it). active: optional [N] bool, dead lanes never walk. any_hit: stop at
    the first accepted hit below t_max (needs t_max); hit is exact, t/tri
    describe a hit. A ray stops after max_iters rows.

    Returns the record hit [N] bool, t [N] (BIG on a miss), tri [N] i32
    (-1), u, v [N] (0 on a miss), steps [N] i32 (rows read).

    The walk is the grid's layout's (grid.layout). A CPU tensor runs the
    plain version (traverse_grid_reference); a CUDA tensor launches G1
    (ops/csrc/grid_dda.cu), its inline or its split form, on the current
    stream or raises. `traverse_grid.launches` counts launches of the
    inline form, `traverse_grid.split_launches` of the split form."""
    if any_hit and t_max is None:
        raise ValueError("traverse_grid: any_hit needs t_max")
    _check(grid, orig, dir, t_max, active)
    device = orig.device
    if device.type == "cpu":
        return traverse_grid_reference(grid, orig, dir, max_iters=max_iters,
                                       t_max=t_max, active=active,
                                       any_hit=any_hit)
    if device.type != "cuda":
        raise ValueError(f"traverse_grid: no kernel for device {device}")
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    split = grid.table is None
    fns = load_kernels().fns
    n = orig.shape[0]
    orig, dir = orig.contiguous(), dir.contiguous()
    geom = torch.cat([grid.lo, grid.hi, grid.h]).to(torch.float32)
    t = torch.empty((n,), dtype=torch.float32, device=device)
    tri = torch.empty((n,), dtype=torch.int32, device=device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    steps = torch.empty_like(tri)
    next_ray = torch.zeros((1,), dtype=torch.int32, device=device)
    act = None if active is None else active.contiguous().to(torch.uint8)
    tm = None if t_max is None else t_max.contiguous()
    rx, ry, rz = grid.res
    tables = ((grid.cells.data_ptr(), grid.quads.data_ptr()) if split
              else (grid.table.data_ptr(),))
    n_rows = (grid.quads if split else grid.table).shape[0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fns["grid_dda_split_launch" if split else "grid_dda_launch"](
            *tables, geom.data_ptr(), orig.data_ptr(), dir.data_ptr(),
            0 if tm is None else tm.data_ptr(),
            0 if act is None else act.data_ptr(), t.data_ptr(),
            tri.data_ptr(), u.data_ptr(), v.data_ptr(), steps.data_ptr(),
            next_ray.data_ptr(), n, rx, ry, rz, n_rows, max_iters,
            int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"traverse_grid launch failed: cudaError {err} "
                           f"(N={n}, res={grid.res}, {grid.layout})")
    if split:
        traverse_grid.split_launches += 1
    else:
        traverse_grid.launches += 1
    return {"hit": tri >= 0, "t": t, "tri": tri, "u": u, "v": v,
            "steps": steps}


traverse_grid.launches = 0
traverse_grid.split_launches = 0


def traverse_grid_reference(grid, orig, dir, *, max_iters: int = 16384,
                            t_max=None, active=None, any_hit: bool = False,
                            tally=None):
    """Plain torch version of traverse_grid, the JAX package's lockstep
    wavefront without its wind-down compaction: same arguments, same
    record, steps included, on any device. The arithmetic is the JAX
    package's and G1's, one rounding per operation in the same order.

    tally (optional int64 [5] tensor on the device): adds the count of
    the tested (ray, record) pairs, then of those that pass det > 0, then
    also the u test, then also the v test: the early exits of G1's pair
    test, which set the work these inputs need; then the table bytes G1's
    loads read: the cell's meta, 16 (its record) on an inline cell row or
    8 (quad start and count) on a split cell's first quad row, and 48
    (cols 0-11) for each record of the cell's list the row holds."""
    n = orig.shape[0]
    dev = orig.device
    rx, ry, rz = grid.res
    ncells = rx * ry * rz
    split = grid.table is None
    if split:
        quads = grid.quads.reshape(-1, QBLOCK, 16)
        nrows = quads.shape[0]
        width = QBLOCK            # records a step tests
    else:
        table = grid.table
        nrows = table.shape[0]
        recs = table.reshape(nrows * 8, 16)
        width = 8
    glo, ghi, gh = grid.lo[None], grid.hi[None], grid.h[None]

    # slab entry into the grid's box; a dir == 0 axis gets the origin-in-
    # slab answer directly ((b - o) * inf would be NaN on a slab plane)
    inv_d = 1.0 / dir
    t_lo = (glo - orig) * inv_d
    t_hi = (ghi - orig) * inv_d
    d0 = dir == 0
    in_slab = (orig >= glo) & (orig <= ghi)
    t_near = torch.where(d0, torch.where(in_slab, -BIG, BIG),
                         torch.minimum(t_lo, t_hi))
    t_far = torch.where(d0, torch.where(in_slab, BIG, -BIG),
                        torch.maximum(t_lo, t_hi))
    t_en = t_near.amax(dim=1)
    t_ex = t_far.amin(dim=1)
    t0 = torch.clamp(t_en, min=0.0)
    act = (t_ex >= t0) & (t_ex > 0.0)
    if active is not None:
        act = act & active
    if t_max is not None:
        act = act & (t0 < t_max)

    p = orig + t0[:, None] * dir
    cellf = torch.floor((p - glo) / gh)
    cellf = torch.where(act[:, None], cellf, 0.0)
    cell = torch.stack([cellf[:, a].clamp(0, r - 1)
                        for a, r in enumerate(grid.res)],
                       dim=1).to(torch.int32)
    step = torch.sign(dir).to(torch.int32)
    next_b = glo + (cell + (dir > 0)).to(torch.float32) * gh
    t_next = torch.where(d0, BIG, (next_b - orig) * inv_d)
    dt = torch.where(d0, BIG, gh * inv_d.abs())

    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    row = (cell[:, 0] * ry + cell[:, 1]) * rz + cell[:, 2]
    offset, count, spill, steps = zi, zi, zi, zi
    best_t = (torch.full((n,), BIG, device=dev) if t_max is None
              else t_max.clone())
    best_tri = zi - 1
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    j = torch.arange(width, device=dev)
    res_t = torch.tensor(grid.res, dtype=torch.int32, device=dev)

    for _ in range(max_iters):
        if not bool(act.any()):
            break
        if split:
            # the cell's meta row, then its quad row at offset // 4
            cid = (cell[:, 0] * ry + cell[:, 1]) * rz + cell[:, 2]
            meta = grid.cells[cid.clamp(0, ncells - 1).long(), 0:2]
            count = meta[:, 1].to(torch.int32)
            qidx = meta[:, 0].to(torch.int32) + offset // QBLOCK
            blk = quads[qidx.clamp(0, nrows - 1).long()]          # [n, 4, 16]
            held = ((offset[:, None] + j) < count[:, None]) & act[:, None]
            fresh, meta_bytes = act & (offset == 0), 8
        else:
            ridx = row.clamp(0, nrows - 1).long()
            at_cell = row < ncells
            meta = table[ridx, 0:2]
            count = torch.where(at_cell, meta[:, 1].to(torch.int32), count)
            spill = torch.where(at_cell, meta[:, 0].to(torch.int32), spill)
            # a cell row tests its slots 1..7, a spill row 0..7
            slots = ridx[:, None] * 8 + torch.where(
                at_cell[:, None], torch.clamp(j + 1, max=7), j)
            blk = recs[slots]                                   # [n, 8, 16]
            held = (((offset[:, None] + j) < count[:, None]) & act[:, None]
                    & (~at_cell[:, None] | (j < 7)))
            fresh, meta_bytes = act & at_cell, 16
        tid = blk[..., 9].to(torch.int32)
        valid = held & (tid >= 0)
        ok, t, u, v = _mt_pre(blk[..., 0:3], blk[..., 3:6], blk[..., 6:9],
                              orig[:, None, :], dir[:, None, :])
        if tally is not None:
            tally[:4] += _mt_exits(blk, orig, dir, valid)
            tally[4] += meta_bytes * fresh.sum() + 48 * held.sum()
        t_m = torch.where(ok & valid, t, BIG)
        # the row's last minimum, taken on <= over the rows before it
        bt = t_m.amin(dim=1)
        k = (width - 1 - torch.argmin(t_m.flip(1), dim=1))[:, None]
        take = (bt < BIG) & (bt <= best_t)
        if t_max is not None:
            take = take & (bt < t_max)
        best_t = torch.where(take, bt, best_t)
        best_tri = torch.where(take, tid.gather(1, k)[:, 0], best_tri)
        best_u = torch.where(take, u.gather(1, k)[:, 0], best_u)
        best_v = torch.where(take, v.gather(1, k)[:, 0], best_v)

        offset_next = offset + (QBLOCK if split else torch.where(
            at_cell, 7, 8).to(torch.int32))
        cell_done = offset_next >= count
        t_exit = t_next.amin(dim=1)
        settled = (best_tri >= 0) & (best_t <= t_exit)
        if t_max is not None:
            settled = settled | (t_exit >= t_max)
        tn0, tn1, tn2 = t_next.unbind(1)
        on0 = tn0 <= torch.minimum(tn1, tn2)
        on1 = ~on0 & (tn1 <= tn2)
        on = torch.stack([on0, on1, ~on0 & ~on1], dim=1)
        c_new = cell + torch.where(on, step, 0)
        tn_new = t_next + torch.where(on, dt, 0.0)
        out = ((c_new < 0) | (c_new >= res_t)).any(dim=1)
        adv = act & cell_done
        cell = torch.where(adv[:, None], c_new, cell)
        t_next = torch.where(adv[:, None], tn_new, t_next)
        if not split:
            cid_new = (c_new[:, 0] * ry + c_new[:, 1]) * rz + c_new[:, 2]
            row_stay = spill + (offset_next - 7) // 8
            row = torch.where(adv, cid_new, torch.where(act, row_stay, row))
        offset = torch.where(act & ~cell_done, offset_next, 0)
        steps = steps + act.to(torch.int32)
        act = act & ~(cell_done & (settled | out))
        if any_hit:
            act = act & ~take

    hit = best_tri >= 0
    return {"hit": hit, "t": torch.where(hit, best_t, BIG),
            "tri": torch.where(hit, best_tri, -1),
            "u": torch.where(hit, best_u, 0.0),
            "v": torch.where(hit, best_v, 0.0), "steps": steps}


def _mt_exits(blk, orig, dir, valid):
    """Counts of the tested pairs `valid` [n, 8] of records blk [n, 8, 16]
    and of those that pass det > 0, then the u test, then the v test."""
    e1, e2 = blk[..., 3:6], blk[..., 6:9]
    d = dir[:, None, :]
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    c1 = valid & (det > 0.0)
    inv_det = 1.0 / det.masked_fill(det == 0.0, 1.0)
    tvec = orig[:, None, :] - blk[..., 0:3]
    u = vm.dot(tvec, pvec) * inv_det
    c2 = c1 & (u >= 0.0) & (u <= 1.0)
    v = vm.dot(d, vm.cross(tvec, e1)) * inv_det
    c3 = c2 & (v >= 0.0) & (u + v <= 1.0)
    return torch.stack([c.sum() for c in (valid, c1, c2, c3)])
