"""Uniform grid for fog-like scenes (port of clpathtracer_tpu/accel/grid.py).

The kd-tree and the windows suit surface meshes, whose density varies by
orders of magnitude. A scene of uniformly scattered small triangles (the
"fog" soup) is the textbook case for a uniform grid: the cell of a point
is arithmetic, floor((p - lo) / h), the 3-D DDA walk (ops/grid_walk.py)
needs no node table, and nearest and any-hit queries in dense fog settle
within a few cells.

The host build is the JAX package's numpy code, so the same vertices give
the same tables bit for bit. Triangles are binned into every cell their
AABB overlaps; the walk's per-cell t-window makes the duplicates harmless.
Cell (x, y, z) has the id cid = (x*ry + y)*rz + z, C = rx*ry*rz cells.
Two layouts, both walked by ops/grid_walk.py::traverse_grid:

  * "inline" (the default): one [C + S, 128] f32 table of C cell rows and
    S spill rows. Row cid holds in record slot 0 (first spill row,
    triangle count) and in slots 1..7 the cell's first 7 triangles; rows
    >= C hold 8 triangles each, for cells with more than 7;
  * "split": cells [C, 8] f32 rows (quad start, triangle count, pad) and
    quads [Q, 64] f32 rows of QBLOCK = 4 records. Each cell's list is
    padded to a multiple of 4 and starts at quad row `quad start`.

A record is 16 floats (v0, e1, e2, tri_id, pad), the layout of
accel/sah.py::pack_quads_host; tri_id -1 marks an empty slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clpathtracer_tpu_torch.accel.sah import pack_quads_host
from clpathtracer_tpu_torch.core.struct import TensorStruct

QBLOCK = 4  # records a quad row of the split layout
LAYOUTS = ("inline", "split")


@dataclasses.dataclass(frozen=True)
class UniformGrid(TensorStruct):
    """A uniform grid on the device, in one of two layouts (module
    docstring): table set (inline) or cells and quads set (split).

    lo, hi: [3] f32 grid AABB; h: [3] f32 cell size; res: (rx, ry, rz).
    table: [C + S, 128] f32 rows (inline), else None.
    cells: [C, 8] f32 meta rows, quads: [Q, 64] f32 quad rows (split),
    else None.
    """

    lo: torch.Tensor
    hi: torch.Tensor
    h: torch.Tensor
    table: torch.Tensor = None
    cells: torch.Tensor = None
    quads: torch.Tensor = None
    res: tuple = (1, 1, 1)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.res))

    @property
    def layout(self) -> str:
        return "inline" if self.table is not None else "split"

    def stats(self) -> dict:
        """The JAX package's UniformGrid.stats(): entries counted the same
        way in both layouts, then spill_rows (inline) or quad_rows
        (split) and the tables' MB."""
        c = self.num_cells
        if self.table is not None:
            counts = self.table[:c, 1].cpu().numpy()
            extra = {"spill_rows": int(self.table.shape[0] - c),
                     "mem_mb": float(self.table.numel() * 4 / 1e6)}
        else:
            counts = self.cells[:, 1].cpu().numpy()
            extra = {"quad_rows": int(self.quads.shape[0]),
                     "mem_mb": float((self.quads.numel()
                                      + self.cells.numel()) * 4 / 1e6)}
        occupied = counts > 0
        entries = float(counts.sum())
        return {
            "res": tuple(self.res),
            "cells": int(counts.shape[0]),
            "occupied_frac": float(occupied.mean()),
            "entries": int(entries),
            "avg_tris_per_occupied_cell": float(
                entries / max(occupied.sum(), 1)),
            "max_tris_per_cell": int(counts.max(initial=0)),
            **extra,
        }


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros_like(a)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _records16(idx: np.ndarray, tv: np.ndarray) -> np.ndarray:
    """Per-triangle 16-float records (v0, e1, e2, tri_id, pad)."""
    a = tv[idx, 0]
    r = np.zeros((idx.shape[0], 16), np.float32)
    r[:, 0:3] = a
    r[:, 3:6] = tv[idx, 1] - a
    r[:, 6:9] = tv[idx, 2] - a
    r[:, 9] = idx.astype(np.float32)
    return r


def fog_likeness(tri_verts: np.ndarray, res: int = 24) -> float:
    """Scene-uniformity score in [0, 1]: the fraction of the cells of a
    coarse res^3 grid over the centroids' AABB that hold a centroid. Fog
    fills most of its box (near 1); a surface mesh sweeps a 2-D sheet
    (about 1/res)."""
    tv = np.asarray(tri_verts, np.float32)
    c = tv.mean(axis=1)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-6)
    cell = np.clip((c - lo) / ext * res, 0, res - 1).astype(np.int64)
    cid = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
    return float(np.unique(cid).size / res ** 3)


def build_grid(tri_verts: np.ndarray, res=None, density: float = 1.0,
               layout: str = "inline", *, device) -> UniformGrid:
    """Bin triangles into a uniform grid on the host (vectorised numpy) and
    put the table on `device`.

    tri_verts: [F, 3, 3] corners (Scene.tri_corners). res: per-axis cell
    counts; by default about `density` triangles a cell, cells as close to
    cubes as the scene AABB allows, at most 512 a side and
    min(2^23, max(8F, 4096)) in all. layout: "inline" (one 128-float row
    table) or "split" (meta rows and quad rows); see the module
    docstring."""
    if layout not in LAYOUTS:
        raise ValueError(f"build_grid: layout {layout!r} is not one of "
                         f"{LAYOUTS}")
    tv = np.asarray(tri_verts, np.float32)
    f = tv.shape[0]
    if f == 0:
        raise ValueError("build_grid: empty scene")
    tmin = tv.min(axis=1)
    tmax = tv.max(axis=1)
    lo = tmin.min(axis=0)
    hi = tmax.max(axis=0)
    ext = np.maximum(hi - lo, 1e-6)
    pad = 1e-4 * ext
    lo = (lo - pad).astype(np.float32)
    hi = (hi + pad).astype(np.float32)
    ext = hi - lo

    if res is None:
        # cells ~ f / density shaped to the AABB: r_a = ext_a * k with
        # prod(r) = f / density, k = (f / (density * V))^(1/3)
        k = (f / (density * float(np.prod(ext)))) ** (1.0 / 3.0)
        res = np.maximum(1, np.minimum(
            512, np.round(ext * k))).astype(np.int64)
        cap = min(1 << 23, max(8 * f, 1 << 12))
        over = float(np.prod(res)) / cap
        if over > 1.0:
            res = np.maximum(1, np.floor(
                res / over ** (1.0 / 3.0))).astype(np.int64)
    res = tuple(int(r) for r in np.broadcast_to(res, (3,)))
    rx, ry, rz = res
    ncells = rx * ry * rz
    if ncells >= 1 << 24:
        raise ValueError(f"build_grid: {res} = {ncells} cells overflow "
                         "f32-exact row ids; lower the resolution")
    h = (ext / np.asarray(res, np.float32)).astype(np.float32)
    inv_h = 1.0 / h

    # per-triangle overlapped cell ranges from its AABB (conservative)
    clo = np.clip(np.floor((tmin - lo) * inv_h).astype(np.int64), 0,
                  np.asarray(res) - 1)
    chi = np.clip(np.floor((tmax - lo) * inv_h).astype(np.int64), 0,
                  np.asarray(res) - 1)
    spans = chi - clo + 1                       # [F, 3]
    counts = spans.prod(axis=1)                 # [F]
    total = int(counts.sum())

    # (triangle, cell) entries: entry j of triangle i enumerates its span
    # box z fastest
    tid = np.repeat(np.arange(f, dtype=np.int64), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        _exclusive_cumsum(counts), counts)
    sy = np.repeat(spans[:, 1], counts)
    sz = np.repeat(spans[:, 2], counts)
    oz = within % sz
    oy = (within // sz) % sy
    ox = within // (sz * sy)
    cx = np.repeat(clo[:, 0], counts) + ox
    cy = np.repeat(clo[:, 1], counts) + oy
    cz = np.repeat(clo[:, 2], counts) + oz
    cellid = (cx * ry + cy) * rz + cz

    order = np.argsort(cellid, kind="stable")
    cellid_s = cellid[order]
    tid_s = tid[order]
    starts = np.searchsorted(cellid_s, np.arange(ncells, dtype=np.int64))
    ccount = np.diff(np.append(starts, total))


    def dev(x):
        return torch.as_tensor(x, device=device)
    geom = dict(lo=dev(lo), hi=dev(hi), h=dev(h), res=res)
    if layout == "split":
        # each cell's list padded to a multiple of QBLOCK, in quad rows
        padded = -(-ccount // QBLOCK) * QBLOCK
        pstart = _exclusive_cumsum(padded)
        total_padded = int(padded.sum())
        if total_padded // QBLOCK >= 1 << 24:
            raise ValueError(f"build_grid: {total_padded} entries overflow "
                             "f32-exact quad ids; lower the resolution")
        tri_slots = np.full(total_padded, -1, np.int32)
        dest = pstart[cellid_s] + (np.arange(total, dtype=np.int64)
                                   - starts[cellid_s])
        tri_slots[dest] = tid_s.astype(np.int32)
        cells = np.zeros((ncells, 8), np.float32)
        cells[:, 0] = (pstart // QBLOCK).astype(np.float32)
        cells[:, 1] = ccount.astype(np.float32)
        quads = pack_quads_host(tri_slots, tv).reshape(-1, 64)
        return UniformGrid(cells=dev(cells), quads=dev(quads), **geom)

    spill_rows = -(-np.maximum(ccount - 7, 0) // 8)
    srow0 = ncells + _exclusive_cumsum(spill_rows)
    nrows = int(ncells + spill_rows.sum())
    if nrows >= 1 << 24:
        raise ValueError(f"build_grid: {nrows} rows overflow f32-exact row "
                         "ids; lower the resolution")
    # per-entry destination record (the table viewed as [nrows*8, 16])
    within = np.arange(total, dtype=np.int64) - starts[cellid_s]
    is_inl = within < 7
    rec = np.where(
        is_inl,
        cellid_s * 8 + within + 1,                           # slots 1..7
        (srow0[cellid_s] + (within - 7) // 8) * 8 + (within - 7) % 8)
    records = np.zeros((nrows * 8, 16), np.float32)
    records[:, 9] = -1.0                                      # pad tri_id
    records[rec] = _records16(tid_s.astype(np.int32), tv)
    records[np.arange(ncells) * 8, 0] = srow0.astype(np.float32)
    records[np.arange(ncells) * 8, 1] = ccount.astype(np.float32)
    return UniformGrid(table=dev(records.reshape(nrows, 128)), **geom)
