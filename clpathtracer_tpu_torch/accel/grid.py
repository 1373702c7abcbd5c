"""Uniform grid for fog-like scenes (port of clpathtracer_tpu/accel/grid.py,
its inline layout).

The kd-tree and the windows suit surface meshes, whose density varies by
orders of magnitude. A scene of uniformly scattered small triangles (the
"fog" soup) is the textbook case for a uniform grid: the cell of a point
is arithmetic, floor((p - lo) / h), the 3-D DDA walk (ops/grid_walk.py)
needs no node table, and nearest and any-hit queries in dense fog settle
within a few cells.

The host build is the JAX package's numpy code, so the same vertices give
the same table bit for bit. Triangles are binned into every cell their
AABB overlaps; the walk's per-cell t-window makes the duplicates harmless.
The table is one [C + S, 128] f32 array, C = rx*ry*rz cell rows and S
spill rows:

  * row cid < C (cell (x, y, z) at cid = (x*ry + y)*rz + z): record slot 0
    holds (first spill row, triangle count), slots 1..7 the cell's first 7
    triangles;
  * rows >= C: 8 triangles each, for cells with more than 7.

A record is 16 floats (v0, e1, e2, tri_id, pad), the layout of
accel/sah.py::pack_quads_host; tri_id -1 marks an empty slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clpathtracer_tpu_torch.core.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class UniformGrid(TensorStruct):
    """A uniform grid on the device (the inline layout).

    table: [C + S, 128] f32 rows (module docstring).
    lo, hi: [3] f32 grid AABB; h: [3] f32 cell size; res: (rx, ry, rz).
    """

    table: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    h: torch.Tensor
    res: tuple = (1, 1, 1)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.res))

    def stats(self) -> dict:
        """The JAX package's UniformGrid.stats() for the inline layout."""
        c = self.num_cells
        counts = self.table[:c, 1].cpu().numpy()
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
            "spill_rows": int(self.table.shape[0] - c),
            "mem_mb": float(self.table.numel() * 4 / 1e6),
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
    min(2^23, max(8F, 4096)) in all. layout: "inline" only; the JAX
    package's "split" layout (meta + quad tables) is not ported (ROADMAP
    queue 1 item 3)."""
    if layout != "inline":
        raise NotImplementedError(
            f"build_grid(layout={layout!r}): only the inline layout is "
            "ported; the split layout and its walk are ROADMAP queue 1 "
            "item 3")
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

    def dev(x):
        return torch.as_tensor(x, device=device)
    return UniformGrid(table=dev(records.reshape(nrows, 128)), lo=dev(lo),
                       hi=dev(hi), h=dev(h), res=res)
