"""SAH kd-tree for the packet stream engine, and host-side triangle record
packing (the port's part of clpathtracer_tpu/accel/sah.py).

The tree comes from the native C++ builder (accel/native), whose packed
[M, 24] node table is the layout the JAX package's stream engine reads.
On top of it sit the stream engine's tables:

* each leaf's triangle list reordered by the Morton code of the
  centroids inside the leaf box (sort_leaf_tris_spatial), so that the
  leaf's consecutive 128-record windows cover compact sub-volumes;
* per-window AABBs on the kernel's clamped window grid (chunk_bounds_host,
  attach_chunk_info), which the kernel and the strip prepass cull against;
* the affine shared-origin tables (attach_so_tables).

The numpy arithmetic is the JAX package's own, so both packages build the
same tree, the same records and the same tables from the same triangles.
The 8-wide supernode table of the wide packet walk (accel/wide.py) is
attached as the JAX package attaches it, for leaf_size >= 8. The JAX
package's Python builder (_build_recursive, _add_ropes) and its other
attachments (Morton windows, grid, shadow tree) are not ported here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clpathtracer_tpu_torch.core.struct import TensorStruct

DEFAULT_DEPTH = 15  # reference DEPTH (src/kd_tree.c:8)
# records per window row group: a window is CHUNK_ROWS rows of 8 records
# (128 triangles); the kernel, the cull tables and the strip prepass share
# this grid
CHUNK_ROWS = 16


@dataclasses.dataclass(frozen=True)
class FlatKdTree(TensorStruct):
    """The kd-tree and the stream engine's tables, as tensors on one
    device.

    node_table: [M, 24] f32 packed nodes (lo xyz, hi xyz, split value,
      flags = axis + 4*is_leaf, child_lo, child_hi, quad start, triangle
      count, ropes[6], pad); node 0 is the root, preorder.
    tri_indices: [T] i32 leaf triangle lists, each padded to a multiple of
      4 with -1.
    node_min, node_max: [M, 3] f32; is_leaf: [M] bool; leaf_start /
      leaf_count: [M] i32 (first record and triangle count of a leaf).
    tris: [T, 16] f32 records (v0, e1, e2, tri_id, pad 6), one per entry
      of tri_indices; the row index is the slot the kernels return.
    chunk_start: [M] i32 first window of each leaf in chunk_bnd.
    chunk_bnd: [W, 6] f32 window AABBs (lo xyz, hi xyz); a window without
      a real triangle carries an inverted box (+3.4e38 / -3.4e38).
    so_base: optional [4, Tp, 16] shared-origin tables over the padded
      records (attach_so_tables).
    wide_table: optional [S, 128] f32 8-wide supernode rows
      (accel/wide.py::build_wide_table) of the wide packet walk.
    max_leaf_tris: the largest leaf's triangle count.
    """

    node_table: torch.Tensor
    tri_indices: torch.Tensor
    node_min: torch.Tensor
    node_max: torch.Tensor
    is_leaf: torch.Tensor
    leaf_start: torch.Tensor
    leaf_count: torch.Tensor
    tris: torch.Tensor
    chunk_start: torch.Tensor = None
    chunk_bnd: torch.Tensor = None
    so_base: torch.Tensor = None
    wide_table: torch.Tensor = None
    max_leaf_tris: int = 0

    @property
    def num_nodes(self) -> int:
        return self.node_table.shape[0]

    @property
    def num_windows(self) -> int:
        return 0 if self.chunk_bnd is None else self.chunk_bnd.shape[0]

    def stats(self) -> dict:
        """Tree-quality stats (the reference printf, src/kd_tree.c:232-235)."""
        is_leaf = self.is_leaf.cpu().numpy()
        counts = self.leaf_count.cpu().numpy()[is_leaf]
        return {"nodes": self.num_nodes, "leaves": int(is_leaf.sum()),
                "leaf_tris": int(counts.sum()),
                "max_tris_per_leaf": int(counts.max(initial=0)),
                "windows": self.num_windows}


def pack_quads_host(tri_indices: np.ndarray,
                    tri_verts: np.ndarray) -> np.ndarray:
    """Triangle records [T, 16] f32: (v0, e1, e2, tri_id, pad 6), one per
    entry of `tri_indices`; an index of -1 gives a pad record with
    tri_id -1 (geometry of triangle 0, never a hit: every consumer
    rejects tri_id < 0).

    The JAX package folds four records into a [T/4, 64] quad row for the
    TPU's lanes; the port keeps the flat [T, 16] records, whose row index
    is the slot that the kernels return."""
    idx = np.asarray(tri_indices)
    safe = np.maximum(idx, 0)
    tv = np.asarray(tri_verts, np.float32)
    a = tv[safe, 0]
    rows16 = np.zeros((idx.shape[0], 16), np.float32)
    rows16[:, 0:3] = a
    rows16[:, 3:6] = tv[safe, 1] - a
    rows16[:, 6:9] = tv[safe, 2] - a
    rows16[:, 9] = idx.astype(np.float32)
    return rows16


def build_kd_tree(tri_verts: np.ndarray, max_depth: int = DEFAULT_DEPTH,
                  leaf_size: int = 1, tri_block: int = 4, *,
                  device) -> FlatKdTree:
    """Build the SAH kd-tree with the native builder and attach the
    stream engine's window tables and, for leaf_size >= 8, the wide table
    (not the SO tables: attach_so_tables).

    tri_verts: [F, 3, 3] triangle corners (host numpy, face-winding
    order). max_depth, leaf_size: as the JAX package's build_kd_tree.
    tri_block: 4 only (the quad-row layout the native builder emits); the
    Python builder for other values is not ported."""
    from clpathtracer_tpu_torch.accel.native import build_kd_native
    if tri_block != 4:
        raise NotImplementedError(
            f"tri_block={tri_block}: only the native tri_block=4 build is "
            "ported; the Python builder comes with the per-ray walks "
            "(ROADMAP queue 1 item 12)")
    table, tri_indices = build_kd_native(
        np.asarray(tri_verts, np.float32), max_depth, max(1, leaf_size),
        tri_block)
    tree = tree_from_node_table(table, tri_indices, tri_verts, device=device)
    if leaf_size >= 8:
        tree = attach_wide_table(tree)
    return attach_chunk_info(tree)


def tree_from_node_table(table: np.ndarray, tri_indices: np.ndarray,
                         tri_verts: np.ndarray, *,
                         device) -> FlatKdTree:
    """The tree from a packed [M, 24] node table and its padded triangle
    lists (the native builder's output): leaf lists reordered spatially
    (sort_leaf_tris_spatial), records packed from tri_verts."""
    table = np.asarray(table, np.float32)
    flags = table[:, 7].astype(np.int32)
    is_leaf = flags >= 4
    leaf_start = table[:, 10].astype(np.int32) * 4
    leaf_count = table[:, 11].astype(np.int32)
    tri_indices = sort_leaf_tris_spatial(
        tri_indices, leaf_start, leaf_count, is_leaf, table[:, 0:3],
        table[:, 3:6], np.asarray(tri_verts, np.float64).mean(axis=1))

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)
    return FlatKdTree(
        node_table=dev(table), tri_indices=dev(tri_indices),
        node_min=dev(table[:, 0:3]), node_max=dev(table[:, 3:6]),
        is_leaf=dev(is_leaf), leaf_start=dev(leaf_start),
        leaf_count=dev(leaf_count),
        tris=dev(pack_quads_host(tri_indices, tri_verts)),
        max_leaf_tris=int(leaf_count.max(initial=0)))


def _morton10(q: np.ndarray) -> np.ndarray:
    """Interleave 3x10-bit ints [K, 3] into 30-bit Morton codes."""
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x
    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


def sort_leaf_tris_spatial(tri_indices: np.ndarray, leaf_start: np.ndarray,
                           leaf_count: np.ndarray, is_leaf: np.ndarray,
                           node_min: np.ndarray, node_max: np.ndarray,
                           centroids: np.ndarray) -> np.ndarray:
    """Reorder each leaf's triangle list by the Morton code of the
    triangle centroid within the leaf's AABB, -1 pad slots at the segment
    tail, so that consecutive windows of a leaf cover compact sub-volumes
    (tight chunk_bnd boxes). Leaves of at most one window keep build
    order."""
    idx = np.asarray(tri_indices)
    t = idx.shape[0]
    if t == 0:
        return idx
    # per-slot owning leaf (segments are contiguous in node preorder)
    leaves = np.flatnonzero(np.asarray(is_leaf))
    starts = np.asarray(leaf_start)[leaves]
    order = np.argsort(starts, kind="stable")
    leaves, starts = leaves[order], starts[order]
    seg_of_slot = np.searchsorted(starts, np.arange(t), side="right") - 1
    lo = np.asarray(node_min)[leaves][seg_of_slot]
    hi = np.asarray(node_max)[leaves][seg_of_slot]
    pad = idx < 0
    c = centroids[np.maximum(idx, 0)]
    ext = np.maximum(hi - lo, 1e-30)
    q = np.clip(((c - lo) / ext) * 1023.0, 0.0, 1023.0).astype(np.uint32)
    key = _morton10(q)
    key[pad] = np.uint64(0xFFFFFFFFFFFFFFFF)  # pads stay at the tail
    counts = np.asarray(leaf_count)[leaves][seg_of_slot]
    small = counts <= CHUNK_ROWS * 8
    key[small] = np.arange(t, dtype=np.uint64)[small]
    perm = np.lexsort((key, seg_of_slot))
    return idx[perm]


def chunk_bounds_host(tri_indices: np.ndarray, leaf_start: np.ndarray,
                      leaf_count: np.ndarray, is_leaf: np.ndarray,
                      vmin_c: np.ndarray, vmax_c: np.ndarray,
                      chunk_rows: int = CHUNK_ROWS):
    """Per-node chunk_start [N] i32 and per-window AABBs [W, 6] f32 on the
    stream kernel's window grid: window b of a leaf whose records start at
    row0 = leaf_start // 8 covers rows [min(row0 + b*chunk_rows, n_rows -
    chunk_rows), +chunk_rows) of the padded records (ops/packet.py::
    pad_records), clamped at the end, so the box covers every real
    triangle in the window, overhang into neighbouring leaves included.
    A window without a real triangle gets an inverted box and always
    culls."""
    idx = np.asarray(tri_indices)
    n_nodes = np.asarray(leaf_start).shape[0]
    t = idx.shape[0]
    target = max((t + 7) // 8 * 8, chunk_rows * 8)
    n_rows = target // 8
    big = np.float32(3.4e38)
    slot_lo = np.full((target, 3), big, np.float32)
    slot_hi = np.full((target, 3), -big, np.float32)
    real = idx >= 0
    slot_lo[:t][real] = vmin_c[idx[real]].astype(np.float32)
    slot_hi[:t][real] = vmax_c[idx[real]].astype(np.float32)

    starts = np.asarray(leaf_start).astype(np.int64)
    counts = np.asarray(leaf_count).astype(np.int64)
    leaf_mask = np.asarray(is_leaf)
    row0 = starts // 8
    row_end = (starts + counts + 7) // 8
    nchunks = np.where(leaf_mask & (counts > 0),
                       (row_end - row0 + chunk_rows - 1) // chunk_rows, 0)
    chunk_start = np.zeros(n_nodes, np.int64)
    chunk_start[1:] = np.cumsum(nchunks)[:-1]
    w_total = int(nchunks.sum())

    win_leaf = np.repeat(np.arange(n_nodes), nchunks)
    win_b = np.arange(w_total) - chunk_start[win_leaf]
    win_r0 = np.minimum(row0[win_leaf] + win_b * chunk_rows,
                        n_rows - chunk_rows)
    sl = win_r0[:, None] * 8 + np.arange(chunk_rows * 8)[None, :]
    bnd = np.concatenate([slot_lo[sl].min(axis=1), slot_hi[sl].max(axis=1)],
                         axis=1)
    return chunk_start.astype(np.int32), bnd.astype(np.float32)


def attach_chunk_info(tree: FlatKdTree) -> FlatKdTree:
    """Compute and attach chunk_start / chunk_bnd from the tree's records
    (per-slot boxes of v0, v0 + e1, v0 + e2)."""
    rows16 = tree.tris.cpu().numpy()
    idx = rows16[:, 9].astype(np.int64)
    v0 = rows16[:, 0:3]
    p1 = v0 + rows16[:, 3:6]
    p2 = v0 + rows16[:, 6:9]
    vmin = np.minimum(np.minimum(v0, p1), p2)
    vmax = np.maximum(np.maximum(v0, p1), p2)
    slot_ids = np.where(idx >= 0, np.arange(idx.shape[0]), -1)
    cs, bnd = chunk_bounds_host(
        slot_ids, tree.leaf_start.cpu().numpy(),
        tree.leaf_count.cpu().numpy(), tree.is_leaf.cpu().numpy(), vmin,
        vmax)
    device = tree.tris.device
    return tree.replace(chunk_start=torch.as_tensor(cs, device=device),
                        chunk_bnd=torch.as_tensor(bnd, device=device))


def attach_wide_table(tree: FlatKdTree) -> FlatKdTree:
    """Build (on the host) and attach the 8-wide supernode table
    (accel/wide.py::build_wide_table) on the tree's device."""
    from clpathtracer_tpu_torch.accel.wide import build_wide_table
    return tree.replace(wide_table=torch.as_tensor(
        build_wide_table(tree), device=tree.node_table.device))


def attach_so_tables(tree: FlatKdTree) -> FlatKdTree:
    """Attach the affine shared-origin tables over the padded records,
    built on the tree's device (ops/packet.py::so_affine_tables)."""
    from clpathtracer_tpu_torch.ops.packet import pad_records, so_affine_tables
    return tree.replace(so_base=so_affine_tables(pad_records(tree.tris)))
