"""SAH kd-trees: the native and the Python builder, the shadow tree, and
host-side triangle record packing (the port's part of
clpathtracer_tpu/accel/sah.py).

Two builders give the same tree layout:

* the native C++ builder (accel/native), whose packed [M, 24] node table
  is the layout the JAX package's stream engine reads (tri_block 4);
* the Python builder (_Builder, _best_plane, _build_recursive, _add_ropes,
  _pad_leaves), the JAX package's vectorised numpy: binned SAH over 25
  planes an axis with the reference's area-augmented cost, straddlers
  duplicated into both children, ropes pushed down while they cannot
  straddle, leaves padded to any tri_block (1 is the reference's compact
  layout).

A tri_block 4 tree also carries the stream engine's tables:

* each leaf's triangle list reordered by the Morton code of the
  centroids inside the leaf box (sort_leaf_tris_spatial), so that the
  leaf's consecutive 128-record windows cover compact sub-volumes;
* per-window AABBs on the kernel's clamped window grid (chunk_bounds_host,
  attach_chunk_info), which the kernel and the strip prepass cull against;
* the affine shared-origin tables (attach_so_tables);
* for leaf_size >= 8 the 8-wide supernode table of the wide packet walk
  (accel/wide.py), as the JAX package attaches it.

Every tree can be walked per ray (ops/traverse_fast.py::ray_walk, kernel
W1): traverse_fast on tri_block 4, ops/traverse.py::traverse on any. The
packet and list engines raise ValueError on a tree of another tri_block.
build_shadow_tree is the port's counterpart of attach_shadow_tree: a
second, walk-tuned tree (leaf 16, depth 26) that render_image takes as
`shadow=`. The numpy arithmetic is the JAX package's own, so both packages
build the same trees, records and tables from the same triangles. The
JAX package's Morton-window and grid attachments are the port's
ops/plist.py and accel/grid.py; its fused walk table (attach_walk_table)
is a measured negative there and is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from clpathtracer_tpu_torch.core.struct import TensorStruct

NBINS = 25          # candidate planes per axis (src/kd_tree.c:9)
DEFAULT_DEPTH = 15  # reference DEPTH (src/kd_tree.c:8)
EPS = 1e-9          # reference EPS (src/kd_tree.c:10)
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
    tri_block: the leaves' padding; lane 10 of node_table is a leaf's first
      record in these units. Only a tri_block 4 tree has window, SO and
      wide tables.
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
    tri_block: int = 4

    @property
    def num_nodes(self) -> int:
        return self.node_table.shape[0]

    @property
    def num_windows(self) -> int:
        return 0 if self.chunk_bnd is None else self.chunk_bnd.shape[0]

    def stats(self) -> dict:
        """Tree-quality stats (the reference printf, src/kd_tree.c:232-235),
        the JAX package's FlatKdTree.stats() keys."""
        is_leaf = self.is_leaf.cpu().numpy()
        counts = self.leaf_count.cpu().numpy()[is_leaf]
        leaves = int(is_leaf.sum())
        leaf_tris = int(counts.sum())
        return {"leaf_tris": leaf_tris, "leaves": leaves,
                "avg_tris_per_leaf": leaf_tris / max(leaves, 1),
                "max_tris_per_leaf": int(counts.max(initial=0)),
                "nodes": self.num_nodes}


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


BACKENDS = ("auto", "native", "python")


def build_kd_tree(tri_verts: np.ndarray, max_depth: int = DEFAULT_DEPTH,
                  leaf_size: int = 1, tri_block: int = 4, *,
                  backend: str = "auto", device) -> FlatKdTree:
    """Build the SAH kd-tree with ropes, leaves padded to multiples of
    tri_block with -1.

    tri_verts: [F, 3, 3] triangle corners (host numpy, face-winding
    order). max_depth, leaf_size: as the JAX package's build_kd_tree.
    backend: "native" (the C++ builder, tri_block 4 only), "python" (the
    JAX package's numpy builder, any tri_block), or "auto": native for
    tri_block 4, else python. A failing native build raises; "auto" does
    not fall back to the Python builder.

    A tri_block 4 tree gets the stream engine's window tables and, for
    leaf_size >= 8, the wide table (not the SO tables: attach_so_tables);
    a tree of another tri_block gets its node table and records only."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if tri_block < 1:
        raise ValueError(f"tri_block {tri_block} < 1")
    if backend == "native" and tri_block != 4:
        raise ValueError(f"tri_block={tri_block}: the native builder emits "
                         "tri_block 4 only; use backend='python'")
    if backend == "python":
        tree = _build_python(tri_verts, max_depth, leaf_size, tri_block,
                             device)
    elif tri_block == 4:
        from clpathtracer_tpu_torch.accel.native import build_kd_native
        table, tri_indices = build_kd_native(
            np.asarray(tri_verts, np.float32), max_depth, max(1, leaf_size),
            tri_block)
        tree = tree_from_node_table(table, tri_indices, tri_verts,
                                    device=device)
    else:
        tree = _build_python(tri_verts, max_depth, leaf_size, tri_block,
                             device)
    if tri_block != 4:
        return tree
    if leaf_size >= 8:
        tree = attach_wide_table(tree)
    return attach_chunk_info(tree)


def build_shadow_tree(tri_verts: np.ndarray, leaf_size: int = 16,
                      max_depth: int = 26, *, device) -> FlatKdTree:
    """The walk-tuned second tree of the per-ray queries (the counterpart
    of the JAX package's attach_shadow_tree): NEE's shadow rays (any-hit
    with t_max) and, with RenderOptions.bounce_walk, the bounce waves walk
    it through W1. The packet engines want fat leaves, the rope walk small
    ones: it tests 4 records a step until its first hit. The native
    builder at tri_block 4; no window or wide tables (only the walk reads
    it). render_image and intersect_scene take it as `shadow=`."""
    from clpathtracer_tpu_torch.accel.native import build_kd_native
    table, tri_indices = build_kd_native(
        np.asarray(tri_verts, np.float32), max_depth, max(1, leaf_size), 4)
    return tree_from_node_table(table, tri_indices, tri_verts, device=device)


@dataclasses.dataclass
class _Builder:
    """Mutable build state of the Python builder (host numpy)."""
    node_min: list
    node_max: list
    is_leaf: list
    split_axis: list
    split_value: list
    child_lo: list
    child_hi: list
    leaf_start: list
    leaf_count: list
    tri_indices: list
    leaf_size: int
    vmin_c: np.ndarray  # [F, 3] per-tri min corner, per axis
    vmax_c: np.ndarray  # [F, 3] per-tri max corner, per axis
    area: np.ndarray    # [F] triangle surface areas

    def add_leaf(self, tri_ids: np.ndarray, lo, hi) -> int:
        idx = len(self.node_min)
        self.node_min.append(lo)
        self.node_max.append(hi)
        self.is_leaf.append(True)
        self.split_axis.append(0)
        self.split_value.append(0.0)
        self.child_lo.append(-1)
        self.child_hi.append(-1)
        self.leaf_start.append(len(self.tri_indices))
        self.leaf_count.append(len(tri_ids))
        self.tri_indices.extend(int(t) for t in tri_ids)
        return idx

    def add_split(self, lo, hi, value, axis) -> int:
        idx = len(self.node_min)
        self.node_min.append(lo)
        self.node_max.append(hi)
        self.is_leaf.append(False)
        self.split_axis.append(int(axis))
        self.split_value.append(float(value))
        self.child_lo.append(-1)
        self.child_hi.append(-1)
        self.leaf_start.append(0)
        self.leaf_count.append(0)
        return idx


def _best_plane(b: _Builder, tri_ids: np.ndarray, lo: np.ndarray,
                hi: np.ndarray):
    """Binned SAH over 3 axes x NBINS planes: cost NL*SL + NR*SR with each
    side's box area plus its triangles' areas (the reference's
    augmentation, src/kd_tree.c:121-145). (axis, value), or None when no
    plane is valid or splitting costs at least the leaf."""
    ext = hi - lo
    vmin = b.vmin_c[tri_ids]
    vmax = b.vmax_c[tri_ids]
    sa = b.area[tri_ids]
    best = None  # (cost, axis, value)
    d = (np.arange(NBINS, dtype=np.float64) + 1.0) / (NBINS + 1.0)
    for axis in range(3):
        e = ext[axis]
        if e < EPS:
            continue
        a1, a2 = (axis + 1) % 3, (axis + 2) % 3
        v = lo[axis] + d * e
        base = ext[a1] * ext[a2]
        perim = ext[a1] + ext[a2]
        sl_box = 2.0 * (base + e * d * perim)
        sr_box = 2.0 * (base + e * (1.0 - d) * perim)
        is_l = vmin[:, axis][:, None] <= v[None, :]
        is_r = vmax[:, axis][:, None] >= v[None, :]
        cost = (is_l.sum(0) * (sl_box + sa @ is_l)
                + is_r.sum(0) * (sr_box + sa @ is_r))
        k = int(np.argmin(cost))
        if best is None or cost[k] < best[0]:
            best = (cost[k], axis, float(v[k]))
    if best is None:
        return None
    cost, axis, value = best
    # degenerate-split guard (src/kd_tree.c:158)
    if value <= lo[axis] or hi[axis] <= value:
        return None
    # leaf-cost termination in the same cost family (the JAX package's)
    s_box = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if cost >= len(tri_ids) * (s_box + sa.sum()):
        return None
    return axis, value


def _build_recursive(b: _Builder, tri_ids: np.ndarray, lo: np.ndarray,
                     hi: np.ndarray, depth: int) -> int:
    if len(tri_ids) <= b.leaf_size or depth == 0:
        return b.add_leaf(tri_ids, lo, hi)
    plane = _best_plane(b, tri_ids, lo, hi)
    if plane is None:
        return b.add_leaf(tri_ids, lo, hi)
    axis, value = plane
    # duplicate-into-both partition with EPS slack (src/kd_tree.c:166-183)
    vmin = b.vmin_c[tri_ids][:, axis]
    vmax = b.vmax_c[tri_ids][:, axis]
    l_ids = tri_ids[vmin <= value + EPS]
    r_ids = tri_ids[vmax >= value - EPS]
    if len(l_ids) == len(tri_ids) and len(r_ids) == len(tri_ids):
        return b.add_leaf(tri_ids, lo, hi)   # every triangle straddles
    l_hi = hi.copy()
    l_hi[axis] = value
    r_lo = lo.copy()
    r_lo[axis] = value
    idx = b.add_split(lo, hi, value, axis)
    b.child_lo[idx] = _build_recursive(b, l_ids, lo, l_hi, depth - 1)
    b.child_hi[idx] = _build_recursive(b, r_ids, r_lo, hi, depth - 1)
    return idx


def _optimize_rope(rope: int, node_lo, node_hi, axis_arr, value_arr,
                   is_leaf_arr, cl_arr, ch_arr, face: int) -> int:
    """Push a rope down its subtree while it cannot straddle the face
    (reference optimize_rope, src/kd_tree.c:43-62)."""
    if rope == -1:
        return -1
    while not is_leaf_arr[rope]:
        ax = axis_arr[rope]
        if face // 2 == ax:
            break
        value = value_arr[rope]
        if value >= node_hi[ax]:
            rope = cl_arr[rope]
        elif value <= node_lo[ax]:
            rope = ch_arr[rope]
        else:
            break
    return rope


def _add_ropes(arrays: dict) -> np.ndarray:
    """The 6 neighbour links of every leaf (reference add_ropes,
    src/kd_tree.c:64-83), -1 = exit, face order -x, +x, -y, +y, -z, +z:
    a preorder walk with an explicit stack."""
    n = len(arrays["is_leaf"])
    is_leaf = arrays["is_leaf"]
    axis_arr = arrays["split_axis"]
    value_arr = arrays["split_value"]
    cl, ch = arrays["child_lo"], arrays["child_hi"]
    nmin, nmax = arrays["node_min"], arrays["node_max"]
    ropes_out = np.full((n, 6), -1, np.int32)
    stack = [(0, [-1] * 6)]
    while stack:
        index, ropes = stack.pop()
        if is_leaf[index]:
            ropes_out[index] = ropes
            continue
        opt = [_optimize_rope(ropes[f], nmin[index], nmax[index], axis_arr,
                              value_arr, is_leaf, cl, ch, f)
               for f in range(6)]
        ax = axis_arr[index]
        ropes0 = list(opt)
        ropes0[2 * ax + 1] = ch[index]  # left child's +axis face -> right
        ropes1 = list(opt)
        ropes1[2 * ax] = cl[index]      # right child's -axis face -> left
        stack.append((ch[index], ropes1))
        stack.append((cl[index], ropes0))
    return ropes_out


def _pad_leaves(tri_indices: np.ndarray, arrays: dict, block: int):
    """Re-lay the leaf lists padded to multiples of `block` with -1."""
    starts = arrays["leaf_start"]
    counts = arrays["leaf_count"]
    new_indices = []
    new_starts = starts.copy()
    for i in np.flatnonzero(arrays["is_leaf"]):
        s, c = int(starts[i]), int(counts[i])
        new_starts[i] = len(new_indices)
        new_indices.extend(list(tri_indices[s:s + c]) + [-1] * ((-c) % block))
    arrays = dict(arrays)
    arrays["leaf_start"] = new_starts.astype(np.int32)
    return np.asarray(new_indices, np.int32), arrays


def build_kd_arrays(tri_verts: np.ndarray, max_depth: int = DEFAULT_DEPTH,
                    leaf_size: int = 1, tri_block: int = 1):
    """The Python builder's output as host numpy: (arrays, tri_indices)
    with arrays the node columns node_min, node_max [M, 3] f32, is_leaf
    [M] bool, split_axis, child_lo, child_hi, leaf_start, leaf_count [M]
    i32, split_value [M] f32, ropes [M, 6] i32, and tri_indices [T] i32,
    the leaf lists padded to tri_block (Morton-sorted within each leaf
    for tri_block 4), as the JAX package's build_kd_tree(backend=
    "python") returns them."""
    tv = np.asarray(tri_verts, np.float64)
    assert tv.ndim == 3 and tv.shape[1:] == (3, 3), tv.shape
    nf = tv.shape[0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    vmin_c = tv.min(axis=1)
    vmax_c = tv.max(axis=1)
    b = _Builder(node_min=[], node_max=[], is_leaf=[], split_axis=[],
                 split_value=[], child_lo=[], child_hi=[], leaf_start=[],
                 leaf_count=[], tri_indices=[], leaf_size=max(1, leaf_size),
                 vmin_c=vmin_c, vmax_c=vmax_c, area=area)
    _build_recursive(b, np.arange(nf, dtype=np.int64),
                     vmin_c.min(axis=0).copy(), vmax_c.max(axis=0).copy(),
                     max_depth)
    arrays = {
        "node_min": np.asarray(b.node_min, np.float32),
        "node_max": np.asarray(b.node_max, np.float32),
        "is_leaf": np.asarray(b.is_leaf, bool),
        "split_axis": np.asarray(b.split_axis, np.int32),
        "split_value": np.asarray(b.split_value, np.float32),
        "child_lo": np.asarray(b.child_lo, np.int32),
        "child_hi": np.asarray(b.child_hi, np.int32),
        "leaf_start": np.asarray(b.leaf_start, np.int32),
        "leaf_count": np.asarray(b.leaf_count, np.int32),
    }
    arrays["ropes"] = _add_ropes(arrays)
    tri_indices = np.asarray(b.tri_indices, np.int32)
    if tri_block > 1:
        tri_indices, arrays = _pad_leaves(tri_indices, arrays, tri_block)
    if tri_block == 4:
        tri_indices = sort_leaf_tris_spatial(
            tri_indices, arrays["leaf_start"], arrays["leaf_count"],
            arrays["is_leaf"], arrays["node_min"], arrays["node_max"],
            tv.mean(axis=1))
    return arrays, tri_indices


def tree_from_arrays(arrays: dict, tri_indices: np.ndarray,
                     tri_verts: np.ndarray, tri_block: int, *,
                     device) -> FlatKdTree:
    """The FlatKdTree of a builder's node columns and padded leaf lists
    (build_kd_arrays' output): the packed node table, the records packed
    from tri_verts; no window tables."""
    from clpathtracer_tpu_torch.ops.traverse_fast import pack_node_table
    table = pack_node_table(arrays, tri_block)
    counts = np.asarray(arrays["leaf_count"], np.int32)

    def dev(x):
        return torch.as_tensor(np.array(x), device=device)
    return FlatKdTree(
        node_table=dev(table), tri_indices=dev(np.asarray(tri_indices,
                                                          np.int32)),
        node_min=dev(table[:, 0:3]), node_max=dev(table[:, 3:6]),
        is_leaf=dev(np.asarray(arrays["is_leaf"], bool)),
        leaf_start=dev(np.asarray(arrays["leaf_start"], np.int32)),
        leaf_count=dev(counts),
        tris=dev(pack_quads_host(tri_indices, tri_verts)),
        max_leaf_tris=int(counts.max(initial=0)), tri_block=int(tri_block))


def _build_python(tri_verts, max_depth, leaf_size, tri_block, device):
    arrays, tri_indices = build_kd_arrays(tri_verts, max_depth, leaf_size,
                                          tri_block)
    return tree_from_arrays(arrays, tri_indices, tri_verts, tri_block,
                            device=device)


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
