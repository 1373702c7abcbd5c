"""Scene-parallel rendering: treelet-sharded triangles over a ring of ranks
(port of clpathtracer_tpu/parallel/treelet.py).

For scenes too large to hold whole on one device, the triangles are
partitioned into S spatially coherent treelets (Morton-order chunks),
each with its own kd-tree whose records carry GLOBAL triangle ids, so a
rank that holds one block holds 1/S of the acceleration data and 1/S of
the geometry and needs no replicated vertex table to walk it.

* intersect_ring: the rays stay where they are and the blocks rotate
  around the ranks of the "scene" group (torch.distributed.
  batch_isend_irecv to the next rank, from the previous one); the
  rotation of the next block is posted before the current block is
  walked and waited on after it. Each block is walked by the per-ray
  rope walk (ops/traverse_fast.py::traverse_fast, kernel W1 on the GPU)
  with the running best t as its t_max, so later blocks walk
  distance-bounded. Without a group the S blocks held locally are walked
  one after another on one device: the reference the ring matches.
* intersect_sharded: every rank walks its own block on the same rays;
  all_reduce(MIN) of t, the lowest shard index at that t, and a SUM that
  carries the winner's tri, u and v.

Hit and t do not depend on the order the blocks arrive in; on an exact-t
tie across blocks the block that arrives first (the ring) or the lowest
shard index (intersect_sharded, the sequential walk) wins, and within a
block the walk's own rule holds.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from clpathtracer_tpu_torch.accel.native import build_kd_native
from clpathtracer_tpu_torch.accel.sah import (pack_quads_host,
                                              tree_from_node_table)
from clpathtracer_tpu_torch.core.struct import TensorStruct
from clpathtracer_tpu_torch.ops.traverse_fast import BIG, traverse_fast


@dataclasses.dataclass(frozen=True)
class TreeletBlock(TensorStruct):
    """One treelet's kd-tree as the rope walk reads it: node_table [M, 24]
    f32, leaf_start [M] i32 (a leaf's first record), tris [T, 16] f32
    records whose tri_id column holds global triangle ids (-1 pads)."""

    node_table: torch.Tensor
    leaf_start: torch.Tensor
    tris: torch.Tensor
    tri_block: int = 4

    @property
    def num_nodes(self) -> int:
        return self.node_table.shape[0]


@dataclasses.dataclass(frozen=True)
class ShardedTree(TensorStruct):
    """The kd-trees of Morton treelet blocks, stacked and padded to common
    shapes so that a block can be sent and received whole.

    node_table: [B, M, 24] f32 (zero rows pad a smaller tree);
    leaf_start: [B, M] i32; tris: [B, T, 16] f32 records, tri_id column
    the GLOBAL triangle id, pads zero with id -1; tri_slots: [B, T] i32
    the same ids (the JAX package's tri_slots). B is total_blocks on a
    build, 1 on a rank's shard (shard_of). group: the "scene" process
    group the blocks rotate over, or None (the local blocks are walked
    one after another)."""

    node_table: torch.Tensor
    leaf_start: torch.Tensor
    tris: torch.Tensor
    tri_slots: torch.Tensor
    total_blocks: int = 0
    group: object = None

    @property
    def num_shards(self) -> int:
        return self.node_table.shape[0]

    def block(self, i: int) -> TreeletBlock:
        return TreeletBlock(self.node_table[i], self.leaf_start[i],
                            self.tris[i])


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort order of points along a 30-bit 3-D Morton curve (spatially
    coherent chunks -> compact treelet bounding boxes); a copy of the JAX
    package's numpy function."""
    lo = centroids.min(0)
    ext = np.maximum(centroids.max(0) - lo, 1e-12)
    q = np.minimum((1024 * (centroids - lo) / ext).astype(np.uint64), 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x30000FF)
        x = (x | (x << 8)) & np.uint64(0x300F00F)
        x = (x | (x << 4)) & np.uint64(0x30C30C3)
        x = (x | (x << 2)) & np.uint64(0x9249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def _build_block(tri_verts, chunk, max_depth, leaf_size):
    """(node table, leaf_start, global ids) of one chunk's tree (host):
    build_kd_tree's native tri_block 4 tree without the packet engine's
    window tables, which the walk does not read."""
    sub = tri_verts[chunk]
    table, local = build_kd_native(np.asarray(sub, np.float32), max_depth,
                                   max(1, leaf_size), 4)
    tree = tree_from_node_table(table, local, sub, device=torch.device("cpu"))
    local = tree.tri_indices.numpy()
    ids = np.where(local >= 0, chunk[np.maximum(local, 0)], -1)
    return (tree.node_table.numpy(), tree.leaf_start.numpy(),
            ids.astype(np.int32))


def build_sharded_tree(tri_verts: np.ndarray, n_shards: int,
                       max_depth: int = 22, leaf_size: int = 4, *,
                       device) -> ShardedTree:
    """Partition the triangles into n_shards Morton chunks (np.array_split
    of morton_order of the centroids) and build one kd-tree per chunk with
    the native builder at tri_block 4 (build_kd_tree's tree, as the JAX
    package's "auto" builds it); the chunks build in parallel threads (the
    native builder releases the GIL).

    tri_verts: [F, 3, 3] corners (host numpy). The records are packed from
    tri_verts by global id, as the JAX package bakes them (a pad slot
    inside a leaf carries triangle 0's geometry and id -1). Returns every
    block on `device`; a rank of a "scene" group keeps one with
    shard_of."""
    if n_shards < 1:
        raise ValueError(f"n_shards {n_shards} < 1")
    tri_verts = np.asarray(tri_verts)
    order = morton_order(tri_verts.mean(axis=1))
    chunks = np.array_split(order, n_shards)
    workers = max(1, min(n_shards, os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        blocks = list(pool.map(
            lambda c: _build_block(tri_verts, c, max_depth, leaf_size),
            chunks))
    m = max(t.shape[0] for t, _, _ in blocks)
    t_max = max(ids.shape[0] for _, _, ids in blocks)
    node_table = np.zeros((n_shards, m, 24), np.float32)
    leaf_start = np.zeros((n_shards, m), np.int32)
    tri_slots = np.full((n_shards, t_max), -1, np.int32)
    tris = np.zeros((n_shards, t_max, 16), np.float32)
    tris[:, :, 9] = -1.0
    for i, (table, first, ids) in enumerate(blocks):
        node_table[i, :table.shape[0]] = table
        leaf_start[i, :first.shape[0]] = first
        tri_slots[i, :ids.shape[0]] = ids
        tris[i, :ids.shape[0]] = pack_quads_host(ids, tri_verts)

    def dev(x):
        return torch.as_tensor(x, device=device)
    return ShardedTree(node_table=dev(node_table), leaf_start=dev(leaf_start),
                       tris=dev(tris), tri_slots=dev(tri_slots),
                       total_blocks=n_shards)


def shard_of(stree: ShardedTree, index: int, group=None) -> ShardedTree:
    """Block `index` of a built ShardedTree alone (B = 1), the resident
    block of the rank at that index of the "scene" group `group`."""
    if stree.num_shards != stree.total_blocks:
        raise ValueError("shard_of: the tree is already one rank's shard")
    if not 0 <= index < stree.total_blocks:
        raise ValueError(f"shard_of: block {index} of {stree.total_blocks}")
    keep = slice(index, index + 1)
    return dataclasses.replace(
        stree, node_table=stree.node_table[keep],
        leaf_start=stree.leaf_start[keep], tris=stree.tris[keep],
        tri_slots=stree.tri_slots[keep], group=group)


def _take(best, rec):
    """Fold a block's record into the running best: its hits are strictly
    below the t_max the walk was given, so each replaces the best."""
    take = rec["hit"]
    return {"hit": best["hit"] | take,
            **{k: torch.where(take, rec[k], best[k])
               for k in ("t", "tri", "u", "v")}}


def _block_tensors(blk: TreeletBlock):
    return (blk.node_table, blk.leaf_start, blk.tris)


def intersect_ring(stree: ShardedTree, orig, dir, *, active=None,
                   max_iters: int = 16384):
    """Nearest hit of the wave orig/dir [N, 3] over every treelet block:
    hit [N], t [N] (BIG on a miss), tri [N] (global id, -1), u, v [N].

    stree.group None: the stree's local blocks walked in turn, each
    through traverse_fast(block, t_max=best t, active=active). With a
    group of S ranks (each holding its shard_of block, S ==
    stree.total_blocks): S rounds; in each the current block is posted to
    rank (r + 1) % S and the next one received from (r - 1) % S into a
    spare buffer (two spares beside the resident block: nothing is
    received into a block being walked or sent) before the walk, and
    waited on after it. Every rank of the group must call it (with its
    own rays) the same number of times. On NCCL the transfers run on
    NCCL's stream, which waits for the walks enqueued before them, and the
    wait makes the current stream wait for them in turn."""
    n = orig.shape[0]
    dev = orig.device
    best = {"hit": torch.zeros((n,), dtype=torch.bool, device=dev),
            "t": torch.full((n,), BIG, device=dev),
            "tri": torch.full((n,), -1, dtype=torch.int32, device=dev),
            "u": torch.zeros((n,), device=dev),
            "v": torch.zeros((n,), device=dev)}

    def walk(blk):
        return traverse_fast(blk, orig, dir, max_iters=max_iters,
                             t_max=best["t"], active=active)

    if stree.group is None:
        for i in range(stree.num_shards):
            best = _take(best, walk(stree.block(i)))
        return best
    group = stree.group
    s_count = dist.get_world_size(group)
    if stree.num_shards != 1 or s_count != stree.total_blocks:
        raise ValueError(
            f"intersect_ring: a group of {s_count} ranks needs one resident "
            f"block of {s_count} a rank (shard_of); the tree holds "
            f"{stree.num_shards} of {stree.total_blocks}")
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % s_count)
    prv = dist.get_global_rank(group, (r - 1) % s_count)
    cur = stree.block(0)
    spares = [TreeletBlock(*(torch.empty_like(x)
                             for x in _block_tensors(cur)))
              for _ in range(min(2, s_count - 1))]
    for s in range(s_count):
        reqs = []
        if s < s_count - 1:
            recv = spares[s % 2]
            ops = [dist.P2POp(dist.isend, x, nxt, group)
                   for x in _block_tensors(cur)]
            ops += [dist.P2POp(dist.irecv, x, prv, group)
                    for x in _block_tensors(recv)]
            reqs = dist.batch_isend_irecv(ops)
        best = _take(best, walk(cur))
        for q in reqs:
            q.wait()
        if reqs:
            cur = recv
    return best


def scene_rank(mesh) -> tuple:
    """(index on "scene", its size, the group) of this rank's mesh."""
    from clpathtracer_tpu_torch.parallel.mesh import axis_size
    return (mesh.get_local_rank("scene"), axis_size(mesh, "scene"),
            mesh.get_group("scene"))


def resident(stree: ShardedTree, mesh) -> ShardedTree:
    """The tree this rank walks on `mesh`: a built tree of S blocks on a
    "scene" axis of S > 1 ranks gives the rank's shard_of block with the
    axis's group; on an axis of 1 the blocks are walked in turn (group
    None); a shard already placed is kept."""
    idx, size, group = scene_rank(mesh)
    if stree.group is not None or size == 1:
        return stree
    if stree.total_blocks != size:
        raise ValueError(f"a tree of {stree.total_blocks} blocks on a "
                         f"'scene' axis of {size} ranks")
    return shard_of(stree, idx, group)


def intersect_sharded(stree: ShardedTree, scene, orig, dir, mesh, *,
                      max_iters: int = 16384):
    """Nearest hit of rays replicated over the mesh's "scene" axis, each
    rank walking only its own block (no rotation): all_reduce(MIN) of t,
    then of the lowest shard index at that t, then a SUM that carries the
    winner's tri, u and v. Returns the usual record on every rank of the
    axis (miss: t BIG, tri -1). scene: accepted for the JAX signature;
    the blocks' records hold its geometry (the JAX function packs them
    from the scene's vertices each call)."""
    idx, size, group = scene_rank(mesh)
    if stree.total_blocks != size:
        raise ValueError(f"intersect_sharded: {stree.total_blocks} blocks "
                         f"on a 'scene' axis of {size} ranks")
    blk = stree.block(0 if stree.num_shards == 1 else idx)
    rec = traverse_fast(blk, orig, dir, max_iters=max_iters)
    t_loc = torch.where(rec["hit"], rec["t"], BIG)
    t_min = t_loc.clone()
    dist.all_reduce(t_min, dist.ReduceOp.MIN, group=group)
    at_min = rec["hit"] & (t_loc == t_min)
    win = torch.where(at_min, idx, size).to(torch.int32)
    dist.all_reduce(win, dist.ReduceOp.MIN, group=group)
    mine = at_min & (win == idx)
    hit = win < size
    picked = [torch.where(mine, rec[k], torch.zeros_like(rec[k]))
              for k in ("tri", "u", "v")]
    for x in picked:
        dist.all_reduce(x, dist.ReduceOp.SUM, group=group)
    return {"hit": hit, "t": torch.where(hit, t_min, BIG),
            "tri": torch.where(hit, picked[0], -1), "u": picked[1],
            "v": picked[2]}


def make_treelet_renderer(opts, mesh):
    """Scene-parallel frame renderer: the frame's pixel-grid rays split
    over both mesh axes (rank rows_idx * S + scene_idx renders the
    (rows_idx * S + scene_idx)-th of R * S equal ranges of the N rays in
    row-major order, the JAX package's P(("rows", "scene"))), the treelet
    blocks over "scene" and rotated by intersect_ring on every wave, the
    scene's materials and vertices replicated.

    Returns render(stree, scene, camera, generator=None) -> [H, W, 3] on
    every rank (the blocks gathered over both axes). A block is
    render_image's frame cut to its range (parallel/mesh.py::render_block):
    whole rows when R * S divides H, so edge_aware and spp > 1 work on it
    as on render_rows' blocks, else a row of its own (edge_aware's band
    over that row, as the JAX shade_edgeaware takes a shard that is not
    whole rows); path mode draws its block from a generator seeded from
    the caller's and the block index (parallel/mesh.py::block_generator).
    N must be a multiple of R * S, as in the JAX function."""
    from clpathtracer_tpu_torch.parallel.mesh import (_check_lanes,
                                                      axis_size,
                                                      gather_blocks,
                                                      render_block)
    n_blocks = mesh.size()
    _check_lanes(opts, n_blocks, "the mesh's ranks")
    k = mesh.get_local_rank("rows") * axis_size(mesh, "scene") \
        + mesh.get_local_rank("scene")

    def render(stree, scene, camera, generator=None):
        blk = render_block(scene, camera, opts, k, n_blocks,
                           tree=resident(stree, mesh), generator=generator)
        return gather_blocks(blk, mesh, over_scene=True).reshape(
            opts.height, opts.width, 3)

    return render
