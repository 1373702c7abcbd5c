"""The per-ray stackless kd rope walk (port of clpathtracer_tpu/ops/
traverse_fast.py and the walk of ops/traverse.py), Moller-Trumbore from
pre-differenced edges, and the packed node table.

The walk is the reference kernel's (src/kernel.cl:296-422), as the JAX
package's lockstep two-gather body runs it (ops/traverse_fast.py:417-519):
the root-box gate and entry point p = o + max(tmin, 0) d; then one step a
node: at a split, descend by p's coordinate against the split value (the
hi child on a strict >); at a leaf, test one block of `block` records
(4 for traverse_fast, the tree's tri_block for traverse) and, when the
leaf's list is done, hop the exit face's rope from p = o + tmax d. The
block's winner is its last minimum, taken when its t <= the carried best
(and < t_max, strictly). Early exit, at the end of a leaf only, when
tmin + EXIT_EPS > best t: after a hit without t_max, always with it.
any_hit stops a ray at its first take. Dead lanes (`active` False, or a
miss of the root box) never step.

On the GPU the walk is kernel W1 (ops/csrc/ray_walk.cu): 4 threads a
ray split each leaf's records, a warp's groups reconverge after each
iteration, and a persistent grid refills a warp's groups with live rays
from a counter; each ray has its own cap of max_iters steps. The JAX
package's loop caps all lanes together; the two agree wherever no lane
reaches the cap. On the CPU the wrapper runs the plain version, the JAX
package's lockstep body in torch ops, one rounding per operation in the
same order. The JAX package's XLA schedule (chunk_wave and
CLPT_WALK_CHUNK, the wind-down compaction, the fused walk table
build_walk_table) is not ported: it changes no lane's result or steps.
"""

from __future__ import annotations

import numpy as np
import torch

from clpathtracer_tpu_torch.core import vecmath as vm

BIG = 3.4e38
EXIT_EPS = 0.001  # reference early-exit slack (src/kernel.cl:381)
QBLOCK = 4        # records a step of traverse_fast


def _mt_pre(v0, e1, e2, orig, dir, eps=0.0):
    """Moller-Trumbore with backface cull (det > eps) on [N, 3] rows.
    Returns (ok, t, u, v)."""
    pvec = vm.cross(dir, e2)
    det = vm.dot(e1, pvec)
    ok = det > eps
    inv_det = 1.0 / det.masked_fill(det == 0.0, 1.0)
    tvec = orig - v0
    u = vm.dot(tvec, pvec) * inv_det
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvec = vm.cross(tvec, e1)
    v = vm.dot(dir, qvec) * inv_det
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = vm.dot(e2, qvec) * inv_det
    ok = ok & (t > 0.0)
    return ok, t, u, v


def pack_node_table(arrays: dict, tri_block: int = QBLOCK) -> np.ndarray:
    """The [M, 24] f32 node table from the builder's column arrays (host
    numpy): lo xyz, hi xyz, split value, flags = axis + 4 * is_leaf,
    child_lo, child_hi, the leaf's first record in units of tri_block,
    its triangle count, ropes[6], pad. The walk takes a leaf's first
    record from the int32 leaf_start column, not from lane 10."""
    is_leaf = np.asarray(arrays["is_leaf"])
    leaf_start = np.asarray(arrays["leaf_start"])
    m = len(is_leaf)
    assert m < (1 << 24), f"{m} nodes overflows f32-exact int range"
    assert (leaf_start[is_leaf] % tri_block == 0).all(), (
        f"leaf tri lists must be padded to tri_block={tri_block}")
    t = np.zeros((m, 24), np.float32)
    t[:, 0:3] = np.asarray(arrays["node_min"], np.float32)
    t[:, 3:6] = np.asarray(arrays["node_max"], np.float32)
    t[:, 6] = np.asarray(arrays["split_value"], np.float32)
    t[:, 7] = (np.asarray(arrays["split_axis"])
               + 4 * is_leaf.astype(np.int32)).astype(np.float32)
    t[:, 8] = np.asarray(arrays["child_lo"], np.float32)
    t[:, 9] = np.asarray(arrays["child_hi"], np.float32)
    t[:, 10] = (leaf_start // tri_block).astype(np.float32)
    t[:, 11] = np.asarray(arrays["leaf_count"], np.float32)
    t[:, 12:18] = np.asarray(arrays["ropes"], np.float32)
    return t


def _check(tree, orig, dir, t_max, active, block):
    n = orig.shape[0]
    if tree is None or tree.node_table is None:
        raise ValueError("ray_walk: needs a kd-tree with its node table")
    if orig.shape != (n, 3) or dir.shape != (n, 3) \
            or orig.dtype != torch.float32 or dir.dtype != torch.float32:
        raise ValueError(f"ray_walk: orig {tuple(orig.shape)} {orig.dtype} "
                         f"and dir {tuple(dir.shape)} {dir.dtype} must be "
                         "[N, 3] float32")
    if t_max is not None and (t_max.shape != (n,)
                              or t_max.dtype != torch.float32):
        raise ValueError(f"ray_walk: t_max {tuple(t_max.shape)} "
                         f"{t_max.dtype} is not [{n}] float32")
    if active is not None and (active.shape != (n,)
                               or active.dtype != torch.bool):
        raise ValueError(f"ray_walk: active {tuple(active.shape)} "
                         f"{active.dtype} is not [{n}] bool")
    if not 1 <= block <= 16:
        raise ValueError(f"ray_walk: block {block} is not in 1..16")
    devices = {t.device for t in (tree.node_table, tree.tris, orig, dir,
                                  t_max, active) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"ray_walk: tensors on several devices {devices}")


def ray_walk(tree, orig, dir, *, block: int = QBLOCK,
             max_iters: int = 16384, t_max=None, active=None,
             any_hit: bool = False):
    """The rope walk of every ray through a FlatKdTree (accel/sah.py),
    `block` records a leaf step.

    orig/dir: [N, 3] f32. t_max: optional [N] f32 per-ray bound (hits at or
    beyond it are ignored; the walk exits a leaf entered beyond it).
    active: optional [N] bool. any_hit: stop at the first accepted hit
    (needs t_max). A ray stops after max_iters steps.

    Returns (best_t [N] f32: the winner's t, BIG or t_max where there is
    none; best_slot [N] i32: the winner's row of tree.tris, -1; steps [N]
    i32: the nodes and blocks the walk visited, counted as the JAX
    package's two-gather body counts them).

    A CPU tensor runs the plain version (ray_walk_reference); a CUDA
    tensor launches W1 (ops/csrc/ray_walk.cu) on the current stream or
    raises. `ray_walk.launches` counts kernel launches."""
    if any_hit and t_max is None:
        raise ValueError("ray_walk: any_hit needs t_max")
    _check(tree, orig, dir, t_max, active, block)
    device = orig.device
    if device.type == "cpu":
        return ray_walk_reference(tree, orig, dir, block=block,
                                  max_iters=max_iters, t_max=t_max,
                                  active=active, any_hit=any_hit)
    if device.type != "cuda":
        raise ValueError(f"ray_walk: no kernel for device {device}")
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    fn = load_kernels().fns["ray_walk_launch"]
    n = orig.shape[0]
    orig, dir = orig.contiguous(), dir.contiguous()
    best_t = torch.empty((n,), dtype=torch.float32, device=device)
    best_slot = torch.empty((n,), dtype=torch.int32, device=device)
    steps = torch.empty_like(best_slot)
    act = None if active is None else active.contiguous()   # read as u8
    tm = None if t_max is None else t_max.contiguous()
    table = tree.node_table.contiguous()
    first = tree.leaf_start.to(torch.int32).contiguous()
    next_ray = torch.empty((1,), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(table.data_ptr(), first.data_ptr(), tree.tris.data_ptr(),
                 orig.data_ptr(), dir.data_ptr(),
                 0 if tm is None else tm.data_ptr(),
                 0 if act is None else act.data_ptr(), best_t.data_ptr(),
                 best_slot.data_ptr(), steps.data_ptr(), next_ray.data_ptr(),
                 n, tree.tris.shape[0], block, max_iters, int(any_hit),
                 stream)
    if err != 0:
        raise RuntimeError(f"ray_walk launch failed: cudaError {err} "
                           f"(N={n}, nodes={table.shape[0]})")
    ray_walk.launches += 1
    return best_t, best_slot, steps


ray_walk.launches = 0


def ray_walk_reference(tree, orig, dir, *, block: int = QBLOCK,
                       max_iters: int = 16384, t_max=None, active=None,
                       any_hit: bool = False, tally=None, touched=None):
    """Plain torch version of ray_walk: the JAX package's lockstep
    two-gather body (ops/traverse_fast.py:417-519) without its wind-down,
    on any device; same arguments and outputs.

    tally (optional int64 [5] tensor on the device): adds the tested
    (ray, record) pairs, those that pass det > 0, then also the u test,
    then also the v test, and the bytes the walk's reads need: 16 at a
    split (lanes 6-9 of the node row), 76 at a leaf step (lanes 0-17 and
    the leaf's first record) and 48 (cols 0-11) for each record of the
    block that lies in the leaf.

    touched (optional dict of bool tensors on the device, "nodes" [M] and
    "recs" [T]): marks the node rows and the records the walk reads."""
    n = orig.shape[0]
    dev = orig.device
    table = tree.node_table
    first_all = tree.leaf_start.to(torch.int64)
    recs = tree.tris
    nrec = recs.shape[0]
    from clpathtracer_tpu_torch.ops.intersect import hit_aabb, traverse_aabb

    invdir = 1.0 / dir
    sign = (invdir < 0).to(torch.int64)
    rhit, rtmin, _, _, _ = hit_aabb(table[0, 0:3], table[0, 3:6], orig,
                                    invdir, sign)
    p = orig + torch.where(rtmin > 0, rtmin, 0.0)[:, None] * dir
    act = rhit if active is None else rhit & active
    node = torch.where(act, 0, -1)
    best_t = (torch.full((n,), BIG, device=dev) if t_max is None
              else t_max.clone())
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    offset = torch.zeros((n,), dtype=torch.int64, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    j = torch.arange(block, device=dev)

    for _ in range(max_iters):
        if not bool(act.any()):
            break
        nd = node.clamp(min=0)
        row = table[nd]                                        # [n, 24]
        flags = row[:, 7].to(torch.int64)
        axis = flags & 3
        is_leaf = flags >= 4

        # split descent
        pax = p.gather(1, axis[:, None])[:, 0]
        child = torch.where(pax > row[:, 6], row[:, 9], row[:, 8]).to(
            torch.int64)

        # leaf: one block of records
        count = row[:, 11].to(torch.int64)
        slots = first_all[nd][:, None] + offset[:, None] + j
        blk = recs[slots.clamp(0, nrec - 1)]                   # [n, B, 16]
        tid = blk[..., 9].to(torch.int64)
        in_leaf = (offset[:, None] + j) < count[:, None]
        held = in_leaf & (act & is_leaf)[:, None]
        valid = held & (tid >= 0)
        ok, t, _, _ = _mt_pre(blk[..., 0:3], blk[..., 3:6], blk[..., 6:9],
                              orig[:, None, :], dir[:, None, :])
        if tally is not None:
            from clpathtracer_tpu_torch.ops.grid_walk import _mt_exits
            tally[:4] += _mt_exits(blk, orig, dir, valid)
            tally[4] += (16 * (act & ~is_leaf).sum()
                         + 76 * (act & is_leaf).sum() + 48 * held.sum())
        if touched is not None:
            touched["nodes"][nd[act]] = True
            touched["recs"][slots[held]] = True
        t_m = torch.where(ok & valid, t, BIG)
        k = (block - 1) - torch.argmin(t_m.flip(1), dim=1)
        bt = t_m.gather(1, k[:, None])[:, 0]
        take = (bt < BIG) & (bt <= best_t)
        if t_max is not None:
            take = take & (bt < t_max)
        best_t = torch.where(take, bt, best_t)
        best_slot = torch.where(take, slots.gather(1, k[:, None])[:, 0],
                                best_slot)

        # advance: the next block, or the exit face's rope
        offset_next = offset + block
        leaf_done = offset_next >= count
        tmin, tmax, far_face = traverse_aabb(row[:, 0:3], row[:, 3:6], orig,
                                             invdir, sign)
        early = tmin + EXIT_EPS > best_t
        if t_max is None:
            early = early & (best_slot >= 0)
        rope = row[:, 12:18].gather(1, far_face[:, None])[:, 0].to(
            torch.int64)
        new_node = torch.where(early, -1, rope)
        p_hop = orig + tmax[:, None] * dir

        at_split = act & ~is_leaf
        hop = act & is_leaf & leaf_done
        stay = act & is_leaf & ~leaf_done
        node = torch.where(at_split, child, torch.where(hop, new_node, node))
        p = torch.where(hop[:, None], p_hop, p)
        offset = torch.where(stay, offset_next, 0)
        steps = steps + act.to(torch.int32)
        act = act & torch.where(hop, new_node >= 0, True)
        if any_hit:
            act = act & ~take
    return best_t, best_slot.to(torch.int32), steps


def resolve_slot(tris, best_slot, orig, dir):
    """The record (hit, t, tri, u, v) of the winner slots [N] (rows of the
    [T, 16] records tris, -1 on a miss): one Moller-Trumbore per ray on
    the winner's record, which gives the walk's t again exactly."""
    hit = best_slot >= 0
    sel = tris[best_slot.clamp(0, tris.shape[0] - 1).long()]
    _, t, u, v = _mt_pre(sel[:, 0:3], sel[:, 3:6], sel[:, 6:9], orig, dir)
    return {"hit": hit, "t": torch.where(hit, t, BIG),
            "tri": torch.where(hit, sel[:, 9].to(torch.int32), -1),
            "u": torch.where(hit, u, 0.0), "v": torch.where(hit, v, 0.0)}


def _record(tree, out, orig, dir, any_hit):
    best_t, best_slot, steps = out
    if any_hit:
        # the occlusion query reads `hit`: t is the accepted hit's, tri the
        # sentinel 0, u and v 0 (JAX ops/traverse_fast.py:588-604)
        hit = best_slot >= 0
        zero = torch.zeros_like(best_t)
        rec = {"hit": hit, "t": torch.where(hit, best_t, BIG),
               "tri": torch.where(hit, 0, -1).to(torch.int32), "u": zero,
               "v": zero}
    else:
        rec = resolve_slot(tree.tris, best_slot, orig, dir)
    rec["steps"] = steps
    return rec


def traverse_fast(tree, orig, dir, *, max_iters: int = 16384, t_max=None,
                  active=None, any_hit: bool = False):
    """Trace a wave through a kd-tree whose leaves are padded to blocks of
    4 (the JAX package's default intersector, intersector="wavefront"):
    ray_walk with block 4, then resolve_slot. Returns hit, t, tri, u, v,
    steps [N]. t_max, active, any_hit, max_iters: as ray_walk; with
    any_hit, tri is 0 on a hit and u, v are 0."""
    return _record(tree, ray_walk(tree, orig, dir, block=QBLOCK,
                                  max_iters=max_iters, t_max=t_max,
                                  active=active, any_hit=any_hit),
                   orig, dir, any_hit)


def traverse_fast_reference(tree, orig, dir, *, max_iters: int = 16384,
                            t_max=None, active=None, any_hit: bool = False,
                            tally=None, touched=None):
    """traverse_fast through the plain ray_walk_reference, on any device."""
    return _record(tree, ray_walk_reference(
        tree, orig, dir, block=QBLOCK, max_iters=max_iters, t_max=t_max,
        active=active, any_hit=any_hit, tally=tally, touched=touched),
        orig, dir, any_hit)
