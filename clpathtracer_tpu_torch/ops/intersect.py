"""Batched ray-primitive intersection (port of clpathtracer_tpu/ops/
intersect.py).

* Moller-Trumbore with the det > 0 backface cull (moller_trumbore);
* the slab box test with entry and exit faces (hit_aabb) and its exit-face
  form for rope hops (traverse_aabb), with the JAX package's comparisons,
  so that a direction component of exactly 0 (an inverse of +-inf) gives
  the same NaN and infinity outcomes;
* spheres (hit_sphere), the nearest positive root;
* the flat scan over every triangle and sphere (nearest_hit_bruteforce):
  on the GPU the triangles run through kernel W2 (ops/csrc/brute_force.cu),
  on the CPU through its plain version, nearest_hit_bruteforce_reference.

Face ids: 0 = -x, 1 = +x, 2 = -y, 3 = +y, 4 = -z, 5 = +z.
"""

from __future__ import annotations

import struct

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre

BIG = 3.4e38
TRI_EPS = 0.0  # reference EPS (src/kernel.cl:19)
CHUNK = 4096   # triangles per step of the plain brute force


def moller_trumbore(v0, v1, v2, orig, dir, eps: float = TRI_EPS):
    """Moller-Trumbore with backface culling; shapes broadcast. Returns
    (hit, t, u, v); t, u, v are meaningless where hit is False."""
    return _mt_pre(v0, v1 - v0, v2 - v0, orig, dir, eps)


def _slabs(lo, hi, orig, invdir, sign):
    signf = sign.to(lo.dtype)
    near_b = lo + signf * (hi - lo)
    far_b = hi - signf * (hi - lo)
    return (near_b - orig) * invdir, (far_b - orig) * invdir


def hit_aabb(lo, hi, orig, invdir, sign):
    """Slab test with entry and exit face ids (reference hit_AABB,
    src/kernel.cl:101-144). sign: int, 1 where invdir < 0. Returns (hit,
    tmin, tmax, near_face, far_face); hit needs the slabs to overlap and
    tmax > 0."""
    t_near, t_far = _slabs(lo, hi, orig, invdir, sign)
    tmin, tmax = t_near[..., 0], t_far[..., 0]
    near_face, far_face = sign[..., 0], 1 - sign[..., 0]
    miss = torch.zeros_like(tmin, dtype=torch.bool)
    for a in (1, 2):
        miss = miss | (tmin > t_far[..., a]) | (t_near[..., a] > tmax)
        take = t_near[..., a] > tmin
        near_face = torch.where(take, 2 * a + sign[..., a], near_face)
        tmin = torch.where(take, t_near[..., a], tmin)
        take = t_far[..., a] < tmax
        far_face = torch.where(take, 2 * a + 1 - sign[..., a], far_face)
        tmax = torch.where(take, t_far[..., a], tmax)
    return ~miss & (tmax > 0.0), tmin, tmax, near_face, far_face


def traverse_aabb(lo, hi, orig, invdir, sign):
    """Exit-face-only slab walk for rope hops (reference traverse_AABB,
    src/kernel.cl:146-174): (tmin, tmax, far_face). No miss handling: the
    caller knows the ray passes through the box. tmin takes the maximum
    with NaN propagation (jnp.maximum's)."""
    t_near, t_far = _slabs(lo, hi, orig, invdir, sign)
    tmin, tmax = t_near[..., 0], t_far[..., 0]
    far_face = 1 - sign[..., 0]
    for a in (1, 2):
        tmin = torch.maximum(tmin, t_near[..., a])
        take = t_far[..., a] < tmax
        far_face = torch.where(take, 2 * a + 1 - sign[..., a], far_face)
        tmax = torch.where(take, t_far[..., a], tmax)
    return tmin, tmax, far_face


def hit_sphere(center, radius, orig, dir):
    """Ray-sphere intersection: (hit, t) with t the nearest positive root;
    the reference's inside-the-sphere rejection is not reproduced.
    Broadcasts like moller_trumbore."""
    oc = orig - center
    a = vm.dot(dir, dir)
    b = 2.0 * vm.dot(dir, oc)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = torch.where(t0 > 0.0, t0, t1)
    return (disc >= 0.0) & (t > 0.0), t


def nearest_sphere(scene, orig, dir, t_min_eps: float = 0.0):
    """The nearest sphere hit of each ray, [N, S] broadcast: (t [N], BIG
    on a miss; sphere [N], the first of the nearest)."""
    ok, st = hit_sphere(scene.sphere_pos[None], scene.sphere_radius[None],
                        orig[:, None, :], dir[:, None, :])
    st = torch.where(ok & (st > t_min_eps), st, BIG)
    s_t, sbest = st.min(dim=1)
    return s_t, sbest.to(torch.int32)


def _check_bf(recs, orig, dir):
    n = orig.shape[0]
    if recs.dim() != 2 or recs.shape[1] != 16 \
            or recs.dtype != torch.float32 or not recs.is_contiguous():
        raise ValueError(f"brute_force: records {tuple(recs.shape)} "
                         f"{recs.dtype} must be contiguous [F, 16] float32")
    if orig.shape != (n, 3) or dir.shape != (n, 3) \
            or orig.dtype != torch.float32 or dir.dtype != torch.float32:
        raise ValueError(f"brute_force: orig {tuple(orig.shape)} and dir "
                         f"{tuple(dir.shape)} must be [N, 3] float32")
    if len({recs.device, orig.device, dir.device}) != 1:
        raise ValueError("brute_force: tensors on several devices")
    if recs.shape[0] >= 1 << 24:
        raise ValueError(f"brute_force: {recs.shape[0]} triangles; the "
                         "records carry ids exact in f32 below 2^24")


def brute_force(recs, orig, dir, t_min_eps: float = 0.0):
    """Nearest hit of every ray over every record (W2): the least t >
    t_min_eps that passes moller_trumbore, and on equal t the last record
    (the reference's `t <= minHit` in scan order, src/kernel.cl:344).

    recs: [F, 16] f32 (Scene.tri_records); orig, dir: [N, 3] f32. Returns
    (hit [N] bool, t [N] (BIG on a miss), prim [N] i32 (the record's row, -1),
    u, v [N] (0 on a miss)).

    A CPU tensor runs the plain version (brute_force_reference); a CUDA
    tensor launches W2 (ops/csrc/brute_force.cu) on the current stream or
    raises. `brute_force.launches` counts kernel launches."""
    _check_bf(recs, orig, dir)
    device = orig.device
    if device.type == "cpu":
        return brute_force_reference(recs, orig, dir, t_min_eps)
    if device.type != "cuda":
        raise ValueError(f"brute_force: no kernel for device {device}")
    from clpathtracer_tpu_torch.ops._cuda import load_kernels
    fn = load_kernels().fns["brute_force_launch"]
    n = orig.shape[0]
    orig, dir = orig.contiguous(), dir.contiguous()
    key = torch.empty((n,), dtype=torch.int64, device=device)
    t = torch.empty((n,), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    eps_bits = struct.unpack("<i", struct.pack("<f", float(t_min_eps)))[0]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(recs.data_ptr(), orig.data_ptr(), dir.data_ptr(),
                 key.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                 v.data_ptr(), n, recs.shape[0], eps_bits, stream)
    if err != 0:
        raise RuntimeError(f"brute_force launch failed: cudaError {err} "
                           f"(N={n}, F={recs.shape[0]})")
    brute_force.launches += 1
    return prim >= 0, t, prim, u, v


brute_force.launches = 0


def brute_force_reference(recs, orig, dir, t_min_eps: float = 0.0,
                          chunk: int = CHUNK, tally=None):
    """Plain torch version of brute_force, chunked over the records: same
    arguments and outputs, the same arithmetic (_mt_pre), on any device.
    The last minimum within a chunk, taken on <= over the chunks before.

    tally (optional int64 [4] tensor on the device): adds the tested
    (ray, record) pairs, those that pass det > 0, then also the u test,
    then also the v test: the early exits of W2's pair test."""
    n = orig.shape[0]
    dev = orig.device
    best_t = torch.full((n,), BIG, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), device=dev)
    best_v = torch.zeros((n,), device=dev)
    o, d = orig[:, None, :], dir[:, None, :]
    for c in range(0, recs.shape[0], chunk):
        r = recs[None, c:c + chunk]
        ok, t, u, v = _mt_pre(r[..., 0:3], r[..., 3:6], r[..., 6:9], o, d)
        if tally is not None:
            from clpathtracer_tpu_torch.ops.grid_walk import _mt_exits
            tally[:4] += _mt_exits(r, orig, dir, (r[..., 9] >= 0.0).expand(
                n, r.shape[1]))
        ok = ok & (r[..., 9] >= 0.0) & (t > t_min_eps)
        t_m = torch.where(ok, t, BIG)
        m = t_m.shape[1]
        k = (m - 1) - torch.argmin(t_m.flip(1), dim=1)
        bt = t_m.gather(1, k[:, None])[:, 0]
        take = (bt < BIG) & (bt <= best_t)
        best_t = torch.where(take, bt, best_t)
        best = torch.where(take, c + k, best)
        best_u = torch.where(take, u.gather(1, k[:, None])[:, 0], best_u)
        best_v = torch.where(take, v.gather(1, k[:, None])[:, 0], best_v)
    hit = best >= 0
    return hit, best_t, best.to(torch.int32), best_u, best_v


def miss_record(n: int, device) -> dict:
    """The record of a wave that hits nothing: hit False, t BIG, tri -1,
    u = v = 0, each [n]."""
    return {"hit": torch.zeros((n,), dtype=torch.bool, device=device),
            "t": torch.full((n,), BIG, device=device),
            "tri": torch.full((n,), -1, dtype=torch.int32, device=device),
            "u": torch.zeros((n,), device=device),
            "v": torch.zeros((n,), device=device)}


def flat_scan(scene, orig, dir, t_min_eps: float = 0.0, scan=None) -> dict:
    """The triangles' nearest hit by the flat scan: the record (hit, t, tri,
    u, v) of brute_force (W2 on the GPU) over scene.tri_records; scan
    replaces brute_force (brute_force_reference for the plain version)."""
    if not scene.num_tris:
        return miss_record(orig.shape[0], orig.device)
    hit, t, tri, u, v = (scan or brute_force)(scene.tri_records, orig, dir,
                                              t_min_eps)
    return {"hit": hit, "t": t, "tri": tri, "u": u, "v": v}


def merge_spheres(scene, rec, orig, dir, t_min_eps: float = 0.0) -> dict:
    """A triangle record (hit, t, tri, u, v, ...) with the nearest sphere
    hit merged after the triangles with a strict < (JAX ops/intersect.py:
    180-197): where a sphere wins, t is its t, tri -1 and u = v = 0; hit
    ORs in any sphere hit; `sphere` [N] is the winner's index, else -1."""
    s_t, sbest = nearest_sphere(scene, orig, dir, t_min_eps)
    wins = s_t < rec["t"]
    return dict(rec, t=torch.where(wins, s_t, rec["t"]),
                hit=rec["hit"] | (s_t < BIG),
                tri=torch.where(wins, -1, rec["tri"]),
                sphere=torch.where(wins, sbest, -1),
                u=torch.where(wins, 0.0, rec["u"]),
                v=torch.where(wins, 0.0, rec["v"]))


def nearest_hit_bruteforce(scene, orig, dir, t_min_eps: float = 0.0,
                           scan=None):
    """Linear scan over every triangle and sphere: the flat scan and the
    port's oracle (JAX ops/intersect.py::nearest_hit_bruteforce).
    Triangles through flat_scan (W2 on the GPU; scan as flat_scan's);
    spheres a torch broadcast over [N, S], merged after the triangles
    (merge_spheres).

    Returns hit [N] bool, t [N] (BIG on a miss), prim_id [N] i32 (triangle
    index, F + sphere index for a sphere, -1 on a miss), u, v [N] (0 for
    spheres and misses)."""
    rec = flat_scan(scene, orig, dir, t_min_eps, scan)
    prim = rec["tri"]
    if scene.num_spheres:
        rec = merge_spheres(scene, rec, orig, dir, t_min_eps)
        prim = torch.where(rec["sphere"] >= 0, scene.num_tris + rec["sphere"],
                           rec["tri"])
    return {"hit": rec["hit"], "t": rec["t"], "prim_id": prim, "u": rec["u"],
            "v": rec["v"]}


def nearest_hit_bruteforce_reference(scene, orig, dir,
                                     t_min_eps: float = 0.0):
    """nearest_hit_bruteforce with the triangles through the plain
    brute_force_reference, on any device."""
    return nearest_hit_bruteforce(scene, orig, dir, t_min_eps,
                                  brute_force_reference)
