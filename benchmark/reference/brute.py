"""Nearest and any-hit ray-triangle queries over every triangle of a
scene, in plain PyTorch: the brute force, made affordable by a
conservative cull.

The triangles are ordered by the Morton code of their centroids and cut
into clusters of CLUSTER; a ray tests the triangles of every cluster
whose box (padded by far more than float64 rounding) its segment meets,
and the cull drops no triangle the test could accept. The pair test is
Moller-Trumbore with the backface cull (det > 0), u and v in [0, 1],
u + v <= 1, t > 0, in the order of operations of clpathtracer_tpu_torch's
plain version, computed in `dtype` (float64; the lower-precision control
passes bfloat16)."""

from __future__ import annotations

import torch

CLUSTER = 128
RAY_BLOCK = 256        # rays a step of the box test
PAIR_BLOCK = 16384     # (ray, cluster) pairs a step of the triangle test
_PAD = 1e-6            # box padding, relative to the coordinates' scale


def _part1by2(x):
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore(v0, e1, e2, orig, dir):
    """(ok, t) of the pair test over broadcast shapes, in their dtype."""
    pvec = _cross(dir, e2)
    det = _dot(e1, pvec)
    ok = det > 0.0
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    tvec = orig - v0
    u = _dot(tvec, pvec) * inv
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qvec = _cross(tvec, e1)
    v = _dot(dir, qvec) * inv
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = _dot(e2, qvec) * inv
    return ok & (t > 0.0), t


class Triangles:
    """The scene's triangles in clusters, on `device`, float64."""

    def __init__(self, verts, faces, device):
        v = torch.as_tensor(verts, dtype=torch.float64, device=device)
        f = torch.as_tensor(faces, dtype=torch.int64, device=device)
        c = v[f]                                         # [F, 3, 3]
        cen = c.mean(dim=1)
        lo, hi = cen.min(dim=0).values, cen.max(dim=0).values
        q = ((cen - lo) / torch.clamp(hi - lo, min=1e-12) * 1023).long()
        code = (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) \
            | _part1by2(q[:, 2])
        order = torch.argsort(code)
        n = f.shape[0]
        pad = -n % CLUSTER
        ids = torch.cat([order, torch.full((pad,), -1, device=device)])
        cs = torch.cat([c[order], torch.zeros((pad, 3, 3), dtype=c.dtype,
                                              device=device)])
        self.ids = ids.reshape(-1, CLUSTER)
        self.v0 = cs[:, 0].reshape(-1, CLUSTER, 3)
        self.e1 = (cs[:, 1] - cs[:, 0]).reshape(-1, CLUSTER, 3)
        self.e2 = (cs[:, 2] - cs[:, 0]).reshape(-1, CLUSTER, 3)
        big = torch.tensor(float("inf"), dtype=c.dtype, device=device)
        real = (ids >= 0)[:, None, None]
        blo = torch.where(real, cs, big).amin(dim=1).reshape(-1, CLUSTER, 3)
        bhi = torch.where(real, cs, -big).amax(dim=1).reshape(-1, CLUSTER, 3)
        scale = _PAD * (1.0 + v.abs().max())
        self.lo = blo.amin(dim=1) - scale
        self.hi = bhi.amax(dim=1) + scale

    def _pairs(self, orig, dir, t_max):
        """(ray, cluster) pairs whose padded box the segment [0, t_max]
        meets (the slab test; a zero direction component keeps the slab
        where the origin lies inside it)."""
        rays, clusters = [], []
        lo, hi = self.lo[None], self.hi[None]
        for r0 in range(0, orig.shape[0], RAY_BLOCK):
            o = orig[r0:r0 + RAY_BLOCK, None, :]
            d = dir[r0:r0 + RAY_BLOCK, None, :]
            zero = d == 0.0
            inv = 1.0 / torch.where(zero, torch.ones_like(d), d)
            t1, t2 = (lo - o) * inv, (hi - o) * inv
            inside = (o >= lo) & (o <= hi)
            inf = torch.full_like(t1, float("inf"))
            tn = torch.where(zero, torch.where(inside, -inf, inf),
                             torch.minimum(t1, t2))
            tf = torch.where(zero, torch.where(inside, inf, -inf),
                             torch.maximum(t1, t2))
            tmin, tmax = tn.amax(dim=-1), tf.amin(dim=-1)
            ok = (tmin <= tmax) & (tmax >= 0.0)
            if t_max is not None:
                ok = ok & (tmin <= t_max[r0:r0 + RAY_BLOCK, None])
            r, c = ok.nonzero(as_tuple=True)
            rays.append(r + r0)
            clusters.append(c)
        return torch.cat(rays), torch.cat(clusters)

    def _tests(self, orig, dir, t_max, dtype):
        """Per (ray, cluster) pair: the least accepted t below t_max and
        the triangle that gives it (-1 and inf where none)."""
        rays, clusters = self._pairs(orig, dir, t_max)
        best_t, best_id = [], []
        for k0 in range(0, rays.shape[0], PAIR_BLOCK):
            r = rays[k0:k0 + PAIR_BLOCK]
            c = clusters[k0:k0 + PAIR_BLOCK]
            ok, t = moller_trumbore(*(x[c].to(dtype) for x in
                                      (self.v0, self.e1, self.e2)),
                                    orig[r, None, :].to(dtype),
                                    dir[r, None, :].to(dtype))
            t = t.double()
            if t_max is not None:
                ok = ok & (t < t_max[r, None])
            t = torch.where(ok, t, float("inf"))
            bt, j = t.min(dim=1)
            best_t.append(bt)
            best_id.append(torch.where(torch.isfinite(bt),
                                       self.ids[c].gather(1, j[:, None])[:, 0],
                                       -1))
        if not best_t:
            return rays, torch.zeros((0,), dtype=torch.float64,
                                     device=orig.device), rays
        return rays, torch.cat(best_t), torch.cat(best_id)

    def nearest(self, orig, dir, dtype=torch.float64):
        """Nearest front-face hit: (hit [R] bool, t [R] float64, tri [R]
        int64, -1 on a miss). Equal t: the lower triangle id."""
        n = orig.shape[0]
        rays, bt, bid = self._tests(orig, dir, None, dtype)
        t = torch.full((n,), float("inf"), dtype=torch.float64,
                       device=orig.device)
        t.scatter_reduce_(0, rays, bt, reduce="amin")
        win = torch.isfinite(bt) & (bt == t[rays])
        big = torch.iinfo(torch.int64).max
        tri = torch.full((n,), big, dtype=torch.int64, device=orig.device)
        tri.scatter_reduce_(0, rays[win], bid[win], reduce="amin")
        hit = torch.isfinite(t)
        return hit, t, torch.where(hit, tri, -1)

    def occluded(self, orig, dir, t_max, dtype=torch.float64):
        """Any front-face hit with 0 < t < t_max [R]."""
        n = orig.shape[0]
        rays, bt, _ = self._tests(orig, dir, t_max.double(), dtype)
        occ = torch.zeros((n,), dtype=torch.int64, device=orig.device)
        occ.scatter_reduce_(0, rays, torch.isfinite(bt).long(), reduce="amax")
        return occ.bool()
