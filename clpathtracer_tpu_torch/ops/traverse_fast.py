"""Moller-Trumbore from pre-differenced edges (the slice's part of
clpathtracer_tpu/ops/traverse_fast.py)."""

from __future__ import annotations

from clpathtracer_tpu_torch.core import vecmath as vm


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
