"""Differentiable rendering: detached-topology hit resolution (port of
clpathtracer_tpu/diff/grad.py).

"Detach the discrete, differentiate the continuous": WHICH triangle a
ray hits is piecewise constant in the scene, so the walks and scans find
it with no autograd graph (torch.no_grad, on detached rays and records
packed from the detached vertices), through the plain frame's own routes
(render/integrator.py::_intersect_tris: W1, K3, G1, W2 on the GPU; their
plain versions on the CPU). Given the winner, t/u/v are smooth in the
ray and the triangle's vertices: one differentiable Moller-Trumbore per
ray against it gives them, so gradients reach the camera (through ray
generation) and scene.verts, normals and materials (through shading).
The gradients are exact wherever the hit topology is locally constant;
silhouettes are the edge-aware estimator's (render/integrator.py::
shade_edgeaware).
"""

from __future__ import annotations

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.ops.intersect import moller_trumbore
from clpathtracer_tpu_torch.ops.traverse_fast import pack_quads
from clpathtracer_tpu_torch.parallel.treelet import ShardedTree

BIG = 3.4e38


def intersect_diff(scene, tree, orig, dir, opts=None, *, coherent=False,
                   active=None, jitter_px=0.0, grid=None):
    """Nearest triangle hit with differentiable t/u/v and detached
    topology: dict(hit [N] bool, tri [N] i32, t [N] (BIG on a miss),
    u, v [N] (0 on a miss)); t/u/v carry gradients to orig, dir and
    scene.verts, hit and tri none.

    The topology is the plain frame's nearest hit (render/integrator.py::
    _intersect_tris, opts its RenderOptions, default RenderOptions())
    with no windows and no shadow tree, as in the JAX function: coherent
    (the frame's pixel-grid primaries, jittered by up to jitter_px) or
    scattered with the active [N] mask (optional); the tree's records are
    packed from the detached vertices (its other tables stay as built, so
    the topology may lag a vertex update by one build, JAX :89-95), the
    flat scan's from a scene of them. A parallel/treelet.py::ShardedTree
    gives the topology through its ring (intersect_ring) on its records as
    built (JAX :60-65), and the re-resolve below on the live vertices.

    A miss re-resolves against triangle 0 on detached inputs, so that no
    value of its masked branch (an inverse determinant near 0) reaches
    the backward pass."""
    # the integrator routes every wave through this function
    from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                          _intersect_tris)
    with torch.no_grad():
        frozen = scene.with_verts(scene.verts.detach())
        if tree is not None and not isinstance(tree, ShardedTree):
            tree = tree.replace(tris=pack_quads(tree.tri_indices,
                                                *frozen.tri_verts()))
        rec = _intersect_tris(frozen, None, orig.detach(), dir.detach(),
                              opts or RenderOptions(), coherent, active,
                              jitter_px, tree, grid, None)
    hit, tri = rec["hit"], rec["tri"]
    keep = hit[:, None]

    def live(x):
        return torch.where(keep, x, x.detach())
    p = vm.take_rows(scene.verts,
                     vm.take_rows(scene.faces, tri.clamp(min=0))[:, :, 0])
    _, t, u, v = moller_trumbore(live(p[:, 0]), live(p[:, 1]), live(p[:, 2]),
                                 live(orig), live(dir))
    return {"hit": hit, "tri": tri, "t": torch.where(hit, t, BIG),
            "u": torch.where(hit, u, 0.0), "v": torch.where(hit, v, 0.0)}
