"""Hit resolution and shading building blocks (the slice's part of
clpathtracer_tpu/render/shading.py)."""

from __future__ import annotations

import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm


def resolve_tri_hits(scene, tri: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor, allow_baked: bool = True):
    """Surface attributes of triangle hits: dict(normal, albedo, emission),
    each [N, 3]. tri: [N] triangle ids (-1 = miss: row 0's attributes,
    gate on your own mask).

    With baked shade rows (Scene.bake_shading) and allow_baked, one
    [N, 16] row gather gives all of them; the differentiable route passes
    allow_baked=False, since the rows, baked on the host, carry no
    gradient to the normals and materials. Otherwise the normal is the smooth
    vertex-normal interpolation normalize((1-u-v) n0 + u n1 + v n2) when
    the face carries three normal indices, else the geometric
    normalize((v1-v0) x (v2-v0)) (src/kernel.cl:344-365)."""
    safe = tri.clamp(min=0).long()
    w = torch.stack([1.0 - u - v, u, v], dim=-1)                     # [N, 3]
    if allow_baked and scene.shade_rows is not None:
        rows = scene.shade_rows[safe]                                # [N, 16]
        n = (w[:, 0:1] * rows[:, 0:3] + w[:, 1:2] * rows[:, 3:6]
             + w[:, 2:3] * rows[:, 6:9])
        return {"normal": vm.normalize(n, eps=1e-30),
                "albedo": rows[:, 9:12], "emission": rows[:, 12:15]}
    face = scene.faces[safe]                                         # [N, 3, 3]
    p = vm.take_rows(scene.verts, face[:, :, 0])                     # [N, 3, 3]
    geom_n = vm.normalize(vm.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                          eps=1e-30)
    nidx = face[:, :, 1]
    has_n = (nidx >= 0).all(dim=-1)
    nrm = vm.take_rows(scene.normals, nidx.clamp(min=0))             # [N, 3, 3]
    smooth_n = vm.normalize((nrm * w[:, :, None]).sum(dim=1), eps=1e-30)
    return {"normal": torch.where(has_n[:, None], smooth_n, geom_n),
            "albedo": vm.take_rows(scene.albedo, safe),
            "emission": vm.take_rows(scene.emission, safe)}


def resolve_sphere_hits(scene, sph: torch.Tensor, point: torch.Tensor):
    """Surface attributes of sphere hits: dict(normal, albedo, emission),
    each [N, 3]. sph: [N] sphere ids (-1 = not a sphere: sphere 0's
    attributes, gate on your own mask); point: [N, 3] hit points."""
    safe = sph.clamp(min=0).long()
    return {"normal": vm.normalize(point - scene.sphere_pos[safe],
                                   eps=1e-30),
            "albedo": scene.sphere_albedo[safe],
            "emission": scene.sphere_emission[safe]}


def normal_color(normal: torch.Tensor) -> torch.Tensor:
    """The reference's normals-as-color visualization."""
    return (normal + 1.0) / 2.0


def cosine_sample_hemisphere(normal: torch.Tensor, u1: torch.Tensor,
                             u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about `normal` [N, 3] from the uniforms
    u1, u2 [N], in a branchless Frisvad-style basis."""
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx ** 2 * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny ** 2 * a, -ny], dim=-1)
    return vm.normalize(
        x[..., None] * t1 + y[..., None] * t2 + z[..., None] * normal,
        eps=1e-30)
