"""Pixels of a frame, worked out again from the inputs: the normal,
mirror and Lambertian path (next-event estimation) shading of the
renderer, frozen, over the brute-force queries of brute.py, in float64.

A frame's pixel is a function of the scene's arrays, the camera pose,
the frame size, the mode's options and the frame's path draws only, so
the reference computes just the sampled pixels. The shading semantics
(clpathtracer_tpu_torch/render/integrator.py): a triangle's shading
normal is its geometric normal (the scenes carry no vertex normals),
albedo 0.75 everywhere, emission as made; BOUNCE_EPS offsets, SHADOW_EPS
shortens a shadow ray; misses shade with the background."""

from __future__ import annotations

import math

import torch

from benchmark.reference import camera
from benchmark.reference.brute import Triangles, _cross, _dot

BOUNCE_EPS = 1e-4
SHADOW_EPS = 1e-3
ALBEDO = 0.75


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-30)


class Scene:
    """The reference's own copy of a scene: float64 corners, unit geometric
    normals, emission, the brute-force clusters and the light table."""

    def __init__(self, arrays: dict, device):
        v = torch.as_tensor(arrays["verts"], dtype=torch.float64,
                            device=device)
        f = torch.as_tensor(arrays["faces"], dtype=torch.int64, device=device)
        self.device = device
        self.corners = v[f]                                    # [F, 3, 3]
        cross = _cross(self.corners[:, 1] - self.corners[:, 0],
                       self.corners[:, 2] - self.corners[:, 0])
        self.normal = _normalize(cross)
        self.emission = torch.as_tensor(arrays["emission"],
                                        dtype=torch.float64, device=device)
        self.tris = Triangles(arrays["verts"], arrays["faces"], device)
        # the light table: luminance x area over the total, its running sum
        self.area = 0.5 * torch.linalg.vector_norm(cross, dim=-1)
        w = self.emission.amax(dim=-1) * self.area
        self.probs = w / torch.clamp(w.sum(), min=1e-300)
        self.cdf = torch.cumsum(self.probs, dim=0)
        self.lit = bool(w.sum() > 0)


def _surface(scene, hit, tri, orig, dir, t):
    safe = torch.where(hit, tri, 0)
    point = orig + torch.where(hit, t, 0.0)[:, None] * dir
    return point, scene.normal[safe], scene.emission[safe]


def _normal_color(n):
    return (n + 1.0) / 2.0


def shade_normal(scene, orig, dir, opts, dtype):
    hit, t, tri = scene.tris.nearest(orig, dir, dtype)
    _, n, _ = _surface(scene, hit, tri, orig, dir, t)
    return torch.where(hit[:, None], _normal_color(n), opts["background"])


def _reflect(d, n):
    return _normalize(d - 2.0 * _dot(d, n)[:, None] * n)


def shade_mirror(scene, orig, dir, opts, dtype):
    n_rays = orig.shape[0]
    f64 = dict(dtype=torch.float64, device=orig.device)
    col = torch.zeros((n_rays, 3), **f64)
    strength = torch.ones((n_rays,), **f64)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=orig.device)
    o, d = orig, dir
    for _ in range(opts["bounces"]):
        rec_hit, t, tri = scene.tris.nearest(o, d, dtype)
        point, normal, _ = _surface(scene, rec_hit, tri, o, d, t)
        hit = rec_hit & alive
        newdir = _reflect(d, normal)
        st = strength[:, None]
        col = torch.where(hit[:, None],
                          (1.0 - st) * col + st * _normal_color(normal), col)
        strength = torch.where(hit, strength * 0.2, strength)
        missed = alive & ~rec_hit
        col = torch.where(missed[:, None],
                          (1.0 - st) * col + st * opts["background"], col)
        o = torch.where(hit[:, None], point + newdir * BOUNCE_EPS, o)
        d = torch.where(hit[:, None], newdir, d)
        alive = hit
    st = strength[:, None]
    return torch.where(alive[:, None], (1.0 - st) * col
                       + st * opts["background"], col)


def cosine_sample_hemisphere(normal, u1, u2):
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x, y = r * torch.cos(theta), r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    nx, ny, nz = normal[:, 0], normal[:, 1], normal[:, 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).double()
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx ** 2 * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny ** 2 * a, -ny], dim=-1)
    return _normalize(x[:, None] * t1 + y[:, None] * t2 + z[:, None] * normal)


def _sample_light(scene, u):
    """Area-sample an emitter: the face by the inverse of the reference's
    own cdf, a point by the square-root barycentric map. u [R, 3]."""
    cdf = scene.cdf
    f = torch.searchsorted(cdf, (u[:, 0] * cdf[-1]).contiguous())
    f = f.clamp(0, cdf.shape[0] - 1)
    su = torch.sqrt(u[:, 1])
    bu, bv = 1.0 - su, u[:, 2] * su
    c = scene.corners[f]
    p = (bu[:, None] * c[:, 0] + bv[:, None] * c[:, 1]
         + (1.0 - bu - bv)[:, None] * c[:, 2])
    pdf = scene.probs[f] / torch.clamp(scene.area[f], min=1e-30)
    return p, scene.normal[f], scene.emission[f], pdf


def _direct_light(scene, point, normal, throughput, hit, light_u, dtype):
    lp, ln, lemit, pdf = _sample_light(scene, light_u)
    to_l = lp - point
    dist2 = torch.clamp(_dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l / dist[:, None]
    wi_ok = torch.isfinite(wi).all(dim=-1)
    safe = torch.zeros_like(wi)
    safe[:, 1] = 1.0
    wi = torch.where(wi_ok[:, None], wi, safe)
    cos_s, cos_l = _dot(normal, wi), _dot(ln, -wi)
    live = hit & (cos_s > 0.0) & (cos_l > 0.0) & wi_ok
    occ = torch.zeros_like(live)
    if bool(live.any()):
        idx = live.nonzero()[:, 0]
        occ[idx] = scene.tris.occluded(point[idx] + normal[idx] * BOUNCE_EPS,
                                       wi[idx], dist[idx] - SHADOW_EPS, dtype)
    g = cos_s * cos_l / dist2
    contrib = (throughput * (ALBEDO / math.pi) * lemit
               * (g / torch.clamp(pdf, min=1e-30))[:, None])
    return torch.where((live & ~occ)[:, None], contrib, 0.0)


def shade_path(scene, orig, dir, opts, bounce_u, light_u, dtype):
    """One sample a ray: bounce_u [bounces, R, 2], light_u [bounces, R, 3]
    (None without NEE)."""
    n_rays = orig.shape[0]
    f64 = dict(dtype=torch.float64, device=orig.device)
    radiance = torch.zeros((n_rays, 3), **f64)
    throughput = torch.ones((n_rays, 3), **f64)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=orig.device)
    o, d = orig, dir
    for b in range(opts["bounces"]):
        rec_hit, t, tri = scene.tris.nearest(o, d, dtype)
        point, normal, emission = _surface(scene, rec_hit, tri, o, d, t)
        cos_in = _dot(normal, d)
        front = cos_in < 0.0
        normal = torch.where(cos_in[:, None] > 0, -normal, normal)
        hit = rec_hit & alive
        if not opts["nee"] or b == 0:
            radiance = radiance + torch.where((hit & front)[:, None],
                                              throughput * emission, 0.0)
        missed = alive & ~rec_hit
        radiance = radiance + torch.where(missed[:, None],
                                          throughput * opts["background"], 0.0)
        alive = hit
        if opts["nee"] and scene.lit:
            radiance = radiance + _direct_light(
                scene, point, normal, throughput, hit, light_u[b].double(),
                dtype)
        throughput = torch.where(hit[:, None], throughput * ALBEDO, throughput)
        u = bounce_u[b].double()
        newdir = cosine_sample_hemisphere(normal, u[:, 0], u[:, 1])
        o = torch.where(hit[:, None], point + normal * BOUNCE_EPS, o)
        d = torch.where(hit[:, None], newdir, d)
    return radiance


def frame_pixels(scene, traffic, camera_spec, pos, fwd, pixels, draws,
                 dtype=torch.float64, px_offset=(0.0, 0.0)):
    """The pixels `pixels` [P] of the frame at pose (pos, fwd) with path
    draws `draws` (inputs.frame_draws), [P, 3] float64. dtype: the pair
    test's precision (the control computes it in bfloat16); px_offset
    (x, y) moves every ray's pixel position (the check's look at
    decisions that rounding can tip)."""
    w, h = traffic["width"], traffic["height"]
    cam_inv = camera.cam_inverse(pos, fwd, h, camera_spec["fov"],
                                 device=scene.device)
    pix = torch.as_tensor(pixels, device=scene.device)
    off = torch.tensor(px_offset, dtype=torch.float64,
                       device=scene.device).expand(pix.shape[0], 2)
    if traffic["mode"] != "path":
        orig, dir = camera.pixel_rays(cam_inv, w, h, pix, off)
        shade = shade_normal if traffic["mode"] == "normal" else shade_mirror
        return shade(scene, orig, dir, traffic, dtype)
    spp = traffic["spp"]
    out = []
    for s in range(spp if spp > 1 else 1):
        jit = (draws["jitter"][s, pix].double() + off) if spp > 1 else off
        orig, dir = camera.pixel_rays(cam_inv, w, h, pix, jit)
        light = draws["light"][s][:, pix] if traffic["nee"] else None
        out.append(shade_path(scene, orig, dir, traffic,
                              draws["bounce"][s][:, pix], light, dtype))
    return torch.stack(out).mean(dim=0)
