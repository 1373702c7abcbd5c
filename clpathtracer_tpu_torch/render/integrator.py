"""The rendering integrator: scene + camera -> image (the slice's part of
clpathtracer_tpu/render/integrator.py).

Three shading modes, all on the prepass-list engine (ops/plist.py) over
the scene's windows:

* "normal": pinhole rays, first hit -> normals as color, miss ->
  background.
* "mirror": the reference's mirror bounces (src/kernel.cl:399-417):
  blend col = (1 - str) col + str normal_color, str *= 0.2, reflect with a
  BOUNCE_EPS origin offset; a miss or the last bounce blends toward the
  background.
* "path": Lambertian path tracing: emission of front faces and the
  background on a miss, weighted by the throughput; cosine-sampled
  bounces; spp > 1 averages jittered samples. With next-event estimation
  (opts.nee) each vertex also samples an emitter (_sample_light) and casts
  a shadow ray through the grid (_occluded); emitters then count on the
  primary hit only.

Two routes, in the JAX package's order (render/integrator.py:197-309):

* windows (MortonWindows with shared-origin tables and fused resolve rows
  attached), when given: primary waves are shared-origin pixel gates
  (traverse_plist, kernel K1), bounce waves Morton-sorted 512-ray bundles
  (traverse_plist_bundle, kernel K1'); unlike the JAX package this route
  needs no kd-tree. opts.plist_schedule picks the primary gates' stream
  schedule: "super" (K1), "window" (K2) or "gathered" (K10, K1 on a
  frame where a gate needs more than its table holds), the explicit form
  of the JAX package's CLPT_PLIST_SUPER=0 / CLPT_PLIST_GATHER=1; bounce
  bundles stay on K1';
* else a kd-tree (accel/sah.py::FlatKdTree with window and SO tables):
  the stream packet engine (ops/packet.py::traverse_packet, kernel K3),
  primary waves as shared-origin pixel tiles of opts.packet_tile rays
  (strip masks on unjittered frames), bounce waves Morton-sorted and
  traced with their active mask; surface attributes from resolve_tri_hits.
  opts.precision="bf16" runs both kinds of wave through the bf16 preview
  (kernel K4: MT tiles with the AABB cull); the windows route ignores it,
  as the JAX package's window engines do. The packet engine's other
  forms (queue K5, legacy K6a/K6b, wide K9, stream2 K7, mxu K8) are
  traverse_packet calls that no frame takes, in the JAX package or here:
  the port's "auto" stays on the stream engine.

A uniform grid (accel/grid.py::build_grid), passed as `grid`, is the
port's counterpart of the JAX package's accel/sah.py::attach_grid (the
windows route has no kd-tree to hang it on). On either route it carries
NEE's shadow rays (any-hit DDA, kernel G1) and, with opts.bounce_grid,
the bounce waves (nearest-hit DDA, unsorted, with the active mask); with
opts.plist_kcap > 0 the primary gates run the two-phase engine (K1's kcap
form, then G1).

Random numbers come from the caller or from a torch.Generator (torch
cannot reproduce jax.random's streams). Anything else raises
NotImplementedError naming the ROADMAP queue-1 item that ports it;
nothing quietly takes another route.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.camera import (cam_matrix, generate_rays,
                                                generate_rays_jittered)
from clpathtracer_tpu_torch.ops.grid_walk import traverse_grid
from clpathtracer_tpu_torch.ops.packet import PRECISIONS, traverse_packet
from clpathtracer_tpu_torch.ops.plist import (GH, GW, traverse_plist,
                                              traverse_plist_bundle)
from clpathtracer_tpu_torch.ops.sort import sort_rays
from clpathtracer_tpu_torch.render.shading import (cosine_sample_hemisphere,
                                                   normal_color,
                                                   resolve_tri_hits)

MODES = ("normal", "mirror", "path")
PLIST_SCHEDULES = ("super", "window", "gathered")
# subpixel jitter bound of spp > 1 samples: jitter is < 1 px, the corner-
# lane hull under-covers a gate by < 1 px per side, plus 1 px of slack
JITTER_PX = 3.0
BOUNCE_EPS = 1e-4  # bounce origin offset along the new direction or normal
                   # (src/kernel.cl:401)


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render configuration: the fields this slice reads."""

    width: int = 256
    height: int = 256
    mode: str = "normal"       # normal | mirror | path
    bounces: int = 2           # the reference launches trace_ray(depth=2)
    spp: int = 1               # samples per pixel (path mode)
    background: float = 1.0    # miss shade
    nee: bool = False          # path mode: next-event estimation
    differentiable: bool = False
    edge_aware: bool = False
    packet_tile: int = 1024    # kd-tree route: rays per packet tile
    packet_strips: bool = True   # kd-tree route: the strip-mask prepass on
    packet_frustum: bool = True  # unjittered primaries, else the corner
    #   frustum cull (the JAX package's CLPT_STRIPS / CLPT_FRUSTUM)
    precision: str = "f32"     # kd-tree route: "bf16" = the preview-quality
    #   dense test (K4); bf16 cancellation in o - v0 costs and adds hits on
    #   triangles much smaller than the scene. The windows route ignores it.
    plist_schedule: str = "super"  # windows route, primary gates: "super"
    #   (K1), "window" (K2) or "gathered" (K10); see traverse_plist
    bounce_grid: bool = True   # with a grid: bounce waves through the grid
    #   DDA (G1), unsorted (the JAX package's CLPT_BOUNCE_GRID default)
    nee_light_stride: int = 1  # NEE: one light sample shared by each run of
    #   this many consecutive rays (correlated but unbiased)
    plist_kcap: int = 0        # windows route with a grid, "super" schedule:
    #   > 0 runs the primary gates' two-phase engine, K1 capped at kcap
    #   entries a gate, then G1 (the JAX package's CLPT_PLIST_KCAP)


def _check_supported(scene, opts: RenderOptions, mwin, tree=None,
                     grid=None) -> None:
    """Raise NotImplementedError for what this slice does not carry."""
    if opts.mode not in MODES:
        raise ValueError(f"unknown mode {opts.mode!r}")
    if opts.precision not in PRECISIONS:
        raise ValueError(f"precision {opts.precision!r} is not one of "
                         f"{PRECISIONS}")
    if opts.plist_schedule not in PLIST_SCHEDULES:
        raise ValueError(f"plist_schedule {opts.plist_schedule!r} is not one "
                         f"of {PLIST_SCHEDULES}")
    if opts.nee_light_stride < 1:
        raise ValueError(f"nee_light_stride {opts.nee_light_stride} < 1")
    if opts.plist_kcap > 0 and (mwin is None or grid is None
                                or opts.plist_schedule != "super"):
        raise ValueError(f"plist_kcap {opts.plist_kcap} needs windows, a grid "
                         "and plist_schedule 'super' (the two-phase engine)")
    todo = None
    if opts.mode == "path" and opts.nee and grid is None:
        todo = ("next-event estimation without a grid (shadow rays through "
                "the kd shadow tree and rope walk) is queue 1 item 3")
    elif opts.differentiable or opts.edge_aware:
        todo = "differentiable / edge-aware rendering is queue 1 item 14"
    elif scene.num_spheres:
        todo = "sphere primitives come with queue 1 item 12"
    elif mwin is None and tree is None:
        todo = ("rendering without windows or a kd-tree (the flat scan and "
                "the brute force) is queue 1 item 12")
    elif mwin is None:
        if (opts.width * opts.height) % opts.packet_tile:
            todo = (f"a {opts.width}x{opts.height} frame is not whole "
                    f"packet tiles of {opts.packet_tile} rays; the JAX "
                    "package sends it to traverse_fast, queue 1 item 12")
    elif opts.height % GH or opts.width % GW:
        todo = (f"a {opts.width}x{opts.height} frame is not a multiple of "
                f"{GW}x{GH} gates; other frames take the kd-tree engines of "
                "queue 1 items 12-13")
    if todo:
        raise NotImplementedError(f"not ported yet: {todo}")


_REC_KEYS = ("hit", "t", "tri", "u", "v", "snormal", "salbedo", "semission")


def intersect_scene(scene, mwin, orig, dir, opts: RenderOptions,
                    coherent: bool = True, active=None,
                    jitter_px: float = 0.0, tree=None, grid=None):
    """Nearest hit. Returns hit [N], t [N], tri [N], u/v [N] and, on the
    windows route's kernels, the fused shade attributes
    snormal/salbedo/semission [N, 3].

    coherent: the wave is the frame's shared-origin pixel-grid primaries
    (jittered by up to jitter_px pixels): gates on the windows route,
    shared-origin pixel tiles on the kd-tree route (strips or corner
    frustum culls only when unjittered). Otherwise the wave is scattered:
    it is Morton-sorted (dead lanes, active False, to the tail), traced in
    512-ray bundles or packet tiles and put back in wave order. Windows,
    when given, win over the tree. A scattered wave with a grid given and
    opts.bounce_grid takes the grid DDA instead, unsorted, with the active
    mask (JAX render/integrator.py:247-260). grid with opts.plist_kcap > 0:
    the primary gates' two-phase engine (traverse_plist)."""
    if not coherent and grid is not None and opts.bounce_grid:
        rec = traverse_grid(grid, orig, dir, active=active)
        return {k: rec[k] for k in _REC_KEYS[:5]}
    if mwin is None:
        keys = _REC_KEYS[:5]
        if coherent:
            rec = traverse_packet(tree, orig, dir, (opts.height, opts.width),
                                  tile=opts.packet_tile, shared_origin=True,
                                  grid_dirs=jitter_px == 0.0,
                                  strips=opts.packet_strips,
                                  frustum=opts.packet_frustum,
                                  precision=opts.precision)
            return {k: rec[k] for k in keys}
        inv, orig, dir, active = sort_wave(orig, dir, active)
        rec = traverse_packet(tree, orig, dir, tile=opts.packet_tile,
                              active=active, precision=opts.precision)
        return {k: rec[k][inv] for k in keys}
    if coherent:
        rec = traverse_plist(mwin, orig, dir, (opts.height, opts.width),
                             dilate_px=jitter_px,
                             supers=opts.plist_schedule != "window",
                             gathered=opts.plist_schedule == "gathered",
                             kcap=opts.plist_kcap, grid=grid)
        return {k: rec[k] for k in _REC_KEYS}
    inv, orig, dir, active = sort_wave(orig, dir, active)
    rec = traverse_plist_bundle(mwin, orig, dir, active=active)
    return {k: rec[k][inv] for k in _REC_KEYS}


def sort_wave(orig, dir, active=None):
    """Morton-sort a scattered wave into bundle order, dead lanes to the
    tail: (inv, orig, dir, active) with the rays, and the mask if given, in
    that order; rec[inv] puts a bundle-order record back in wave order."""
    perm, inv = sort_rays(orig, dir, alive=active)
    return (inv, orig[perm], dir[perm],
            None if active is None else active[perm])


def _surface(scene, rec, orig, dir):
    """Hit point and surface attributes (normal, albedo, emission) of a
    hit record: the shade attributes the fused resolve carried out of the
    winner gather, else resolve_tri_hits on the winner (tri, u, v)."""
    point = orig + rec["t"][:, None] * dir
    if "snormal" in rec:
        return point, rec["snormal"], rec["salbedo"], rec["semission"]
    at = resolve_tri_hits(scene, rec["tri"], rec["u"], rec["v"])
    return point, at["normal"], at["albedo"], at["emission"]


def shade_normal(scene, mwin, orig, dir, opts: RenderOptions, tree=None,
                 grid=None):
    """Reference parity: hit -> (normal + 1) / 2, miss -> background."""
    rec = intersect_scene(scene, mwin, orig, dir, opts, tree=tree, grid=grid)
    _, normal, _, _ = _surface(scene, rec, orig, dir)
    return torch.where(rec["hit"][:, None], normal_color(normal),
                       opts.background)


def mirror_wave(scene, rec, orig, dir, alive):
    """The next wave of a mirror bounce: (hit, orig, dir, normal). Lanes
    that were alive and hit reflect about the shading normal from the hit
    point offset by BOUNCE_EPS along the new direction; the others keep
    their ray. hit is the next wave's live mask."""
    point, normal, _, _ = _surface(scene, rec, orig, dir)
    hit = rec["hit"] & alive
    newdir = vm.reflect(dir, normal)
    return (hit,
            torch.where(hit[:, None], point + newdir * BOUNCE_EPS, orig),
            torch.where(hit[:, None], newdir, dir), normal)


def shade_mirror(scene, mwin, orig, dir, opts: RenderOptions, tree=None,
                 grid=None):
    """The reference's intended mirror-bounce shading. Per bounce
    (src/kernel.cl:399-417): col = (1-str) col + str normal_color;
    str *= 0.2; reflect about the normal (mirror_wave). On a miss or after
    the last bounce: col = (1-str) col + str background."""
    n = orig.shape[0]
    col = torch.zeros((n, 3), device=orig.device)
    strength = torch.ones((n,), device=orig.device)
    alive = torch.ones((n,), dtype=torch.bool, device=orig.device)
    o, d = orig, dir
    for b in range(opts.bounces):
        rec = intersect_scene(scene, mwin, o, d, opts, coherent=(b == 0),
                              active=None if b == 0 else alive, tree=tree,
                              grid=grid)
        hit, o, d, normal = mirror_wave(scene, rec, o, d, alive)
        st = strength[:, None]
        col = torch.where(hit[:, None], (1.0 - st) * col
                          + st * normal_color(normal), col)
        strength = torch.where(hit, strength * 0.2, strength)
        # rays that were alive but missed: blend toward the background
        missed = alive & ~rec["hit"]
        col = torch.where(missed[:, None],
                          (1.0 - st) * col + st * opts.background, col)
        alive = hit
    # the last bounce's still-alive rays (the reference's depth == 0 branch)
    st = strength[:, None]
    return torch.where(alive[:, None],
                       (1.0 - st) * col + st * opts.background, col)


def light_cdf(scene):
    """The emitters' sampling table, once per scene (it depends on the
    scene only; build it beside the grid and pass it to render_image as
    `lights`): a dict of the triangles' cross products [F, 3] (twice the
    area-weighted normals), areas [F], probabilities [F] (luminance x area
    over the total) and their running sum cdf [F], and `any`, whether any
    light is lit: a host bool, one read of the total (the JAX package
    decides it on the device with lax.cond; the port skips NEE's whole
    shadow wave on the host)."""
    v0, v1, v2 = scene.tri_verts()
    cross = vm.cross(v1 - v0, v2 - v0)
    area = 0.5 * vm.length(cross)
    w = scene.emission.amax(dim=-1) * area
    total = w.sum()
    probs = w / torch.clamp(total, min=1e-30)
    return {"cross": cross, "area": area, "probs": probs,
            "cdf": torch.cumsum(probs, dim=0), "any": bool(total > 0.0)}


def _sample_light(scene, light_u, n: int, stride: int = 1, lights=None):
    """Area-sample the emitters (JAX render/integrator.py::_sample_light):
    a face by the inverse CDF over luminance x area, a point uniform in
    its barycentric square-root map. light_u: [ceil(n / stride), 3]
    uniforms in [0, 1), the face uniform and the two barycentric ones;
    stride > 1 shares each sample among a run of `stride` consecutive
    lanes. lights: light_cdf(scene), computed when not given.

    Returns (point [n, 3], normal [n, 3], emission [n, 3], pdf per unit
    area [n]). Meaningless where no light is lit (lights["any"])."""
    if lights is None:
        lights = light_cdf(scene)
    m = -(-n // stride)
    if tuple(light_u.shape) != (m, 3):
        raise ValueError(f"light uniforms {tuple(light_u.shape)}, want "
                         f"{(m, 3)}")
    cdf = lights["cdf"]
    f = torch.searchsorted(cdf, (light_u[:, 0] * cdf[-1]).contiguous())
    f = f.clamp(0, cdf.shape[0] - 1)
    su = torch.sqrt(light_u[:, 1])
    bu = 1.0 - su
    bv = light_u[:, 2] * su
    v0, v1, v2 = (c[f] for c in scene.tri_verts())
    p = bu[:, None] * v0 + bv[:, None] * v1 + (1.0 - bu - bv)[:, None] * v2
    nrm = vm.normalize(lights["cross"][f], eps=1e-30)
    pdf_area = lights["probs"][f] / torch.clamp(lights["area"][f], min=1e-30)
    out = (p, nrm, scene.emission[f], pdf_area)
    if stride > 1:
        out = tuple(x.repeat_interleave(stride, dim=0)[:n] for x in out)
    return out


def _occluded(grid, orig, dir, dist, active=None):
    """Shadow query: is anything closer than dist - 1e-3 along dir? The
    grid's any-hit DDA (kernel G1) with that bound and the active mask,
    the JAX package's grid route (render/integrator.py:520-531). Its other
    routes are not ported: without a grid (the kd shadow tree and rope
    walk) raises NotImplementedError; the sorted-bundle route behind
    CLPT_SHADOW_BUNDLE is a measured negative."""
    if grid is None:
        raise NotImplementedError(
            "not ported yet: shadow rays without a grid (the kd shadow tree "
            "and rope walk) are queue 1 item 3")
    return traverse_grid(grid, orig, dir, t_max=dist - 1e-3, active=active,
                         any_hit=True)["hit"]


def shade_path(scene, mwin, orig, dir, opts: RenderOptions, bounce_u,
               jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
               lights=None):
    """Lambertian path tracing with emissive surfaces: radiance +=
    throughput * emission at each front-face hit and throughput *
    background on a miss; throughput *= albedo; the next direction is
    cosine-sampled about the shading normal, flipped to face the incoming
    ray. bounce_u: [bounces, N, 2] uniforms in [0, 1), one pair per lane
    and bounce.

    opts.nee: at each vertex, with the pre-bounce throughput, an emitter
    point (_sample_light from light_u [bounces, ceil(N / stride), 3];
    lights: light_cdf(scene)) lights the hit through a shadow ray
    (_occluded, needs grid) when both cosines are positive; emission then
    counts on the primary hit only. Without a lit emitter the shadow wave
    is not traced."""
    n = orig.shape[0]
    dev = orig.device
    radiance = torch.zeros((n, 3), device=dev)
    throughput = torch.ones((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if opts.nee and lights is None:
        lights = light_cdf(scene)
    o, d = orig, dir
    for b in range(opts.bounces):
        rec = intersect_scene(scene, mwin, o, d, opts, coherent=(b == 0),
                              active=None if b == 0 else alive,
                              jitter_px=jitter_px if b == 0 else 0.0,
                              tree=tree, grid=grid)
        point, normal, albedo, emission = _surface(scene, rec, o, d)
        # one-sided emitters: front faces only
        cos_in = vm.dot(normal, d)
        front = cos_in < 0.0
        normal = torch.where(cos_in[:, None] > 0, -normal, normal)
        hit = rec["hit"] & alive
        if not opts.nee or b == 0:
            radiance = radiance + torch.where((hit & front)[:, None],
                                              throughput * emission, 0.0)
        missed = alive & ~rec["hit"]
        radiance = radiance + torch.where(
            missed[:, None], throughput * opts.background, 0.0)
        alive = hit
        if opts.nee and lights["any"]:
            radiance = radiance + _direct_light(
                scene, grid, point, normal, albedo, throughput, hit,
                light_u[b], opts.nee_light_stride, lights)
        throughput = torch.where(hit[:, None], throughput * albedo,
                                 throughput)
        u12 = bounce_u[b]
        newdir = cosine_sample_hemisphere(normal, u12[:, 0], u12[:, 1])
        o = torch.where(hit[:, None], point + normal * BOUNCE_EPS, o)
        d = torch.where(hit[:, None], newdir, d)
    return radiance


def nee_wave(scene, point, normal, hit, light_u, stride, lights):
    """NEE's shadow wave at one vertex (JAX render/integrator.py:656-683):
    one emitter sample per lane (_sample_light), the shadow ray from the
    hit point offset by BOUNCE_EPS along the (face-forward) normal toward
    it. Shadow directions that are not finite (a degenerate sample) become
    (0, 1, 0). Returns a dict: orig, dir [N, 3], dist [N] (to the light
    point), live [N] (the hit sees the light's front side at a positive
    cosine: the lanes the wave traces), and for the contribution cos_s,
    cos_l, dist2, emission, pdf."""
    n = point.shape[0]
    lp, ln, lemit, pdf_a = _sample_light(scene, light_u, n, stride, lights)
    to_l = lp - point
    dist2 = torch.clamp(vm.length_squared(to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l / dist[:, None]
    wi_ok = torch.isfinite(wi).all(dim=-1)
    safe = torch.zeros_like(wi)
    safe[:, 1] = 1.0
    wi = torch.where(wi_ok[:, None], wi, safe)
    cos_s = vm.dot(normal, wi)
    cos_l = vm.dot(ln, -wi)
    return {"orig": point + normal * BOUNCE_EPS, "dir": wi, "dist": dist,
            "live": hit & (cos_s > 0.0) & (cos_l > 0.0) & wi_ok,
            "cos_s": cos_s, "cos_l": cos_l, "dist2": dist2,
            "emission": lemit, "pdf": pdf_a}


def _direct_light(scene, grid, point, normal, albedo, throughput, hit,
                  light_u, stride, lights):
    """NEE's contribution at one vertex (JAX render/integrator.py:656-691):
    throughput * albedo / pi * emission * cos_s * cos_l / dist^2 / pdf
    where the hit sees the sampled light point unoccluded (nee_wave,
    _occluded)."""
    w = nee_wave(scene, point, normal, hit, light_u, stride, lights)
    occ = _occluded(grid, w["orig"], w["dir"], w["dist"], active=w["live"])
    g = w["cos_s"] * w["cos_l"] / w["dist2"]
    contrib = (throughput * (albedo / math.pi) * w["emission"]
               * (g / torch.clamp(w["pdf"], min=1e-30))[:, None])
    return torch.where((w["live"] & ~occ)[:, None], contrib, 0.0)


def render_rays(scene, mwin, orig, dir, opts: RenderOptions, bounce_u=None,
                jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
                lights=None):
    """Shade a wave of the frame's primary rays. bounce_u: path mode's
    [bounces, N, 2] uniforms; light_u: with NEE, its [bounces,
    ceil(N / stride), 3] light uniforms; lights: light_cdf(scene), computed
    when not given; jitter_px: the primaries' jitter bound; tree: the
    kd-tree route when mwin is None; grid: the uniform grid (NEE's shadow
    rays, the bounce waves, the two-phase primaries)."""
    _check_supported(scene, opts, mwin, tree, grid)
    if opts.mode == "normal":
        return shade_normal(scene, mwin, orig, dir, opts, tree=tree,
                            grid=grid)
    if opts.mode == "mirror":
        return shade_mirror(scene, mwin, orig, dir, opts, tree=tree,
                            grid=grid)
    if bounce_u is None or (opts.nee and light_u is None):
        raise ValueError("path mode needs its bounce uniforms (bounce_u) "
                         "and, with NEE, its light uniforms (light_u)")
    return shade_path(scene, mwin, orig, dir, opts, bounce_u,
                      jitter_px=jitter_px, tree=tree, grid=grid,
                      light_u=light_u, lights=lights)


def path_draws(opts: RenderOptions, generator: torch.Generator, device):
    """The random numbers of a path-mode frame, uniforms in [0, 1): (jitter
    [S, N, 2] or None, bounce [S, bounces, N, 2], light [S, bounces,
    ceil(N / nee_light_stride), 3] or None), with S = spp when spp > 1
    (jittered samples) and 1 otherwise (pixel-grid rays); light, the face
    uniform and the two barycentric ones of each light sample, with
    opts.nee only."""
    n = opts.width * opts.height
    s = opts.spp if opts.spp > 1 else 1
    jitter = (torch.rand((s, n, 2), generator=generator, device=device)
              if opts.spp > 1 else None)
    bounce = torch.rand((s, opts.bounces, n, 2), generator=generator,
                        device=device)
    m = -(-n // opts.nee_light_stride)
    light = (torch.rand((s, opts.bounces, m, 3), generator=generator,
                        device=device) if opts.nee else None)
    return jitter, bounce, light


def render_image(scene, camera, opts: RenderOptions, mwin=None, *,
                 tree=None, grid=None, lights=None,
                 generator: torch.Generator = None, jitter=None, bounce=None,
                 light=None):
    """Render an [H, W, 3] image. mwin: the scene's MortonWindows with
    shared-origin tables and fused resolve rows attached
    (ops/plist.py::build_morton_windows, attach_so, attach_resolve); tree,
    used when mwin is None: its kd-tree with window and SO tables
    (accel/sah.py::build_kd_tree, attach_so_tables); grid: a uniform grid
    of the same triangles (accel/grid.py::build_grid), the counterpart of
    the JAX package's accel/sah.py::attach_grid, for NEE, the bounce waves
    (opts.bounce_grid) and the two-phase primaries (opts.plist_kcap);
    lights: NEE's light_cdf(scene), built once per scene (computed each
    call when not given).

    Path mode draws its random numbers from `generator` (default: a
    generator on the camera's device seeded 0), or takes them as given:
    jitter [spp, H*W, 2] (spp > 1 only), bounce [S, bounces, H*W, 2] and,
    with NEE, light [S, bounces, ceil(H*W / nee_light_stride), 3]
    (path_draws). spp > 1 averages that many jittered samples; other modes
    render one pixel-grid sample whatever spp is."""
    _check_supported(scene, opts, mwin, tree, grid)
    device = camera.position.device
    cam_inv = cam_matrix(camera, opts.height)
    shape = (opts.height, opts.width, 3)
    if opts.mode != "path":
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        return render_rays(scene, mwin, orig, dir, opts, tree=tree,
                           grid=grid).reshape(shape)
    if bounce is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        jitter, bounce, light = path_draws(opts, generator, device)
    n = opts.width * opts.height
    s = opts.spp if opts.spp > 1 else 1
    m = -(-n // opts.nee_light_stride)
    if tuple(bounce.shape) != (s, opts.bounces, n, 2) or (
            s > 1 and (jitter is None or tuple(jitter.shape) != (s, n, 2))
    ) or (opts.nee and (light is None
                        or tuple(light.shape) != (s, opts.bounces, m, 3))):
        raise ValueError(
            f"path draws: bounce {tuple(bounce.shape)}, jitter "
            f"{None if jitter is None else tuple(jitter.shape)}, light "
            f"{None if light is None else tuple(light.shape)}; want "
            f"{(s, opts.bounces, n, 2)}, for spp > 1 {(s, n, 2)} and with "
            f"NEE {(s, opts.bounces, m, 3)}")
    if opts.nee and lights is None:
        lights = light_cdf(scene)
    samples = []
    for i in range(s):
        if s == 1:
            o, d = generate_rays(cam_inv, opts.width, opts.height)
        else:
            o, d = generate_rays_jittered(cam_inv, opts.width, opts.height,
                                          jitter[i:i + 1])
            o, d = o[0], d[0]
        samples.append(render_rays(
            scene, mwin, o, d, opts, bounce[i],
            jitter_px=JITTER_PX if s > 1 else 0.0, tree=tree, grid=grid,
            light_u=None if light is None else light[i], lights=lights))
    img = samples[0] if s == 1 else torch.stack(samples).mean(dim=0)
    return img.reshape(shape)
