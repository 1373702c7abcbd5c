"""The rendering integrator: scene + camera -> image (the slice's part of
clpathtracer_tpu/render/integrator.py).

Three shading modes:

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
  a shadow ray (_occluded); emitters then count on the primary hit only.

The structures are explicit arguments: `mwin` (MortonWindows with
shared-origin tables and fused resolve rows), `tree` (accel/sah.py::
FlatKdTree), `grid` (accel/grid.py::UniformGrid, the counterpart of the
JAX package's tree.grid) and `shadow` (the walk-tuned second tree of
accel/sah.py::build_shadow_tree, the counterpart of tree.shadow).
intersect_scene routes each wave as the JAX package does
(render/integrator.py:144-362):

* coherent waves (the frame's primaries): the windows' shared-origin
  gates (traverse_plist, kernel K1) when the frame is whole gates; else on
  a tri_block 4 tree the per-ray rope walk (ops/traverse_fast.py::
  traverse_fast, kernel W1), the JAX default opts.intersector="wavefront",
  or with intersector="packet" on whole tiles the stream packet engine
  (ops/packet.py::traverse_packet, kernel K3; K4 with precision="bf16");
  opts.plist_schedule picks the gates' schedule (K1, K2, K10);
* scattered waves (bounces): the grid DDA (kernel G1) with a grid and
  opts.bounce_grid; else W1 on the shadow tree with opts.bounce_walk; else
  Morton-sorted 512-ray bundles on the windows (K1'); else on the tree K3
  sorted (intersector="packet") or W1;
* a tree of another tri_block takes the walk in its ops/traverse.py::
  traverse form, W1 with the tree's block size;
* no structure: the flat scan (ops/intersect.py::flat_scan, kernel W2).

Spheres merge after every route with a strict < (ops/intersect.py::
merge_spheres). NEE's shadow query (_occluded) takes G1's any-hit walk
with a grid, else W1's any-hit walk with t_max on the shadow tree or a
tri_block 4 tree, else a scattered wave through intersect_scene. Every
walk stops a ray after MAX_ITERS steps. Random numbers come from the
caller or from a torch.Generator (torch cannot reproduce jax.random's
streams).
Differentiable and edge-aware rendering raise NotImplementedError (ROADMAP
queue 1 item 4); nothing quietly takes another route.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.camera import (cam_matrix, generate_rays,
                                                generate_rays_jittered)
from clpathtracer_tpu_torch.ops.grid_walk import traverse_grid
from clpathtracer_tpu_torch.ops.intersect import (flat_scan, merge_spheres,
                                                  miss_record, nearest_sphere)
from clpathtracer_tpu_torch.ops.packet import PRECISIONS, traverse_packet
from clpathtracer_tpu_torch.ops.plist import (GH, GW, traverse_plist,
                                              traverse_plist_bundle)
from clpathtracer_tpu_torch.ops.sort import sort_rays
from clpathtracer_tpu_torch.ops.traverse import traverse
from clpathtracer_tpu_torch.ops.traverse_fast import traverse_fast
from clpathtracer_tpu_torch.render.shading import (cosine_sample_hemisphere,
                                                   normal_color,
                                                   resolve_sphere_hits,
                                                   resolve_tri_hits)

MODES = ("normal", "mirror", "path")
PLIST_SCHEDULES = ("super", "window", "gathered")
INTERSECTORS = ("wavefront", "packet")
# subpixel jitter bound of spp > 1 samples: jitter is < 1 px, the corner-
# lane hull under-covers a gate by < 1 px per side, plus 1 px of slack
JITTER_PX = 3.0
BOUNCE_EPS = 1e-4  # bounce origin offset along the new direction or normal
                   # (src/kernel.cl:401)
SHADOW_EPS = 1e-3  # a shadow ray's bound: the light distance less this
MAX_ITERS = 16384  # per-ray step cap of the walks (W1, G1): the JAX
                   # package's RenderOptions.max_iters default


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render configuration: the fields this slice reads."""

    width: int = 256
    height: int = 256
    mode: str = "normal"       # normal | mirror | path
    bounces: int = 2           # the reference launches trace_ray(depth=2)
    spp: int = 1               # samples per pixel (path mode)
    background: float = 1.0    # miss shade
    intersector: str = "wavefront"  # tree route: "wavefront" (the per-ray
    #   rope walk W1, the JAX default) or "packet" (the stream engine K3)
    nee: bool = False          # path mode: next-event estimation
    differentiable: bool = False
    edge_aware: bool = False
    packet_tile: int = 1024    # packet route: rays per packet tile
    packet_strips: bool = True   # packet route: the strip-mask prepass on
    packet_frustum: bool = True  # unjittered primaries, else the corner
    #   frustum cull (the JAX package's CLPT_STRIPS / CLPT_FRUSTUM)
    precision: str = "f32"     # packet route: "bf16" = the preview-quality
    #   dense test (K4); bf16 cancellation in o - v0 costs and adds hits on
    #   triangles much smaller than the scene. The windows route ignores
    #   it; the rope walk raises ValueError on it.
    plist_schedule: str = "super"  # windows route, primary gates: "super"
    #   (K1), "window" (K2) or "gathered" (K10); see traverse_plist
    bounce_grid: bool = True   # with a grid: bounce waves through the grid
    #   DDA (G1), unsorted (the JAX package's CLPT_BOUNCE_GRID default)
    bounce_walk: bool = True   # with a shadow tree: bounce waves through
    #   the rope walk on it (W1), unsorted (CLPT_BOUNCE_WALK's default)
    nee_light_stride: int = 1  # NEE: one light sample shared by each run of
    #   this many consecutive rays (correlated but unbiased)
    plist_kcap: int = 0        # windows route with a grid, "super" schedule:
    #   > 0 runs the primary gates' two-phase engine, K1 capped at kcap
    #   entries a gate, then G1 (the JAX package's CLPT_PLIST_KCAP)


def _whole_gates(opts: RenderOptions) -> bool:
    return opts.height % GH == 0 and opts.width % GW == 0


def _check_supported(scene, opts: RenderOptions, mwin, tree=None,
                     grid=None) -> None:
    """Raise for options and structures that no route carries."""
    if opts.mode not in MODES:
        raise ValueError(f"unknown mode {opts.mode!r}")
    if opts.precision not in PRECISIONS:
        raise ValueError(f"precision {opts.precision!r} is not one of "
                         f"{PRECISIONS}")
    if opts.plist_schedule not in PLIST_SCHEDULES:
        raise ValueError(f"plist_schedule {opts.plist_schedule!r} is not one "
                         f"of {PLIST_SCHEDULES}")
    if opts.intersector not in INTERSECTORS:
        raise ValueError(f"intersector {opts.intersector!r} is not one of "
                         f"{INTERSECTORS}")
    if opts.nee_light_stride < 1:
        raise ValueError(f"nee_light_stride {opts.nee_light_stride} < 1")
    if opts.plist_kcap > 0 and (mwin is None or grid is None
                                or opts.plist_schedule != "super"):
        raise ValueError(f"plist_kcap {opts.plist_kcap} needs windows, a grid "
                         "and plist_schedule 'super' (the two-phase engine)")
    if mwin is not None and tree is None and not _whole_gates(opts):
        raise ValueError(
            f"a {opts.width}x{opts.height} frame is not a multiple of "
            f"{GW}x{GH} gates: the windows route needs whole gates; pass its "
            "kd-tree as tree= (the rope walk takes such frames)")
    if opts.differentiable or opts.edge_aware:
        raise NotImplementedError(
            "not ported yet: differentiable / edge-aware rendering is "
            "ROADMAP queue 1 item 4")


_REC_KEYS = ("hit", "t", "tri", "u", "v", "snormal", "salbedo", "semission")


def _walk(tree, orig, dir, opts: RenderOptions, active=None):
    """The rope walk W1 of a wave on `tree`: traverse_fast on a tri_block 4
    tree, else traverse with the tree's tri_block records a step. bf16
    raises: the walk has no preview form (the JAX package ignores the
    option there)."""
    if opts.precision != "f32":
        raise ValueError(f"precision {opts.precision!r}: the rope walk "
                         "(intersector='wavefront') computes in f32 only; "
                         "use intersector='packet'")
    if tree.tri_block == 4:
        return traverse_fast(tree, orig, dir, max_iters=MAX_ITERS,
                             active=active)
    return traverse(tree, orig, dir, tree.tri_block, MAX_ITERS,
                    active=active)


def _intersect_tris(scene, mwin, orig, dir, opts, coherent, active,
                    jitter_px, tree, grid, shadow):
    keys = _REC_KEYS[:5]
    if coherent and mwin is not None and _whole_gates(opts):
        rec = traverse_plist(mwin, orig, dir, (opts.height, opts.width),
                             dilate_px=jitter_px,
                             supers=opts.plist_schedule != "window",
                             gathered=opts.plist_schedule == "gathered",
                             kcap=opts.plist_kcap, grid=grid)
        return {k: rec[k] for k in _REC_KEYS}
    if not coherent:
        if grid is not None and opts.bounce_grid:
            rec = traverse_grid(grid, orig, dir, active=active,
                                max_iters=MAX_ITERS)
            return {k: rec[k] for k in keys}
        if shadow is not None and opts.bounce_walk:
            rec = _walk(shadow, orig, dir, opts, active)
            return {k: rec[k] for k in keys}
        if mwin is not None:
            inv, orig, dir, active = sort_wave(orig, dir, active)
            rec = traverse_plist_bundle(mwin, orig, dir, active=active)
            return {k: rec[k][inv] for k in _REC_KEYS}
    if tree is None:
        return flat_scan(scene, orig, dir)
    if (opts.intersector == "packet" and tree.tri_block == 4
            and orig.shape[0] % opts.packet_tile == 0):
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
    rec = _walk(tree, orig, dir, opts, active)
    return {k: rec[k] for k in keys}


def intersect_scene(scene, mwin, orig, dir, opts: RenderOptions,
                    coherent: bool = True, active=None,
                    jitter_px: float = 0.0, tree=None, grid=None,
                    shadow=None):
    """Nearest hit. Returns hit [N], t [N], tri [N], u/v [N], with spheres
    in the scene sphere [N] (-1 where the nearest hit is not a sphere),
    and on the windows route's kernels the fused shade attributes
    snormal/salbedo/semission [N, 3].

    coherent: the wave is the frame's shared-origin pixel-grid primaries
    (jittered by up to jitter_px pixels); otherwise it is scattered, and
    active [N] (optional) masks its dead lanes. The route is the module
    docstring's: windows (K1 gates, K1' sorted bundles), the tree (W1, or
    K3 with opts.intersector="packet"), the grid (G1) and the shadow tree
    (W1) for scattered waves, the flat scan (W2) without a structure.
    grid with opts.plist_kcap > 0: the primary gates' two-phase engine
    (traverse_plist)."""
    if scene.num_tris:
        rec = _intersect_tris(scene, mwin, orig, dir, opts, coherent, active,
                              jitter_px, tree, grid, shadow)
    else:
        rec = miss_record(orig.shape[0], orig.device)
    if scene.num_spheres:
        rec = merge_spheres(scene, rec, orig, dir)
    return rec


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
    winner gather, else resolve_tri_hits on the winner (tri, u, v); a
    sphere hit's from resolve_sphere_hits."""
    point = orig + rec["t"][:, None] * dir
    if "snormal" in rec:
        at = (rec["snormal"], rec["salbedo"], rec["semission"])
    elif scene.num_tris == 0:
        z = torch.zeros_like(point)
        at = (z, z, z)
    else:
        r = resolve_tri_hits(scene, rec["tri"], rec["u"], rec["v"])
        at = (r["normal"], r["albedo"], r["emission"])
    if scene.num_spheres:
        sph = resolve_sphere_hits(scene, rec["sphere"], point)
        is_sph = (rec["sphere"] >= 0)[:, None]
        at = tuple(torch.where(is_sph, sph[k], x) for k, x in
                   zip(("normal", "albedo", "emission"), at))
    return (point, *at)


def shade_normal(scene, mwin, orig, dir, opts: RenderOptions, tree=None,
                 grid=None, shadow=None):
    """Reference parity: hit -> (normal + 1) / 2, miss -> background."""
    rec = intersect_scene(scene, mwin, orig, dir, opts, tree=tree, grid=grid,
                          shadow=shadow)
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
                 grid=None, shadow=None):
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
                              grid=grid, shadow=shadow)
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


def _occluded(scene, orig, dir, dist, opts: RenderOptions, active=None, *,
              mwin=None, tree=None, grid=None, shadow=None):
    """Shadow query: is anything closer than dist - SHADOW_EPS along dir?
    (JAX render/integrator.py:466-557.) With a grid, its any-hit DDA (G1)
    with that bound and the active mask; else with the shadow tree, or a
    tri_block 4 tree, the rope walk's any-hit form (W1) with that t_max;
    else a scattered wave through intersect_scene
    (K1' bundles on windows alone, the traverse form on another tree, the
    flat scan W2 with no structure) and its t below the bound. Spheres are
    ORed in on the walks' routes (intersect_scene carries them on the
    last). The sorted-bundle route behind CLPT_SHADOW_BUNDLE is a measured
    negative and is not ported."""
    t_max = dist - SHADOW_EPS
    if grid is not None:
        occ = traverse_grid(grid, orig, dir, t_max=t_max, active=active,
                            any_hit=True, max_iters=MAX_ITERS)["hit"]
    elif shadow is not None or (tree is not None and tree.tri_block == 4):
        if opts.precision != "f32":
            raise ValueError(f"precision {opts.precision!r}: the rope walk "
                             "computes in f32 only")
        occ = traverse_fast(shadow if shadow is not None else tree, orig,
                            dir, max_iters=MAX_ITERS, t_max=t_max,
                            active=active, any_hit=True)["hit"]
    else:
        rec = intersect_scene(scene, mwin, orig, dir, opts, coherent=False,
                              active=active, tree=tree)
        return rec["hit"] & (rec["t"] < t_max)
    if scene.num_spheres:
        occ = occ | (nearest_sphere(scene, orig, dir)[0] < t_max)
    return occ


def shade_path(scene, mwin, orig, dir, opts: RenderOptions, bounce_u,
               jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
               lights=None, shadow=None):
    """Lambertian path tracing with emissive surfaces: radiance +=
    throughput * emission at each front-face hit and throughput *
    background on a miss; throughput *= albedo; the next direction is
    cosine-sampled about the shading normal, flipped to face the incoming
    ray. bounce_u: [bounces, N, 2] uniforms in [0, 1), one pair per lane
    and bounce.

    opts.nee: at each vertex, with the pre-bounce throughput, an emitter
    point (_sample_light from light_u [bounces, ceil(N / stride), 3];
    lights: light_cdf(scene)) lights the hit through a shadow ray
    (_occluded) when both cosines are positive; emission then
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
                              tree=tree, grid=grid, shadow=shadow)
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
                scene, point, normal, albedo, throughput, hit, light_u[b],
                opts, lights, mwin=mwin, tree=tree, grid=grid, shadow=shadow)
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


def _direct_light(scene, point, normal, albedo, throughput, hit, light_u,
                  opts, lights, **structures):
    """NEE's contribution at one vertex (JAX render/integrator.py:656-691):
    throughput * albedo / pi * emission * cos_s * cos_l / dist^2 / pdf
    where the hit sees the sampled light point unoccluded (nee_wave,
    _occluded)."""
    w = nee_wave(scene, point, normal, hit, light_u, opts.nee_light_stride,
                 lights)
    occ = _occluded(scene, w["orig"], w["dir"], w["dist"], opts,
                    active=w["live"], **structures)
    g = w["cos_s"] * w["cos_l"] / w["dist2"]
    contrib = (throughput * (albedo / math.pi) * w["emission"]
               * (g / torch.clamp(w["pdf"], min=1e-30))[:, None])
    return torch.where((w["live"] & ~occ)[:, None], contrib, 0.0)


def render_rays(scene, mwin, orig, dir, opts: RenderOptions, bounce_u=None,
                jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
                lights=None, shadow=None):
    """Shade a wave of the frame's primary rays. bounce_u: path mode's
    [bounces, N, 2] uniforms; light_u: with NEE, its [bounces,
    ceil(N / stride), 3] light uniforms; lights: light_cdf(scene), computed
    when not given; jitter_px: the primaries' jitter bound; tree, grid,
    shadow: as render_image's."""
    _check_supported(scene, opts, mwin, tree, grid)
    if opts.mode == "normal":
        return shade_normal(scene, mwin, orig, dir, opts, tree=tree,
                            grid=grid, shadow=shadow)
    if opts.mode == "mirror":
        return shade_mirror(scene, mwin, orig, dir, opts, tree=tree,
                            grid=grid, shadow=shadow)
    if bounce_u is None or (opts.nee and light_u is None):
        raise ValueError("path mode needs its bounce uniforms (bounce_u) "
                         "and, with NEE, its light uniforms (light_u)")
    return shade_path(scene, mwin, orig, dir, opts, bounce_u,
                      jitter_px=jitter_px, tree=tree, grid=grid,
                      light_u=light_u, lights=lights, shadow=shadow)


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
                 tree=None, grid=None, shadow=None, lights=None,
                 generator: torch.Generator = None, jitter=None, bounce=None,
                 light=None):
    """Render an [H, W, 3] image. Each structure is optional (none: the
    flat scan, W2). mwin: the scene's MortonWindows with shared-origin
    tables and fused resolve rows attached (ops/plist.py::
    build_morton_windows, attach_so, attach_resolve); tree: its kd-tree
    (accel/sah.py::build_kd_tree; with SO tables, attach_so_tables, for
    intersector="packet"), the route of frames that are not whole gates
    and, without windows, of every wave; grid: a uniform grid of the same
    triangles (accel/grid.py::build_grid), the counterpart of the JAX
    package's accel/sah.py::attach_grid, for NEE, the bounce waves
    (opts.bounce_grid) and the two-phase primaries (opts.plist_kcap);
    shadow: the walk-tuned tree (accel/sah.py::build_shadow_tree), the
    counterpart of attach_shadow_tree, for NEE without a grid and the
    bounce waves (opts.bounce_walk); lights: NEE's light_cdf(scene), built
    once per scene (computed each call when not given).

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
                           grid=grid, shadow=shadow).reshape(shape)
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
            light_u=None if light is None else light[i], lights=lights,
            shadow=shadow))
    img = samples[0] if s == 1 else torch.stack(samples).mean(dim=0)
    return img.reshape(shape)
