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
* "path": Lambertian path tracing without next-event estimation:
  emission of front faces and the background on a miss, weighted by the
  throughput; cosine-sampled bounces; spp > 1 averages jittered samples.

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

Random numbers come from the caller or from a torch.Generator (torch
cannot reproduce jax.random's streams). Anything else raises
NotImplementedError naming the ROADMAP queue-1 item that ports it;
nothing quietly takes another route.
"""

from __future__ import annotations

import dataclasses

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.camera import (cam_matrix, generate_rays,
                                                generate_rays_jittered)
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


def _check_supported(scene, opts: RenderOptions, mwin, tree=None) -> None:
    """Raise NotImplementedError for what this slice does not carry."""
    if opts.mode not in MODES:
        raise ValueError(f"unknown mode {opts.mode!r}")
    if opts.precision not in PRECISIONS:
        raise ValueError(f"precision {opts.precision!r} is not one of "
                         f"{PRECISIONS}")
    if opts.plist_schedule not in PLIST_SCHEDULES:
        raise ValueError(f"plist_schedule {opts.plist_schedule!r} is not one "
                         f"of {PLIST_SCHEDULES}")
    todo = None
    if opts.mode == "path" and opts.nee:
        todo = ("next-event estimation (shadow rays through the grid DDA or "
                "the kd rope walk) is queue 1 item 10")
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
                    jitter_px: float = 0.0, tree=None):
    """Nearest hit. Returns hit [N], t [N], tri [N], u/v [N] and, on the
    windows route, the fused shade attributes snormal/salbedo/semission
    [N, 3].

    coherent: the wave is the frame's shared-origin pixel-grid primaries
    (jittered by up to jitter_px pixels): gates on the windows route,
    shared-origin pixel tiles on the kd-tree route (strips or corner
    frustum culls only when unjittered). Otherwise the wave is scattered:
    it is Morton-sorted (dead lanes, active False, to the tail), traced in
    512-ray bundles or packet tiles and put back in wave order. Windows,
    when given, win over the tree."""
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
                             gathered=opts.plist_schedule == "gathered")
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


def shade_normal(scene, mwin, orig, dir, opts: RenderOptions, tree=None):
    """Reference parity: hit -> (normal + 1) / 2, miss -> background."""
    rec = intersect_scene(scene, mwin, orig, dir, opts, tree=tree)
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


def shade_mirror(scene, mwin, orig, dir, opts: RenderOptions, tree=None):
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
                              active=None if b == 0 else alive, tree=tree)
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


def shade_path(scene, mwin, orig, dir, opts: RenderOptions, bounce_u,
               jitter_px: float = 0.0, tree=None):
    """Lambertian path tracing with emissive surfaces, without NEE:
    radiance += throughput * emission at each front-face hit and
    throughput * background on a miss; throughput *= albedo; the next
    direction is cosine-sampled about the shading normal, flipped to face
    the incoming ray. bounce_u: [bounces, N, 2] uniforms in [0, 1), one
    pair per lane and bounce."""
    n = orig.shape[0]
    dev = orig.device
    radiance = torch.zeros((n, 3), device=dev)
    throughput = torch.ones((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    o, d = orig, dir
    for b in range(opts.bounces):
        rec = intersect_scene(scene, mwin, o, d, opts, coherent=(b == 0),
                              active=None if b == 0 else alive,
                              jitter_px=jitter_px if b == 0 else 0.0,
                              tree=tree)
        point, normal, albedo, emission = _surface(scene, rec, o, d)
        # one-sided emitters: front faces only
        cos_in = vm.dot(normal, d)
        front = cos_in < 0.0
        normal = torch.where(cos_in[:, None] > 0, -normal, normal)
        hit = rec["hit"] & alive
        radiance = radiance + torch.where((hit & front)[:, None],
                                          throughput * emission, 0.0)
        missed = alive & ~rec["hit"]
        radiance = radiance + torch.where(
            missed[:, None], throughput * opts.background, 0.0)
        alive = hit
        throughput = torch.where(hit[:, None], throughput * albedo,
                                 throughput)
        u12 = bounce_u[b]
        newdir = cosine_sample_hemisphere(normal, u12[:, 0], u12[:, 1])
        o = torch.where(hit[:, None], point + normal * BOUNCE_EPS, o)
        d = torch.where(hit[:, None], newdir, d)
    return radiance


def render_rays(scene, mwin, orig, dir, opts: RenderOptions, bounce_u=None,
                jitter_px: float = 0.0, tree=None):
    """Shade a wave of the frame's primary rays. bounce_u: path mode's
    [bounces, N, 2] uniforms; jitter_px: the primaries' jitter bound;
    tree: the kd-tree route when mwin is None."""
    _check_supported(scene, opts, mwin, tree)
    if opts.mode == "normal":
        return shade_normal(scene, mwin, orig, dir, opts, tree=tree)
    if opts.mode == "mirror":
        return shade_mirror(scene, mwin, orig, dir, opts, tree=tree)
    if bounce_u is None:
        raise ValueError("path mode needs its bounce uniforms (bounce_u)")
    return shade_path(scene, mwin, orig, dir, opts, bounce_u,
                      jitter_px=jitter_px, tree=tree)


def path_draws(opts: RenderOptions, generator: torch.Generator, device):
    """The random numbers of a path-mode frame: (jitter [S, N, 2] or None,
    bounce [S, bounces, N, 2]), uniforms in [0, 1), with S = spp when
    spp > 1 (jittered samples) and 1 otherwise (pixel-grid rays)."""
    n = opts.width * opts.height
    s = opts.spp if opts.spp > 1 else 1
    jitter = (torch.rand((s, n, 2), generator=generator, device=device)
              if opts.spp > 1 else None)
    bounce = torch.rand((s, opts.bounces, n, 2), generator=generator,
                        device=device)
    return jitter, bounce


def render_image(scene, camera, opts: RenderOptions, mwin=None, *,
                 tree=None, generator: torch.Generator = None, jitter=None,
                 bounce=None):
    """Render an [H, W, 3] image. mwin: the scene's MortonWindows with
    shared-origin tables and fused resolve rows attached
    (ops/plist.py::build_morton_windows, attach_so, attach_resolve); tree,
    used when mwin is None: its kd-tree with window and SO tables
    (accel/sah.py::build_kd_tree, attach_so_tables).

    Path mode draws its random numbers from `generator` (default: a
    generator on the camera's device seeded 0), or takes them as given:
    jitter [spp, H*W, 2] (spp > 1 only) and bounce [S, bounces, H*W, 2]
    (path_draws). spp > 1 averages that many jittered samples; other modes
    render one pixel-grid sample whatever spp is."""
    _check_supported(scene, opts, mwin, tree)
    device = camera.position.device
    cam_inv = cam_matrix(camera, opts.height)
    shape = (opts.height, opts.width, 3)
    if opts.mode != "path":
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        return render_rays(scene, mwin, orig, dir, opts,
                           tree=tree).reshape(shape)
    if bounce is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        jitter, bounce = path_draws(opts, generator, device)
    n = opts.width * opts.height
    s = opts.spp if opts.spp > 1 else 1
    if tuple(bounce.shape) != (s, opts.bounces, n, 2) or (
            s > 1 and (jitter is None or tuple(jitter.shape) != (s, n, 2))):
        raise ValueError(
            f"path draws: bounce {tuple(bounce.shape)}, jitter "
            f"{None if jitter is None else tuple(jitter.shape)}; want "
            f"{(s, opts.bounces, n, 2)} and, for spp > 1, {(s, n, 2)}")
    if s == 1:
        orig, dir = generate_rays(cam_inv, opts.width, opts.height)
        img = render_rays(scene, mwin, orig, dir, opts, bounce[0],
                          tree=tree)
    else:
        samples = []
        for i in range(s):
            o, d = generate_rays_jittered(cam_inv, opts.width, opts.height,
                                          jitter[i:i + 1])
            samples.append(render_rays(scene, mwin, o[0], d[0], opts,
                                       bounce[i], jitter_px=JITTER_PX,
                                       tree=tree))
        img = torch.stack(samples).mean(dim=0)
    return img.reshape(shape)
