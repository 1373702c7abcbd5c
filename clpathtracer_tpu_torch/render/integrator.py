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

The structures are explicit arguments: `mwin` (MortonWindows, with
shared-origin tables and, optionally, fused resolve rows: without them the
winner's shade attributes come from resolve_tri_hits in _surface), `tree`
(accel/sah.py::FlatKdTree), `grid` (accel/grid.py::UniformGrid, the
counterpart of the JAX package's tree.grid) and `shadow` (the walk-tuned
second tree of accel/sah.py::build_shadow_tree, the counterpart of
tree.shadow). intersect_scene routes each wave as the JAX package does
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
  sorted (intersector="packet") or W1. opts.sort_bounces=False (the JAX
  package's unsorted waves): with intersector="packet" on a tri_block 4
  tree K3 takes the wave unsorted first, in pixel-blocked tiles when it
  is the frame; the windows' bundles are skipped (the tree's branch
  follows; windows alone raise ValueError);
* a tree of another tri_block takes the walk in its ops/traverse.py::
  traverse form, W1 with the tree's block size;
* a parallel/treelet.py::ShardedTree takes intersect_ring for every wave
  that the windows do not carry, primary or bounce (W1 on each treelet
  block, t_max the running best; the blocks rotate over the ranks of its
  "scene" group), and carries NEE's shadow rays the same way (hit and t
  below the bound, JAX render/integrator.py:477-481);
* no structure: the flat scan (ops/intersect.py::flat_scan, kernel W2).

Spheres merge after every route with a strict < (ops/intersect.py::
merge_spheres). NEE's shadow query (_occluded) takes G1's any-hit walk
with a grid, else W1's any-hit walk with t_max on the shadow tree or a
tri_block 4 tree, else a scattered wave through intersect_scene. Every
walk stops a ray after MAX_ITERS steps. Random numbers come from the
caller or from a torch.Generator (torch cannot reproduce jax.random's
streams).

opts.differentiable (JAX diff/grad.py): every wave's topology comes from
diff/grad.py::intersect_diff, the walks' kernels under no_grad on
detached rays and records, then one differentiable Moller-Trumbore per
ray against the winner; shading resolves from the scene's tensors, not
the baked rows; the shadow query carries no gradient; NEE's light table
is built from the live scene on every call. Its routes are the plain
frame's (_intersect_tris) without the windows and the shadow tree, as
in the JAX function: the tree (W1, or K3 with intersector="packet"),
the grid (G1) for scattered waves with opts.bounce_grid, the flat scan
(W2) without a tree; a frame whose only structure is windows raises
ValueError.
opts.edge_aware (normal and path modes): shade_edgeaware blends a
one-pixel band at the winners' triangle boundaries toward the
continuation ray's shading, the silhouette term of the gradient.
Nothing quietly takes another route.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.camera import (cam_matrix, generate_rays,
                                                generate_rays_jittered)
from clpathtracer_tpu_torch.diff.grad import intersect_diff
from clpathtracer_tpu_torch.ops.grid_walk import traverse_grid
from clpathtracer_tpu_torch.ops.intersect import (flat_scan, merge_spheres,
                                                  miss_record, nearest_sphere)
from clpathtracer_tpu_torch.ops.packet import PRECISIONS, traverse_packet
from clpathtracer_tpu_torch.ops.plist import (GH, GW, traverse_plist,
                                              traverse_plist_bundle)
from clpathtracer_tpu_torch.ops.sort import sort_rays
from clpathtracer_tpu_torch.ops.traverse import traverse
from clpathtracer_tpu_torch.ops.traverse_fast import traverse_fast
from clpathtracer_tpu_torch.parallel.treelet import ShardedTree, intersect_ring
from clpathtracer_tpu_torch.render.shading import (cosine_sample_hemisphere,
                                                   normal_color,
                                                   resolve_sphere_hits,
                                                   resolve_tri_hits)
from clpathtracer_tpu_torch.utils.profiling import span

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
    differentiable: bool = False  # detached-topology hits (diff/grad.py):
    #   backward() reaches the camera, verts, normals and materials
    edge_aware: bool = False   # normal and path modes: blend a one-pixel
    #   band at triangle boundaries toward the continuation ray's shading,
    #   so the gradient carries the silhouette term (shade_edgeaware)
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
    sort_bounces: bool = True  # scattered waves: Morton-sort into coherent
    #   bundles or tiles (K1', sorted K3). False: with intersector="packet"
    #   on a tri_block 4 tree, K3 takes them unsorted (pixel-blocked tiles
    #   when the wave is the frame) before the grid and shadow-tree
    #   branches; the windows' bundles are skipped (windows alone raise
    #   ValueError); NEE's shadow waves ignore it, as in the JAX package


def _whole_gates(opts: RenderOptions) -> bool:
    return opts.height % GH == 0 and opts.width % GW == 0


def _check_supported(scene, opts: RenderOptions, mwin, tree=None,
                     grid=None, shadow=None) -> None:
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
    if isinstance(tree, ShardedTree):
        if opts.intersector == "packet" or opts.precision != "f32":
            raise ValueError(
                "a ShardedTree has the rope walk's route only (the JAX "
                "package has no packet route for it): intersector "
                f"{opts.intersector!r}, precision {opts.precision!r}")
        if grid is not None or shadow is not None:
            raise ValueError("a ShardedTree's ring carries every wave: a "
                             "grid or shadow tree of the whole scene has no "
                             "place beside it")
    if opts.edge_aware and opts.mode == "mirror":
        raise ValueError("edge_aware has a normal and a path form only "
                         "(the JAX package ignores it in mirror mode)")
    if opts.differentiable:
        if mwin is not None and tree is None:
            raise ValueError(
                "differentiable: the windows carry no differentiable wave "
                "(the JAX package's intersect_diff has no windows route); "
                "pass the scene's kd-tree as tree=")
        if opts.precision != "f32":
            raise ValueError(f"precision {opts.precision!r}: the "
                             "differentiable forward computes in f32 only")


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


def _record(rec, inv=None):
    """The hit record's keys of a route's output (the shade attributes
    where the route carries them), put back in wave order by inv."""
    return {k: rec[k] if inv is None else rec[k][inv]
            for k in _REC_KEYS if k in rec}


def _intersect_tris(scene, mwin, orig, dir, opts, coherent, active,
                    jitter_px, tree, grid, shadow):
    n = orig.shape[0]
    if coherent and mwin is not None and _whole_gates(opts):
        return _record(traverse_plist(
            mwin, orig, dir, (opts.height, opts.width), dilate_px=jitter_px,
            supers=opts.plist_schedule != "window",
            gathered=opts.plist_schedule == "gathered",
            kcap=opts.plist_kcap, grid=grid))
    if isinstance(tree, ShardedTree):
        return _record(intersect_ring(tree, orig, dir, active=active,
                                      max_iters=MAX_ITERS))
    packet = (opts.intersector == "packet" and tree is not None
              and tree.tri_block == 4 and n % opts.packet_tile == 0)
    if not coherent:
        if packet and not opts.sort_bounces:
            # unsorted: pixel-blocked tiles when the wave is the frame
            frame = n == opts.width * opts.height
            return _record(traverse_packet(
                tree, orig, dir, (opts.height, opts.width) if frame else None,
                tile=opts.packet_tile, active=active,
                precision=opts.precision))
        if grid is not None and opts.bounce_grid:
            return _record(traverse_grid(grid, orig, dir, active=active,
                                         max_iters=MAX_ITERS))
        if shadow is not None and opts.bounce_walk:
            return _record(_walk(shadow, orig, dir, opts, active))
        if mwin is not None and opts.sort_bounces:
            inv, orig, dir, active = sort_wave(orig, dir, active)
            return _record(traverse_plist_bundle(mwin, orig, dir,
                                                 active=active), inv)
        if mwin is not None and tree is None:
            raise ValueError(
                "sort_bounces=False: the windows carry scattered waves in "
                "sorted bundles only (the JAX package has no unsorted "
                "bundle route); pass the scene's kd-tree as tree=, or a "
                "grid or shadow tree for the bounce waves")
    if tree is None:
        return flat_scan(scene, orig, dir)
    if packet:
        if coherent:
            rec = traverse_packet(tree, orig, dir, (opts.height, opts.width),
                                  tile=opts.packet_tile, shared_origin=True,
                                  grid_dirs=jitter_px == 0.0,
                                  strips=opts.packet_strips,
                                  frustum=opts.packet_frustum,
                                  precision=opts.precision)
            return _record(rec)
        inv, orig, dir, active = sort_wave(orig, dir, active)
        return _record(traverse_packet(tree, orig, dir,
                                       tile=opts.packet_tile, active=active,
                                       precision=opts.precision), inv)
    return _record(_walk(tree, orig, dir, opts, active))


def intersect_scene(scene, mwin, orig, dir, opts: RenderOptions,
                    coherent: bool = True, active=None,
                    jitter_px: float = 0.0, tree=None, grid=None,
                    shadow=None):
    """Nearest hit. Returns hit [N], t [N], tri [N], u/v [N], with spheres
    in the scene sphere [N] (-1 where the nearest hit is not a sphere),
    and on the windows route's kernels, when the windows carry fused
    resolve rows, the shade attributes snormal/salbedo/semission [N, 3].

    coherent: the wave is the frame's shared-origin pixel-grid primaries
    (jittered by up to jitter_px pixels); otherwise it is scattered, and
    active [N] (optional) masks its dead lanes. The route is the module
    docstring's: windows (K1 gates, K1' sorted bundles), the tree (W1, or
    K3 with opts.intersector="packet"), the grid (G1) and the shadow tree
    (W1) for scattered waves, the flat scan (W2) without a structure.
    grid with opts.plist_kcap > 0: the primary gates' two-phase engine
    (traverse_plist). opts.differentiable: diff/grad.py::intersect_diff's
    record, t/u/v differentiable, on its routes (the module docstring)."""
    if scene.num_tris and opts.differentiable:
        rec = intersect_diff(scene, tree, orig, dir, opts, coherent=coherent,
                             active=active, jitter_px=jitter_px, grid=grid)
    elif scene.num_tris:
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
    with span("prepass"):
        perm, inv = sort_rays(orig, dir, alive=active)
        return (inv, orig[perm], dir[perm],
                None if active is None else active[perm])


def _surface(scene, rec, orig, dir, allow_baked: bool = True):
    """Hit point and surface attributes (normal, albedo, emission) of a
    hit record: the shade attributes the fused resolve carried out of the
    winner gather, else resolve_tri_hits on the winner (tri, u, v; the
    baked shade rows with allow_baked, which the differentiable route
    turns off); a sphere hit's from resolve_sphere_hits."""
    point = orig + rec["t"][:, None] * dir
    if "snormal" in rec:
        at = (rec["snormal"], rec["salbedo"], rec["semission"])
    elif scene.num_tris == 0:
        z = torch.zeros_like(point)
        at = (z, z, z)
    else:
        r = resolve_tri_hits(scene, rec["tri"], rec["u"], rec["v"],
                             allow_baked)
        at = (r["normal"], r["albedo"], r["emission"])
    if scene.num_spheres:
        sph = resolve_sphere_hits(scene, rec["sphere"], point)
        is_sph = (rec["sphere"] >= 0)[:, None]
        at = tuple(torch.where(is_sph, sph[k], x) for k, x in
                   zip(("normal", "albedo", "emission"), at))
    return (point, *at)


def _kind(coherent: bool) -> str:
    """A wave span's kind: the frame's primaries or a scattered wave."""
    return "primary" if coherent else "bounce"


def shade_normal(scene, mwin, orig, dir, opts: RenderOptions, tree=None,
                 grid=None, shadow=None, first_rec=None,
                 first_coherent: bool = True, first_active=None):
    """Reference parity: hit -> (normal + 1) / 2, miss -> background.
    first_rec: the rays' record when the caller has traced them (the
    edge-aware pass traces once and shades twice); else they are traced
    as a coherent wave or, first_coherent False, a scattered one with the
    live mask first_active."""
    rec = first_rec
    if rec is None:
        with span("wave", kind=_kind(first_coherent), b=0):
            rec = intersect_scene(scene, mwin, orig, dir, opts,
                                  coherent=first_coherent,
                                  active=first_active, tree=tree, grid=grid,
                                  shadow=shadow)
    with span("shade", b=0):
        _, normal, _, _ = _surface(scene, rec, orig, dir,
                                   not opts.differentiable)
        return torch.where(rec["hit"][:, None], normal_color(normal),
                           opts.background)


def mirror_wave(scene, rec, orig, dir, alive, allow_baked: bool = True):
    """The next wave of a mirror bounce: (hit, orig, dir, normal). Lanes
    that were alive and hit reflect about the shading normal from the hit
    point offset by BOUNCE_EPS along the new direction; the others keep
    their ray. hit is the next wave's live mask."""
    point, normal, _, _ = _surface(scene, rec, orig, dir, allow_baked)
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
    with span("shade", b=0):
        col = torch.zeros((n, 3), device=orig.device)
        strength = torch.ones((n,), device=orig.device)
        alive = torch.ones((n,), dtype=torch.bool, device=orig.device)
    o, d = orig, dir
    for b in range(opts.bounces):
        with span("wave", kind=_kind(b == 0), b=b):
            rec = intersect_scene(scene, mwin, o, d, opts, coherent=(b == 0),
                                  active=None if b == 0 else alive,
                                  tree=tree, grid=grid, shadow=shadow)
        with span("shade", b=b):
            hit, o, d, normal = mirror_wave(scene, rec, o, d, alive,
                                            not opts.differentiable)
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
    with span("shade", b=opts.bounces):
        st = strength[:, None]
        return torch.where(alive[:, None],
                           (1.0 - st) * col + st * opts.background, col)


def light_cdf(scene):
    """The emitters' sampling table, once per scene (it depends on the
    scene only; build it beside the grid and pass it to render_image as
    `lights`): a dict of the triangles' cross products [F, 3] (twice the
    area-weighted normals), areas [F], probabilities [F] (luminance x area
    over the total) and their running sum cdf [F]; `any`, whether any
    light is lit (the JAX package decides it on the device with lax.cond;
    the port skips NEE's whole shadow wave on the host), and `sorted`,
    whether no probability is negative (an emission below 0) or NaN, so
    that the cdf is sorted: host bools, one read. Differentiable frames
    build it from the live scene on every call (render_image refuses a
    given table), so that the light's pdf and normal carry gradients, as
    the JAX package's _sample_light computes them inside the
    differentiated function."""
    v0, v1, v2 = scene.tri_verts()
    cross = vm.cross(v1 - v0, v2 - v0)
    area = 0.5 * vm.length(cross)
    w = scene.emission.amax(dim=-1) * area
    total = w.sum()
    probs = w / torch.clamp(total, min=1e-30)
    lit, ordered = torch.stack([total > 0.0, (probs >= 0.0).all()]).tolist()
    return {"cross": cross, "area": area, "probs": probs,
            "cdf": torch.cumsum(probs, dim=0), "any": lit, "sorted": ordered}


def _float_keys(x):
    """int32 keys of f32 values in IEEE total order (-inf < ... < +inf <
    NaN), -0 made +0 and every NaN the positive quiet NaN: the order of
    jax.lax's sort comparators (lax.py::_canonicalize_float_for_sort)."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def searchsorted_scan(a, v):
    """jnp.searchsorted(a, v) (side "left", its "scan" method) on any 1-D
    f32 a, sorted or not: ceil(log2(len(a) + 1)) halvings of [0, len(a)),
    each going left where v <= a[mid] in the total order of _float_keys.
    On a sorted a it is torch.searchsorted's result; on an unsorted one
    (a light cdf over a negative emission) torch.searchsorted's is its
    own."""
    ka, kv = _float_keys(a), _float_keys(v)
    n = a.shape[0]
    low = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    high = torch.full_like(low, n)
    for _ in range(math.ceil(math.log2(n + 1))):
        mid = (low + high) // 2
        left = kv <= ka[mid]
        low, high = torch.where(left, low, mid), torch.where(left, mid, high)
    return high


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
    u = (light_u[:, 0] * cdf[-1]).contiguous()
    f = (torch.searchsorted(cdf, u) if lights["sorted"]
         else searchsorted_scan(cdf, u))
    f = f.clamp(0, cdf.shape[0] - 1)
    su = torch.sqrt(light_u[:, 1])
    bu = 1.0 - su
    bv = light_u[:, 2] * su
    c = vm.take_rows(scene.verts, vm.take_rows(scene.faces, f)[:, :, 0])
    p = (bu[:, None] * c[:, 0] + bv[:, None] * c[:, 1]
         + (1.0 - bu - bv)[:, None] * c[:, 2])
    nrm = vm.normalize(vm.take_rows(lights["cross"], f), eps=1e-30)
    pdf_area = vm.take_rows(lights["probs"], f) / torch.clamp(
        vm.take_rows(lights["area"], f), min=1e-30)
    out = (p, nrm, vm.take_rows(scene.emission, f), pdf_area)
    if stride > 1:
        out = tuple(x.repeat_interleave(stride, dim=0)[:n] for x in out)
    return out


def _occluded(scene, orig, dir, dist, opts: RenderOptions, active=None, *,
              mwin=None, tree=None, grid=None, shadow=None):
    """Shadow query: is anything closer than dist - SHADOW_EPS along dir?
    (JAX render/integrator.py:466-557.) With a ShardedTree, its ring's
    nearest hit below the bound; with a grid, its any-hit DDA (G1)
    with that bound and the active mask; else with the shadow tree, or a
    tri_block 4 tree, the rope walk's any-hit form (W1) with that t_max;
    else a scattered wave through intersect_scene
    (K1' bundles on windows alone, the traverse form on another tree, the
    flat scan W2 with no structure) and its t below the bound. Spheres are
    ORed in on the walks' routes (intersect_scene carries them on the
    last). The sorted-bundle route behind CLPT_SHADOW_BUNDLE is a measured
    negative and is not ported. opts.sort_bounces does not apply to the
    shadow wave (the JAX package reads it here only behind that switch),
    so the windows' bundles stay sorted."""
    t_max = dist - SHADOW_EPS
    if isinstance(tree, ShardedTree):
        rec = intersect_ring(tree, orig, dir, active=active,
                             max_iters=MAX_ITERS)
        occ = rec["hit"] & (rec["t"] < t_max)
    elif grid is not None:
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
        rec = intersect_scene(scene, mwin, orig, dir,
                              dataclasses.replace(opts, sort_bounces=True),
                              coherent=False, active=active, tree=tree)
        return rec["hit"] & (rec["t"] < t_max)
    if scene.num_spheres:
        occ = occ | (nearest_sphere(scene, orig, dir)[0] < t_max)
    return occ


def shade_path(scene, mwin, orig, dir, opts: RenderOptions, bounce_u,
               jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
               lights=None, shadow=None, first_rec=None,
               first_coherent: bool = True, first_active=None):
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
    is not traced.

    first_rec, first_coherent, first_active: the first wave as
    shade_normal takes it; first_active also starts the live mask."""
    n = orig.shape[0]
    dev = orig.device
    with span("shade", b=0):
        radiance = torch.zeros((n, 3), device=dev)
        throughput = torch.ones((n, 3), device=dev)
        alive = (torch.ones((n,), dtype=torch.bool, device=dev)
                 if first_active is None else first_active)
    if opts.nee and lights is None:
        with span("light"):
            lights = light_cdf(scene)
    o, d = orig, dir
    for b in range(opts.bounces):
        if b == 0 and first_rec is not None:
            rec = first_rec
        else:
            coherent = b == 0 and first_coherent
            with span("wave", kind=_kind(coherent), b=b):
                rec = intersect_scene(
                    scene, mwin, o, d, opts, coherent=coherent,
                    active=first_active if b == 0 else alive,
                    jitter_px=jitter_px if b == 0 else 0.0, tree=tree,
                    grid=grid, shadow=shadow)
        with span("shade", b=b):
            point, normal, albedo, emission = _surface(
                scene, rec, o, d, not opts.differentiable)
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
            with span("light", b=b):
                radiance = radiance + _direct_light(
                    scene, point, normal, albedo, throughput, hit,
                    light_u[b], opts, lights, b, mwin=mwin, tree=tree,
                    grid=grid, shadow=shadow)
        with span("shade", b=b):
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
                  opts, lights, b: int, **structures):
    """NEE's contribution at one vertex (JAX render/integrator.py:656-691):
    throughput * albedo / pi * emission * cos_s * cos_l / dist^2 / pdf
    where the hit sees the sampled light point unoccluded (nee_wave,
    _occluded, traced on detached rays with no graph). b: the bounce, the
    shadow wave span's."""
    w = nee_wave(scene, point, normal, hit, light_u, opts.nee_light_stride,
                 lights)
    with torch.no_grad(), span("wave", kind="shadow", b=b):
        # visibility is discrete: no gradient
        occ = _occluded(scene, w["orig"].detach(), w["dir"].detach(),
                        w["dist"].detach(), opts, active=w["live"],
                        **structures)
    g = w["cos_s"] * w["cos_l"] / w["dist2"]
    contrib = (throughput * (albedo / math.pi) * w["emission"]
               * (g / torch.clamp(w["pdf"], min=1e-30))[:, None])
    return torch.where((w["live"] & ~occ)[:, None], contrib, 0.0)


def _clip01(x):
    """clip(x, 0, 1) as jnp.clip computes it, maximum then minimum: at a
    bound each side takes half the gradient."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _edge_band(m, rows: int, cols: int):
    """Per-pixel blend band of the [rows * cols] min-barycentrics m: the
    largest absolute difference to the 4 neighbours (wrapping at the
    image's borders), at least 1e-4 (JAX render/integrator.py:707-718).
    Not detached: the band moves with the scene, and a finite-difference
    probe of the smoothed render sees that motion."""
    mi = m.reshape(rows, cols)
    d = [(mi - torch.roll(mi, s, dims=a)).abs() for a in (0, 1)
         for s in (1, -1)]
    g = torch.maximum(torch.maximum(d[0], d[1]), torch.maximum(d[2], d[3]))
    return torch.maximum(g, g.new_full((), 1e-4)).reshape(-1)


def shade_edgeaware(scene, mwin, orig, dir, opts: RenderOptions,
                    bounce_u=None, jitter_px: float = 0.0, tree=None,
                    grid=None, light_u=None, lights=None, shadow=None):
    """Silhouette-reparameterized shading, normal and path modes (JAX
    render/integrator.py:721-772). The winner's min-barycentric m is a
    differentiable distance to its triangle's boundary; a hit pixel
    blends its shading c1 toward the continuation ray's c2 (the surface
    the boundary occludes, or the background) with alpha = clip(m / band,
    0, 1), the band _edge_band's. The continuation starts past the hit at
    the detached t plus t * 1e-3 + BOUNCE_EPS and is a scattered wave of
    the hit lanes. Path mode shades both with the same draws (bounce_u,
    light_u: common random numbers, as the JAX package passes one key).
    The wave is whole image rows (N a multiple of opts.width); the band
    wraps at the image's borders."""
    n = orig.shape[0]
    if n % opts.width:
        raise ValueError(f"edge_aware: a wave of {n} rays is not whole rows "
                         f"of {opts.width} pixels")
    kw = dict(tree=tree, grid=grid, shadow=shadow)
    with span("wave", kind="primary", b=0):
        rec1 = intersect_scene(scene, mwin, orig, dir, opts,
                               jitter_px=jitter_px, **kw)
    with span("shade", b=0):
        u, v = rec1["u"], rec1["v"]
        m = torch.where(rec1["tri"] >= 0,
                        torch.minimum(torch.minimum(u, v), 1.0 - u - v), 1.0)
        alpha = _clip01(m / _edge_band(m, n // opts.width, opts.width))
        t_det = rec1["t"].detach()
        step = torch.where(rec1["hit"], t_det * 1e-3 + BOUNCE_EPS, 0.0)
        o2 = orig + (t_det + step)[:, None] * dir
    if opts.mode == "path":
        c1 = shade_path(scene, mwin, orig, dir, opts, bounce_u, jitter_px,
                        light_u=light_u, lights=lights, first_rec=rec1, **kw)
        c2 = shade_path(scene, mwin, o2, dir, opts, bounce_u,
                        light_u=light_u, lights=lights, first_coherent=False,
                        first_active=rec1["hit"], **kw)
    else:
        c1 = shade_normal(scene, mwin, orig, dir, opts, first_rec=rec1, **kw)
        c2 = shade_normal(scene, mwin, o2, dir, opts, first_coherent=False,
                          first_active=rec1["hit"], **kw)
    with span("shade", b=0):
        a = alpha[:, None]
        return torch.where(rec1["hit"][:, None], a * c1 + (1.0 - a) * c2, c1)


def render_rays(scene, mwin, orig, dir, opts: RenderOptions, bounce_u=None,
                jitter_px: float = 0.0, tree=None, grid=None, light_u=None,
                lights=None, shadow=None):
    """Shade a wave of the frame's primary rays. bounce_u: path mode's
    [bounces, N, 2] uniforms; light_u: with NEE, its [bounces,
    ceil(N / stride), 3] light uniforms; lights: light_cdf(scene), computed
    when not given; jitter_px: the primaries' jitter bound; tree, grid,
    shadow: as render_image's. opts.edge_aware: shade_edgeaware."""
    _check_supported(scene, opts, mwin, tree, grid, shadow)
    kw = dict(tree=tree, grid=grid, shadow=shadow)
    if opts.mode == "path" and (bounce_u is None
                                or (opts.nee and light_u is None)):
        raise ValueError("path mode needs its bounce uniforms (bounce_u) "
                         "and, with NEE, its light uniforms (light_u)")
    if opts.edge_aware:
        return shade_edgeaware(scene, mwin, orig, dir, opts, bounce_u,
                               jitter_px, light_u=light_u, lights=lights,
                               **kw)
    if opts.mode == "normal":
        return shade_normal(scene, mwin, orig, dir, opts, **kw)
    if opts.mode == "mirror":
        return shade_mirror(scene, mwin, orig, dir, opts, **kw)
    return shade_path(scene, mwin, orig, dir, opts, bounce_u,
                      jitter_px=jitter_px, light_u=light_u, lights=lights,
                      **kw)


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
    """Render an [H, W, 3] image. Each structure is optional (none: the flat
    scan, W2). mwin: the scene's MortonWindows with shared-origin tables
    and, optionally, fused resolve rows attached (ops/plist.py::
    build_morton_windows, attach_so, attach_resolve); tree: its kd-tree
    (accel/sah.py::build_kd_tree; for intersector="packet" with SO tables,
    attach_so_tables, or without them the per-frame so_rows), the route of
    frames that are not whole gates and, without windows, of every wave;
    or a parallel/treelet.py::ShardedTree, whose ring (intersect_ring, W1
    on each block) then carries every wave the windows do not, shadow rays
    included; grid: a uniform grid of the same triangles
    (accel/grid.py::build_grid), the counterpart of the JAX package's
    accel/sah.py::attach_grid, for NEE, the bounce waves
    (opts.bounce_grid) and the two-phase primaries (opts.plist_kcap);
    shadow: the walk-tuned tree (accel/sah.py::build_shadow_tree), the
    counterpart of attach_shadow_tree, for NEE without a grid and the
    bounce waves (opts.bounce_walk); lights: NEE's light_cdf(scene), built
    once per scene (computed each call when not given; a differentiable
    frame always builds it from the live scene and refuses a given one).

    Path mode draws its random numbers from `generator` (default: a
    generator on the camera's device seeded 0), or takes them as given:
    jitter [spp, H*W, 2] (spp > 1 only), bounce [S, bounces, H*W, 2] and,
    with NEE, light [S, bounces, ceil(H*W / nee_light_stride), 3]
    (path_draws). spp > 1 averages that many jittered samples; other modes
    render one pixel-grid sample whatever spp is.

    opts.differentiable: backward() of the image reaches the camera's
    tensors, scene.verts, normals, albedo and emission (intersect_diff);
    opts.edge_aware adds the silhouette term (shade_edgeaware)."""
    return render_rows(scene, camera, opts, 0, opts.height, mwin, tree=tree,
                       grid=grid, shadow=shadow, lights=lights,
                       generator=generator, jitter=jitter, bounce=bounce,
                       light=light)


def render_rows(scene, camera, opts: RenderOptions, row0: int, rows: int,
                mwin=None, *, tree=None, grid=None, shadow=None, lights=None,
                generator: torch.Generator = None, jitter=None, bounce=None,
                light=None, rays=None):
    """Rows [row0, row0 + rows) of render_image's frame, [rows, W, 3]: the
    full frame's rays (generate_rays of the H x W frame, or its jittered
    samples) cut to those rows and shaded by render_rays under height
    `rows`, the block of a row-sharded frame (parallel/mesh.py,
    parallel/elastic.py). Structures and draws as render_image's, the
    draws the block's own: path_draws of the options at height `rows`
    (bounce [S, bounces, rows*W, 2], ...). The windows route takes the
    block's whole gates (a row0 and rows that are multiples of GH give
    exactly the full frame's gates); on a block of other rows it raises
    without a tree, as render_image does at that height. Normal and
    mirror blocks are bit-equal to the same rows of render_image's frame;
    edge_aware's band wraps at the block's borders. rays: the full frame's
    pixel-grid rays (generate_rays(cam_matrix(camera, H), W, H)) when the
    caller already has them; jittered samples are generated here."""
    if rows < 1 or row0 < 0 or row0 + rows > opts.height:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a frame of "
                         f"{opts.height}")
    return render_lanes(
        scene, camera, opts, row0 * opts.width, rows * opts.width, mwin,
        tree=tree, grid=grid, shadow=shadow, lights=lights,
        generator=generator, jitter=jitter, bounce=bounce, light=light,
        rays=rays).reshape(rows, opts.width, 3)


def render_lanes(scene, camera, opts: RenderOptions, lane0: int, n: int,
                 mwin=None, *, tree=None, grid=None, shadow=None,
                 lights=None, generator: torch.Generator = None, jitter=None,
                 bounce=None, light=None, rays=None):
    """Pixels [lane0, lane0 + n) of render_image's frame in row-major order,
    [n, 3]: the full frame's rays cut to that range and shaded by
    render_rays as a frame of its own. A range of whole rows is the frame
    of those rows (render_rows); any other range is a frame of one row of
    n pixels, as the JAX package shades a flat shard of a frame's rays
    (its P(("rows", "scene")) split, parallel/treelet.py): no windows
    (they need whole gates; with a tree the rope walk takes it),
    edge_aware's band over that one row (the JAX shade_edgeaware's `cols
    = n`), the draws of n pixels. Structures, draws and rays as
    render_rows'."""
    with span("frame"):
        width, height = opts.width, opts.height
        if n < 1 or lane0 < 0 or lane0 + n > width * height:
            raise ValueError(f"pixels [{lane0}, {lane0 + n}) of a frame of "
                             f"{width * height}")
        if lane0 % width == 0 and n % width == 0:
            block = dataclasses.replace(opts, height=n // width)
        else:
            block = dataclasses.replace(opts, height=1, width=n)
        _check_supported(scene, block, mwin, tree, grid, shadow)
        if opts.differentiable and lights is not None:
            raise ValueError("differentiable: lights= is a table of the "
                             "scene as it was built; the frame builds it "
                             "from the live scene: pass lights=None")
        device = camera.position.device
        lanes = slice(lane0, lane0 + n)
        kw = dict(tree=tree, grid=grid, shadow=shadow)
        with span("rays"):
            cam_inv = cam_matrix(camera, height)
            if rays is None and (opts.mode != "path" or opts.spp <= 1):
                rays = generate_rays(cam_inv, width, height)
        if opts.mode != "path":
            orig, dir = rays
            return render_rays(scene, mwin, orig[lanes], dir[lanes], block,
                               **kw)
        if bounce is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            with span("rays"):
                jitter, bounce, light = path_draws(block, generator, device)
        s = opts.spp if opts.spp > 1 else 1
        m = -(-n // opts.nee_light_stride)
        if tuple(bounce.shape) != (s, opts.bounces, n, 2) or (
                s > 1 and (jitter is None
                           or tuple(jitter.shape) != (s, n, 2))
        ) or (opts.nee and (light is None or tuple(light.shape)
                            != (s, opts.bounces, m, 3))):
            raise ValueError(
                f"path draws: bounce {tuple(bounce.shape)}, jitter "
                f"{None if jitter is None else tuple(jitter.shape)}, light "
                f"{None if light is None else tuple(light.shape)}; want "
                f"{(s, opts.bounces, n, 2)}, for spp > 1 {(s, n, 2)} and "
                f"with NEE {(s, opts.bounces, m, 3)}")
        if opts.nee and lights is None:
            with span("light"):
                lights = light_cdf(scene)
        samples = []
        for i in range(s):
            if s == 1:
                o, d = rays
            else:
                with span("rays"):
                    jit = jitter[i:i + 1]
                    if n < width * height:   # the block's jitter in the frame
                        jit = jit.new_zeros((1, width * height, 2))
                        jit[0, lanes] = jitter[i]
                    o, d = generate_rays_jittered(cam_inv, width, height,
                                                  jit)
                    o, d = o[0], d[0]
            samples.append(render_rays(
                scene, mwin, o[lanes], d[lanes], block, bounce[i],
                jitter_px=JITTER_PX if s > 1 else 0.0,
                light_u=None if light is None else light[i], lights=lights,
                **kw))
        if s == 1:
            return samples[0]
        with span("shade"):   # the samples' mean
            return torch.stack(samples).mean(dim=0)
