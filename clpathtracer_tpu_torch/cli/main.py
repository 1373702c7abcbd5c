"""Command-line entry: render / orbit / fly / view / info (the port's
counterpart of clpathtracer_tpu/cli/main.py).

    python -m clpathtracer_tpu_torch.cli.main render model.obj --out x.png

The reference's CLI is `./CLPathTracer model.obj ...`, which opens an
interactive GLFW window (src/main.c:9-20). An offline renderer maps the
same capabilities to subcommands, with the JAX package's parser, flags and
structures:

  render  one frame -> PNG                (the frame loop body, once)
  orbit   camera orbit -> frame sequence  (animation without input devices)
  fly     scripted fly-through using the physics stepper + fly camera
          (the game loop, src/game.c:219-244, driven by a JSON script
          instead of GLFW callbacks)
  view    the interactive viewer (cli/viewer.py; needs matplotlib)
  info    scene + kd-tree quality stats  (the reference's printfs,
          src/kd_tree.c:232-235, as structured output)

Frames run on the first CUDA device; --cpu runs them on the host with
the kernels' plain versions. Without --cpu and without CUDA the command
exits with an error that names CUDA: it never carries on on the host on
its own. --sharded renders through parallel/mesh.py::
make_sharded_renderer over the process group (init_distributed: a world
of 1 on its own, or one rank a card under `torchrun --nproc-per-node N`,
each on the card LOCAL_RANK; gloo with --cpu); only rank 0 writes files.
main() returns the subcommand's Session (the loaded scene, its
structures and the outputs) to a Python caller.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from clpathtracer_tpu_torch.accel.grid import build_grid, fog_likeness
from clpathtracer_tpu_torch.accel.sah import build_shadow_tree
from clpathtracer_tpu_torch.cli.viewer import run_viewer
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.core.physics import FlyCamera
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.parallel.mesh import (axis_size, default_mesh,
                                                  make_sharded_renderer)
from clpathtracer_tpu_torch.parallel.multihost import init_distributed
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      light_cdf, render_image)
from clpathtracer_tpu_torch.scene.cache import load_models
from clpathtracer_tpu_torch.utils.device import pick_device
from clpathtracer_tpu_torch.utils.png import tonemap, write_png
from clpathtracer_tpu_torch.utils.profiling import StageTimer


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clpathtracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp, camera=True):
        sp.add_argument("models", nargs="+",
                        help=".obj, .kd or .npz (a .torch.kd.npz cache, or "
                             "the JAX package's .kd.npz) model paths")
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--mode", choices=("normal", "mirror", "path"),
                        default="normal")
        sp.add_argument("--bounces", type=int, default=2)
        sp.add_argument("--spp", type=int, default=1)
        sp.add_argument("--background", type=float, default=1.0)
        sp.add_argument("--nee", action="store_true",
                        help="path mode: next-event estimation (direct"
                             " light sampling)")
        sp.add_argument("--intersector",
                        choices=("auto", "wavefront", "packet"),
                        default="auto",
                        help="packet = the windows' list kernel for whole-"
                             "gate frames, the kd packet kernel otherwise; "
                             "wavefront = the per-ray rope walk; auto = "
                             "packet on CUDA, wavefront with --cpu")
        sp.add_argument("--packet-tile", type=int, default=1024,
                        help="rays per packet (256 for huge scenes)")
        sp.add_argument("--no-tree", action="store_true",
                        help="brute-force linear-scan intersector")
        sp.add_argument("--tri-block", type=int, default=4)
        sp.add_argument("--max-depth", type=int, default=24)
        sp.add_argument("--leaf-size", type=int, default=4)
        sp.add_argument("--no-cache", action="store_true",
                        help="skip the .torch.kd.npz acceleration cache")
        sp.add_argument("--sphere", type=float, nargs=4, action="append",
                        default=[], metavar=("X", "Y", "Z", "R"),
                        help="add an analytic sphere primitive (repeatable;"
                             " the reference's sphere pipeline was dead"
                             " code; here it renders)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--sharded", action="store_true",
                        help="split the frame's rows over the process "
                             "group's ranks (a world of 1 without "
                             "torchrun's variables; one card a rank); "
                             "rank 0 writes the files")
        sp.add_argument("--cpu", action="store_true",
                        help="run on the host CPU (the kernels' plain "
                             "versions)")
        sp.add_argument("--exposure", type=float, default=1.0)
        sp.add_argument("--gamma", type=float, default=None,
                        help="default: 2.2 for path mode, 1.0 otherwise")
        if camera:
            sp.add_argument("--position", type=float, nargs=3,
                            default=[0.0, 0.1, -0.2],
                            help="eye position (reference default, "
                                 "src/game.c:275-277)")
            sp.add_argument("--forward", type=float, nargs=3,
                            default=[0.0, 0.0, 1.0])
            sp.add_argument("--fov", type=float, default=60.0,
                            help="vertical FOV in degrees")
        return sp

    r = add_common(sub.add_parser("render", help="render one frame"))
    r.add_argument("--out", default="out.png")

    o = add_common(sub.add_parser("orbit", help="orbit animation"))
    o.add_argument("--out-dir", default="frames")
    o.add_argument("--frames", type=int, default=24)
    o.add_argument("--radius", type=float, default=None,
                   help="orbit radius (default: 1.5x scene extent)")
    o.add_argument("--elevation", type=float, default=15.0,
                   help="camera elevation in degrees")

    f = add_common(sub.add_parser(
        "fly", help="scripted fly-through (physics-stepped camera)"))
    f.add_argument("--script", required=True,
                   help="JSON: [{duration, move:[r,u,f], look:[dx,dy], "
                        "sprint, walk, zoom}, ...]")
    f.add_argument("--fps", type=float, default=12.0)
    f.add_argument("--out-dir", default="frames")

    v = add_common(sub.add_parser(
        "view", help="interactive viewer (matplotlib window, WASD+arrows)"))
    v.add_argument("--fps-cap", type=float, default=30.0)

    i = sub.add_parser("info", help="scene + tree stats")
    i.add_argument("models", nargs="+")
    i.add_argument("--tri-block", type=int, default=4)
    i.add_argument("--max-depth", type=int, default=24)
    i.add_argument("--leaf-size", type=int, default=4)
    i.add_argument("--no-cache", action="store_true")
    i.add_argument("--cpu", action="store_true",
                   help="load onto the host CPU")
    i.add_argument("--json", action="store_true", dest="as_json")
    return p


@dataclasses.dataclass
class Session:
    """What a subcommand loaded and made. structures: the render_image
    keyword arguments (mwin, tree, grid, shadow, lights; absent ones are
    None); times: the StageTimer's stages in seconds; outputs: the files
    written, in order; image: the last frame (before tone mapping)."""

    device: torch.device
    scene: object
    structures: dict
    opts: object = None
    intersector: str = None
    win_rows: int = None
    times: dict = dataclasses.field(default_factory=dict)
    outputs: list = dataclasses.field(default_factory=list)
    image: torch.Tensor = None
    stats: dict = None
    renderer: object = None   # --sharded: make_sharded_renderer's render


def _resolved_intersector(args, device) -> str:
    """'auto' is the packet route on CUDA (the windows' list kernel K1 on
    whole-gate frames, the kd packet kernel K3 otherwise) and the per-ray
    rope walk W1 on the host, as the JAX package picks its packet engine
    on the accelerator and its XLA walk elsewhere."""
    if args.intersector != "auto":
        return args.intersector
    return "packet" if device.type == "cuda" else "wavefront"


def _load(args, device, timer):
    """Load the models and build the structures the JAX package's _load
    builds, as render_image's explicit arguments:

    * the intersector resolves to packet on a tri_block 4 tree and the
      frame is whole gates: Morton windows (win_rows 8 on fog-like
      scenes, else 16) with SO tables and fused resolve rows (mwin);
    * path mode: a uniform grid on fog-like scenes, else the walk-tuned
      shadow tree (leaf 16, depth 26);
    * with NEE the light table, once per scene.

    --no-tree passes no structure: every wave takes the flat scan (W2).
    Returns a Session."""
    t0 = time.time()
    scene, tree, skipped = load_models(
        args.models, tri_block=args.tri_block, max_depth=args.max_depth,
        leaf_size=args.leaf_size, use_cache=not args.no_cache,
        device=device, timer=timer)
    if args.sphere:
        sp = np.asarray(args.sphere, np.float32)
        ns = len(sp)
        scene = scene.replace(
            sphere_pos=torch.as_tensor(sp[:, :3], device=device),
            sphere_radius=torch.as_tensor(sp[:, 3], device=device),
            sphere_albedo=torch.full((ns, 3), 0.75, device=device),
            sphere_emission=torch.zeros((ns, 3), device=device))
    intersector = _resolved_intersector(args, device)
    s = Session(device=device, scene=scene, intersector=intersector,
                structures=dict(mwin=None, tree=None, grid=None,
                                shadow=None, lights=None))
    if not args.no_tree and scene.num_tris > 0:
        s.structures["tree"] = tree
        tv = scene.tri_corners()
        fog = fog_likeness(tv) > 0.5
        if (intersector == "packet" and tree.tri_block == 4
                and args.width % plist.GW == 0
                and args.height % plist.GH == 0):
            ts = time.time()
            s.win_rows = 8 if fog else 16
            if scene.shade_rows is None:   # a merged scene: bake its rows
                scene = s.scene = scene.bake_shading()
            with timer.stage("windows", device):
                mwin = plist.build_morton_windows(tv, win_rows=s.win_rows,
                                                  device=device)
                mwin = plist.attach_resolve(plist.attach_so(mwin),
                                            scene.shade_rows)
            s.structures["mwin"] = mwin
            print(f"# morton windows: {time.time()-ts:.2f}s "
                  f"({mwin.num_windows} windows)", file=sys.stderr)
        if args.mode == "path":
            if fog:
                with timer.stage("grid", device):
                    s.structures["grid"] = build_grid(tv, device=device)
            else:
                with timer.stage("shadow tree", device):
                    s.structures["shadow"] = build_shadow_tree(
                        tv, device=device)
    if args.mode == "path" and args.nee:
        with timer.stage("light table", device):
            s.structures["lights"] = light_cdf(scene)
    # the reference prints parse/build wall time (src/model.c:136-143)
    print(f"# loaded {scene.num_tris} tris, {scene.num_spheres} spheres "
          f"in {time.time()-t0:.2f}s ({len(skipped)} skipped)",
          file=sys.stderr)
    return s


def _opts(args, intersector):
    return RenderOptions(
        width=args.width, height=args.height, mode=args.mode,
        bounces=args.bounces, spp=args.spp, background=args.background,
        nee=args.nee, intersector=intersector, packet_tile=args.packet_tile)


def _render(session, camera, generator):
    if session.renderer is not None:
        return session.renderer(session.scene, camera, generator=generator,
                                **session.structures)
    return render_image(session.scene, camera, session.opts,
                        generator=generator, **session.structures)


def _sharded_renderer(args, opts, device):
    """The row-sharded renderer over the process group (formed here when
    none is: a world of 1, or torchrun's), on a ("rows", "scene") mesh of
    scene axis 1. Exits when the height does not split over the rows."""
    init_distributed(device=device)
    mesh = default_mesh(device_type=device.type)
    n_rows = axis_size(mesh, "rows")
    if opts.height % n_rows:
        raise SystemExit(
            f"--height must be divisible by {n_rows} with --sharded")
    return make_sharded_renderer(opts, mesh)


def _postprocess(img, args):
    gamma = args.gamma
    if gamma is None:
        gamma = 2.2 if args.mode == "path" else 1.0
    return tonemap(img.cpu().numpy(), exposure=args.exposure, gamma=gamma)


def _camera_from_args(args, device):
    return Camera.create(args.position, args.forward, device=device,
                         fov=float(np.deg2rad(args.fov)))


def _start(args, device):
    """StageTimer, loaded Session with its options, and the path mode's
    generator (one torch.Generator on the render device seeded with
    --seed, drawn from frame after frame). --sharded: the Session's
    renderer is make_sharded_renderer's (the view subcommand renders on
    one device, as the JAX package's does)."""
    timer = StageTimer()
    s = _load(args, device, timer)
    s.opts = _opts(args, s.intersector)
    if args.sharded and args.cmd != "view":
        s.renderer = _sharded_renderer(args, s.opts, device)
    s.times = timer.times
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return s, timer, gen


def _write_frame(s, timer, img, args, out):
    s.image = img
    if s.renderer is not None and dist.get_rank() != 0:
        return
    with timer.stage("png"):
        write_png(out, _postprocess(img, args))
    s.outputs.append(out)
    print(out)


def cmd_render(args, device):
    s, timer, gen = _start(args, device)
    cam = _camera_from_args(args, s.device)
    t0 = time.time()
    with timer.stage("frame", s.device):
        img = _render(s, cam, gen)
    dt = time.time() - t0
    rays = args.width * args.height
    print(f"# rendered {args.width}x{args.height} in {dt:.2f}s "
          f"({rays/dt:.3g} primary rays/s incl. compile)", file=sys.stderr)
    _write_frame(s, timer, img, args, args.out)
    return s


def cmd_orbit(args, device):
    s, timer, gen = _start(args, device)
    lo, hi = (x.cpu().numpy() for x in s.scene.bounds())
    center = (lo + hi) / 2
    radius = args.radius or 1.5 * float(np.max(hi - lo))
    elev = np.deg2rad(args.elevation)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(args.frames):
        theta = 2 * np.pi * i / args.frames
        pos = center + radius * np.array([
            np.sin(theta) * np.cos(elev), np.sin(elev),
            -np.cos(theta) * np.cos(elev)])
        cam = Camera.create(pos, center - pos, device=s.device,
                            fov=float(np.deg2rad(args.fov)))
        with timer.stage("frame", s.device):
            img = _render(s, cam, gen)
        _write_frame(s, timer, img, args,
                     os.path.join(args.out_dir, f"frame_{i:04d}.png"))
    return s


def cmd_fly(args, device):
    with open(args.script) as f:
        script = json.load(f)
    s, timer, gen = _start(args, device)
    fc = FlyCamera(position=np.asarray(args.position, np.float64),
                   fov=float(np.deg2rad(args.fov)))
    os.makedirs(args.out_dir, exist_ok=True)
    dt = 1.0 / args.fps
    frame = 0
    for seg in script:
        fc.move = np.asarray(seg.get("move", [0, 0, 0]), np.float64)
        fc.sprint = bool(seg.get("sprint", False))
        fc.walk = bool(seg.get("walk", False))
        look = seg.get("look", [0.0, 0.0])
        zoom = float(seg.get("zoom", 0.0))
        n = max(1, int(round(float(seg["duration"]) * args.fps)))
        for _ in range(n):
            fc.look(look[0] * dt, look[1] * dt)
            if zoom:
                fc.zoom(zoom * dt)
            fc.step(dt)
            with timer.stage("frame", s.device):
                img = _render(s, fc.camera(device=s.device), gen)
            _write_frame(s, timer, img, args, os.path.join(
                args.out_dir, f"frame_{frame:04d}.png"))
            frame += 1
    return s


def cmd_view(args, device):
    s, _, gen = _start(args, device)
    run_viewer(s.scene, s.opts, position=tuple(args.position),
               fps_cap=args.fps_cap, generator=gen, **s.structures)
    return s


def cmd_info(args, device):
    scene, tree, skipped = load_models(
        args.models, tri_block=args.tri_block, max_depth=args.max_depth,
        leaf_size=args.leaf_size, use_cache=not args.no_cache,
        device=device)
    lo, hi = (x.cpu().numpy().tolist() for x in scene.bounds())
    stats = {
        "num_tris": scene.num_tris,
        "num_verts": int(scene.verts.shape[0]),
        "num_spheres": scene.num_spheres,
        "bounds_lo": lo,
        "bounds_hi": hi,
        "skipped": skipped,
        **{f"tree_{k}": v for k, v in tree.stats().items()},
    }
    if args.as_json:
        print(json.dumps(stats))
    else:
        for k, v in stats.items():
            print(f"{k}: {v}")
    return Session(device=device, scene=scene, stats=stats,
                   structures=dict(tree=tree))


def main(argv=None):
    args = _build_parser().parse_args(argv)
    sharded = getattr(args, "sharded", False) and args.cmd != "view"
    index = int(os.environ.get("LOCAL_RANK", 0)) if sharded else 0
    try:
        device = pick_device("cpu" if args.cpu else "gpu", 0 if args.cpu
                             else index)
    except RuntimeError as e:   # no CUDA device: exit, naming it
        raise SystemExit(f"error: {e}") from e
    formed = sharded and not dist.is_initialized()
    try:
        return {"render": cmd_render, "orbit": cmd_orbit, "fly": cmd_fly,
                "view": cmd_view, "info": cmd_info}[args.cmd](args, device)
    finally:   # a group this command formed ends with it
        if formed and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
