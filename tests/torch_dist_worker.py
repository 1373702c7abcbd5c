"""The ranks of the port's distributed tests: a world of gloo processes on
the host, spawned once a test file (torch.multiprocessing, the spawn
context), each running one file's checks and saving its arrays for the
parent test process. Imports torch and the port only, never jax (not a
test file)."""

import dataclasses
import os
import time
import traceback

import numpy as np
import torch

WORLD = 4
TIMEOUT_S = 120.0
CUBE_OBJ = """v -0.5 -0.5 1.5
v 0.5 -0.5 1.5
v 0.5 0.5 1.5
v -0.5 0.5 1.5
v -0.5 -0.5 2.5
v 0.5 -0.5 2.5
v 0.5 0.5 2.5
v -0.5 0.5 2.5
f 1 4 3
f 1 3 2
f 5 6 7
f 5 7 8
f 4 8 7
f 4 7 3
f 1 2 6
f 1 6 5
f 2 3 7
f 2 7 6
f 1 5 8
f 1 8 4
"""


def run_world(tmp_path, checks: str, world: int = WORLD,
              timeout: float = TIMEOUT_S) -> list:
    """Spawn `world` ranks that each run CHECKS[checks](rank, tmp_path)
    and return their saved dicts of arrays, in rank order. Raises
    AssertionError with the ranks' tracebacks when one fails, and kills
    the world when it outlives `timeout` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp_path), checks))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = "".join(open(f).read() for f in sorted(
        str(tmp_path / n) for n in os.listdir(tmp_path)
        if n.endswith(".err")))
    if hung or any(p.exitcode for p in procs) or errs:
        raise AssertionError(
            f"world of {world}: ranks {hung} hung past {timeout} s, exit "
            f"codes {[p.exitcode for p in procs]}\n{errs}")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _rank_main(rank, world, tmp, checks):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from clpathtracer_tpu_torch.parallel.multihost import init_distributed
    try:
        init_distributed(f"file://{tmp}/store", world, rank, 60,
                         device="cpu")
        out = CHECKS[checks](rank, tmp)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **{
            k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()})
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def soup_rays(w=32, h=32, pos=(0.0, 0.0, -4.0)):
    """tests/test_treelet.py's rays: a w x h pinhole frame from pos."""
    from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                    generate_rays)
    cam = Camera.create(list(pos), [0.0, 0.0, 1.0],
                        device=torch.device("cpu"))
    return (cam, *generate_rays(cam_matrix(cam, h), w, h))


def soup(n=4000, emissive_frac=0.0):
    """tests/test_treelet.py's soup (emissive_frac: the same triangles, that
    share of them emitting)."""
    from clpathtracer_tpu_torch.scene.procedural import random_tri_soup
    return random_tri_soup(n, seed=2, extent=2.0, tri_size=0.05,
                           emissive_frac=emissive_frac,
                           device=torch.device("cpu"))


def treelet_checks(rank, tmp):
    """On a (rows 2, scene 2) mesh: the ring (rank k walks rays block k of
    4, the two blocks rotating over its "scene" pair), intersect_sharded
    (rays split over "rows"), make_treelet_renderer's normal frame and one
    ShardedTree train step on verts; then a 6x8 frame, whose height the 4
    ranks do not divide (its 48 pixels in ranges of 12): the ring on the
    rank's range, the treelet frame (normal, edge-aware, and path mode
    with NEE on an emitting soup), a ShardedTree train step in normal
    mode and one in path mode on explicit draws, and the raise of a light
    stride (8) whose runs the ranges split."""
    from clpathtracer_tpu_torch.parallel.mesh import default_mesh
    from clpathtracer_tpu_torch.parallel.train import make_train_step
    from clpathtracer_tpu_torch.parallel.treelet import (
        build_sharded_tree, intersect_ring, intersect_sharded,
        make_treelet_renderer, resident)
    from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                          path_draws)
    cpu = torch.device("cpu")
    mesh = default_mesh(2, device_type="cpu")
    scene = soup()
    stree = build_sharded_tree(scene.tri_corners(), 2, device=cpu)
    cam, o, d = soup_rays()
    q = o.shape[0] // WORLD
    mine = slice(rank * q, (rank + 1) * q)
    ring = intersect_ring(resident(stree, mesh), o[mine], d[mine])
    r = mesh.get_local_rank("rows")
    rows = slice(r * 2 * q, (r + 1) * 2 * q)
    sh = intersect_sharded(stree, scene, o[rows], d[rows], mesh)
    img = make_treelet_renderer(RenderOptions(32, 32), mesh)(stree, scene,
                                                             cam)
    small = soup(1000)
    s_stree = build_sharded_tree(small.tri_corners(), 2, device=cpu)
    opts = RenderOptions(16, 16, differentiable=True)
    target = torch.full((16, 16, 3), 0.5)
    step, init = make_train_step(
        small, opts, lambda p: torch.optim.Adam(p.values(), lr=1e-3),
        tree=s_stree, mesh=mesh)
    state, loss = step(init({"verts": small.verts}), cam, target)
    _, o6, d6 = soup_rays(8, 6)
    q6 = o6.shape[0] // WORLD
    flat = slice(rank * q6, (rank + 1) * q6)
    ring6 = intersect_ring(resident(stree, mesh), o6[flat], d6[flat])
    img6 = make_treelet_renderer(RenderOptions(8, 6), mesh)(stree, scene,
                                                            cam)
    step6, init6 = make_train_step(
        small, RenderOptions(8, 6, differentiable=True),
        lambda p: torch.optim.Adam(p.values(), lr=1e-3), tree=s_stree,
        mesh=mesh)
    _, loss6 = step6(init6({"verts": small.verts}), cam,
                     torch.full((6, 8, 3), 0.5))
    img6e = make_treelet_renderer(RenderOptions(8, 6, edge_aware=True),
                                  mesh)(stree, scene, cam)
    lit = soup(emissive_frac=0.3)   # soup()'s triangles, some emitting
    popts = RenderOptions(8, 6, mode="path", spp=2, bounces=2, nee=True,
                          nee_light_stride=4)
    img6p = make_treelet_renderer(popts, mesh)(
        stree, lit, cam, generator=torch.Generator().manual_seed(5))
    draws = path_draws(popts, torch.Generator().manual_seed(7), cpu)
    lit_small = soup(1000, emissive_frac=0.3)
    step6p, init6p = make_train_step(
        lit_small, dataclasses.replace(popts, differentiable=True),
        lambda p: torch.optim.Adam(p.values(), lr=1e-3), tree=s_stree,
        mesh=mesh)
    _, loss6p = step6p(init6p({"verts": lit_small.verts}), cam,
                       torch.full((6, 8, 3), 0.5), draws)
    step8, init8 = make_train_step(
        lit_small, dataclasses.replace(popts, differentiable=True,
                                       nee_light_stride=8),
        lambda p: torch.optim.Adam(p.values(), lr=1e-3), tree=s_stree,
        mesh=mesh)
    try:   # ranges of 12 pixels are not whole runs of 8
        step8(init8({"verts": lit_small.verts}), cam,
              torch.full((6, 8, 3), 0.5), path_draws(
                  dataclasses.replace(popts, nee_light_stride=8),
                  torch.Generator().manual_seed(7), cpu))
        stride8 = ""
    except ValueError as e:
        stride8 = str(e)
    return {"ring_hit": ring["hit"], "ring_t": ring["t"],
            "ring_tri": ring["tri"], "sh_hit": sh["hit"], "sh_t": sh["t"],
            "sh_tri": sh["tri"], "image": img, "loss": loss,
            "verts": state.params["verts"], "ring6_hit": ring6["hit"],
            "ring6_t": ring6["t"], "ring6_tri": ring6["tri"],
            "image6": img6, "loss6": loss6, "image6e": img6e,
            "image6p": img6p, "loss6p": loss6p, "stride8": stride8}


def parallel_checks(rank, tmp):
    """On a (rows 4, scene 1) mesh: the mesh shapes and raises, the
    row-sharded frames (normal and mirror on whole-gate windows, path on
    the tree), H % R, the Cornell box's flat-scan frame, three rows train
    steps, and the CLI's --sharded frames."""
    import contextlib
    import io

    from clpathtracer_tpu_torch.accel.sah import build_kd_tree
    from clpathtracer_tpu_torch.cli.main import main as cli
    from clpathtracer_tpu_torch.core.camera import Camera
    from clpathtracer_tpu_torch.ops import plist
    from clpathtracer_tpu_torch.parallel.mesh import (block_generator,
                                                      default_mesh,
                                                      make_sharded_renderer,
                                                      render_image_sharded)
    from clpathtracer_tpu_torch.parallel.train import make_train_step
    from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                          path_draws)
    from clpathtracer_tpu_torch.scene.procedural import (cornell_box,
                                                         icosphere)
    cpu = torch.device("cpu")
    out = {}
    mesh = default_mesh(device_type="cpu")
    out["shapes"] = np.array([mesh.shape, default_mesh(
        2, device_type="cpu").shape, default_mesh(
        4, device_type="cpu").shape])
    try:
        default_mesh(3, device_type="cpu")
        out["raises3"] = 0
    except ValueError:
        out["raises3"] = 1
    ico = icosphere(2, device=cpu).bake_shading()
    mwin = plist.attach_resolve(plist.attach_so(plist.build_morton_windows(
        ico.tri_corners(), device=cpu)), ico.shade_rows)
    cam = Camera.create([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], device=cpu)
    for mode in ("normal", "mirror"):
        out[mode] = render_image_sharded(
            ico, cam, RenderOptions(32, 64, mode=mode), mwin, mesh=mesh)
    box = cornell_box(device=cpu)
    tree = build_kd_tree(box.tri_corners(), device=cpu)
    bcam = Camera.create([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], device=cpu)
    p_opts = RenderOptions(16, 16, mode="path", bounces=2)
    out["path"] = render_image_sharded(
        box, bcam, p_opts, tree=tree, mesh=mesh,
        generator=torch.Generator().manual_seed(1))
    out["path_stream"] = path_draws(
        RenderOptions(16, 4, mode="path"),
        block_generator(torch.Generator().manual_seed(1), rank, cpu),
        cpu)[1].reshape(-1)[:8]
    try:
        make_sharded_renderer(RenderOptions(16, 30), mesh)
        out["raises_rows"] = 0
    except ValueError:
        out["raises_rows"] = 1
    out["box"] = render_image_sharded(box, bcam, RenderOptions(16, 16),
                                      mesh=mesh)
    t_opts = RenderOptions(16, 16, mode="path", bounces=2, background=0.0,
                           differentiable=True)
    draws = path_draws(t_opts, torch.Generator().manual_seed(3), cpu)
    with torch.no_grad():
        target = render_image_sharded(box.replace(albedo=box.albedo * 1.2),
                                      bcam, t_opts, tree=tree, mesh=mesh)
    step, init = make_train_step(
        box, t_opts, lambda p: torch.optim.SGD(p.values(), lr=0.5),
        tree=tree, mesh=mesh)
    state = init({"albedo": box.albedo})
    losses = []
    for _ in range(3):
        state, loss = step(state, bcam, target, draws)
        losses.append(float(loss))
    out["target"], out["losses"] = target, np.array(losses)
    out["albedo"] = state.params["albedo"].detach()
    obj = os.path.join(tmp, "cube.obj")
    with open(obj, "w") as f:
        f.write(CUBE_OBJ)
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for mode in ("normal", "mirror"):
            cli(["render", *cli_args(obj, mode), "--sharded", "--out",
                 os.path.join(tmp, f"sharded_{mode}.png")])
        try:
            cli(["render", *cli_args(obj, "normal", height=30), "--sharded",
                 "--out", os.path.join(tmp, "odd.png")])
            out["cli_exit"] = ""
        except SystemExit as e:
            out["cli_exit"] = str(e)
    return out


def cli_args(obj, mode, height=16):
    """The CLI frame of the --sharded checks: the cube from the side."""
    return [obj, "--cpu", "--no-cache", "--width", "32", "--height",
            str(height), "--mode", mode, "--position", "0.3", "0.2", "-1.0"]


CHECKS = {"treelet": treelet_checks, "parallel": parallel_checks}
