"""Scene-parallel rendering with the PyTorch port's treelet ring (the
port's counterpart of examples/scene_parallel_ring.py).

For scenes too large to hold whole on one device: the triangles are
split into Morton treelet blocks, one resident on each rank of the
mesh's "scene" axis; during intersection the blocks rotate around the
ring (send/recv, the next block posted before the current one is walked;
parallel/treelet.py). The frame's rows split over both axes. The example
checks that the image is bit-identical to the single-tree render.

Usage:
  python examples/torch_scene_parallel_ring.py --cpu
      spawns a local world of 4 gloo processes (rows 2 x scene 2);
  torchrun --nproc-per-node 4 examples/torch_scene_parallel_ring.py
      one rank a CUDA card (NCCL), scene axis --scene (default 2).
Exits 1 when the image differs.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from clpathtracer_tpu_torch import Camera  # noqa: E402
from clpathtracer_tpu_torch.accel.sah import build_kd_tree  # noqa: E402
from clpathtracer_tpu_torch.parallel.mesh import default_mesh  # noqa: E402
from clpathtracer_tpu_torch.parallel.multihost import (  # noqa: E402
    init_distributed)
from clpathtracer_tpu_torch.parallel.treelet import (  # noqa: E402
    build_sharded_tree, make_treelet_renderer)
from clpathtracer_tpu_torch.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu_torch.scene.procedural import (  # noqa: E402
    random_tri_soup)

LOCAL_WORLD = 4


def run(device, scene_parallel):
    """Render the soup both ways on this rank; True when they agree."""
    scene = random_tri_soup(20_000, seed=2, extent=2.0, tri_size=0.05,
                            device=device)
    tv = scene.tri_corners()
    cam = Camera.create([0.0, 0.0, -4.0], [0.0, 0.0, 1.0], device=device)
    opts = RenderOptions(width=64, height=64, mode="normal")
    ref = render_image(scene, cam, opts,
                       tree=build_kd_tree(tv, device=device))
    mesh = default_mesh(scene_parallel, device_type=device.type)
    stree = build_sharded_tree(tv, scene_parallel, device=device)
    img = make_treelet_renderer(opts, mesh)(stree, scene, cam)
    same = bool(torch.equal(ref, img))
    if dist.get_rank() == 0:
        print("mesh:", dict(zip(mesh.mesh_dim_names, mesh.shape)))
        print("blocks:", stree.total_blocks, "- records a rank:",
              tuple(stree.tris.shape[1:]))
        print("bit-identical to the single-tree render:", same)
    return same


def _local_rank(rank, store, scene_parallel, result):
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", LOCAL_WORLD, rank, 120,
                     device="cpu")
    result[rank] = run(torch.device("cpu"), scene_parallel)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help=f"spawn a local world of {LOCAL_WORLD} on the host")
    ap.add_argument("--scene", type=int, default=2,
                    help="ranks on the mesh's scene axis")
    args = ap.parse_args()
    if args.cpu:
        ctx = torch.multiprocessing.get_context("spawn")
        result = ctx.Manager().dict()
        store = os.path.join(tempfile.mkdtemp(prefix="clpt_ring_"), "store")
        procs = [ctx.Process(target=_local_rank,
                             args=(r, store, args.scene, result))
                 for r in range(LOCAL_WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        ok = (all(p.exitcode == 0 for p in procs)
              and all(result.get(r) for r in range(LOCAL_WORLD)))
    else:   # one process a card, under torchrun
        init_distributed()
        ok = run(torch.device("cuda", torch.cuda.current_device()),
                 args.scene)
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
