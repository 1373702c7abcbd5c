"""Silhouette fitting with the PyTorch port: recover an occluder's depth
from a target image through edge-aware (silhouette-reparameterized)
gradients (the port's counterpart of examples/silhouette_fitting.py).

With normals-as-color shading the interior gradient of this scene is
exactly zero: all of the signal comes from the silhouette sweeping across
pixels, which a detached-topology renderer cannot see.
`RenderOptions.edge_aware=True` blends a one-pixel band at visibility
edges toward the continuation ray's shading, so backward() carries the
boundary term, and the mesh train step (parallel/train.py, here on a
world of 1) moves the occluder.

Usage: python examples/torch_silhouette_fitting.py [--cpu] [--steps N]

Runs on the first CUDA device (NCCL); --cpu runs on the host (gloo) with
the kernels' plain versions. Exits 1 when the occluder moved away from
the target.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from clpathtracer_tpu_torch import Camera  # noqa: E402
from clpathtracer_tpu_torch.parallel.mesh import default_mesh  # noqa: E402
from clpathtracer_tpu_torch.parallel.multihost import (  # noqa: E402
    init_distributed)
from clpathtracer_tpu_torch.parallel.train import make_train_step  # noqa: E402
from clpathtracer_tpu_torch.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu_torch.scene.procedural import _quad  # noqa: E402
from clpathtracer_tpu_torch.scene.scene import Scene  # noqa: E402
from clpathtracer_tpu_torch.utils.device import pick_device  # noqa: E402


def occluder_scene(dz, device):
    """A tilted backdrop plus a floating occluder quad at z = 1 + dz."""
    verts = [[-4.0, -4.0, 2.0], [4.0, -4.0, 2.0], [4.0, 4.0, 3.0],
             [-4.0, 4.0, 3.0], [-0.35, -0.35, 1.0 + dz],
             [0.35, -0.35, 1.0 + dz], [0.35, 0.35, 1.0 + dz],
             [-0.35, 0.35, 1.0 + dz]]
    faces = _quad(3, 2, 1, 0) + _quad(7, 6, 5, 4)
    normals = [[0.0, 0.124, -0.992], [0.0, 0.0, -1.0]]
    f = [[[i, 0 if k < 2 else 1, 0] for i in tri]
         for k, tri in enumerate(faces)]
    return Scene.create(verts, f, normals=normals, device=device)


class RigidZ(torch.optim.Optimizer):
    """SGD on the occluder's z coordinates only (vertices 4-7): the rigid
    fit of the JAX example's masked update. The silhouette band is about 1
    px of 48^2 pixels, so the per-vertex gradients are ~1e-4, hence the
    large rate on the masked direction."""

    def __init__(self, params, lr):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p[4:, 2] -= group["lr"] * p.grad[4:, 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    device = pick_device("cpu" if args.cpu else "gpu")
    init_distributed(device=device)   # a world of 1 without torchrun's
    mesh = default_mesh(device_type=device.type)
    opts = RenderOptions(width=48, height=48, mode="normal", background=1.0,
                         differentiable=True, edge_aware=True)
    cam = Camera.create([0.011, 0.007, -1.0], [0.0, 0.0, 1.0],
                        device=device)
    target_dz = 0.25
    with torch.no_grad():
        target = render_image(occluder_scene(target_dz, device), cam, opts)
    scene0 = occluder_scene(0.0, device)
    # no structure: the flat scan, as the JAX example's use_tree=False
    step, init = make_train_step(scene0, opts,
                                 lambda p: RigidZ(p.values(), lr=150.0),
                                 mesh=mesh)
    state = init({"verts": scene0.verts})

    def dz():
        return float(state.params["verts"].detach()[4:, 2].mean()) - 1.0
    for i in range(args.steps):
        state, loss = step(state, cam, target)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(loss):.3e}  occluder dz "
                  f"{dz():+.4f} (target {target_dz:+.4f})")
    moved = dz() > 0.0
    print(f"final occluder dz {dz():+.4f} (target {target_dz:+.4f}); moved "
          f"{'toward' if moved else 'AWAY FROM'} the target purely on "
          "silhouette gradient")
    dist.destroy_process_group()
    return 0 if moved else 1


if __name__ == "__main__":
    sys.exit(main())
