"""Inverse rendering with the PyTorch port: recover the Cornell walls'
albedo from a target image by gradient descent through the
differentiable renderer (the port's counterpart of
examples/inverse_rendering.py, on one device: the port's make_train_step;
make_train_step(mesh=...) splits the rows over ranks, as
examples/torch_silhouette_fitting.py does on a world of 1).

Usage: python examples/torch_inverse_rendering.py [--cpu] [--steps N]

Runs on the first CUDA device; --cpu runs on the host with the kernels'
plain versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from clpathtracer_tpu_torch import Camera  # noqa: E402
from clpathtracer_tpu_torch.accel.sah import build_kd_tree  # noqa: E402
from clpathtracer_tpu_torch.parallel.train import make_train_step  # noqa: E402
from clpathtracer_tpu_torch.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from clpathtracer_tpu_torch.utils.device import pick_device  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    ap.add_argument("--steps", type=int, default=80)
    args = ap.parse_args()
    device = pick_device("cpu" if args.cpu else "gpu")
    scene = cornell_box(light=True, device=device)
    tree = build_kd_tree(scene.tri_corners(), device=device)
    cam = Camera.create([0.0, 0.0, -1.0], [0.0, 0.0, 1.0], device=device)
    opts = RenderOptions(width=48, height=48, mode="path", bounces=2,
                         background=0.0, differentiable=True)

    def draws():
        # a fixed seed: the same Monte Carlo sample every step, so the
        # descent converges deterministically
        return torch.Generator(device=device).manual_seed(0)

    # ground truth with the true materials, then start from grey
    with torch.no_grad():
        target = render_image(scene, cam, opts, tree=tree,
                              generator=draws())
    truth = scene.albedo
    grey = scene.replace(albedo=torch.full_like(truth, 0.5))
    step, init = make_train_step(
        grey, opts, lambda p: torch.optim.Adam(p.values(), lr=3e-2),
        tree=tree)
    state = init({"albedo": grey.albedo})

    def error():
        return float((state.params["albedo"].detach().clamp(0, 1)
                      - truth).abs().mean())

    for i in range(args.steps):
        state, loss = step(state, cam, target, draws())
        if i % 20 == 0:
            print(f"step {i:3d}: loss {float(loss):.6f}  "
                  f"mean albedo error {error():.4f}")
    print(f"final mean albedo error: {error():.4f} (started at ~0.25)")


if __name__ == "__main__":
    main()
