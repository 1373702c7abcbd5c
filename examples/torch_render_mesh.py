"""Render a mesh to PNG with the PyTorch port: the reference's core loop
in a few lines of API (the port's counterpart of examples/render_mesh.py).

Usage:
    python examples/torch_render_mesh.py [model.obj] [out.png] [--cpu]

Without a model argument, renders the procedural terrain (its 1M-triangle
version is the port's surface scene in chip_smoke.py). Runs on the first
CUDA device; --cpu runs on the host with the kernels' plain versions.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clpathtracer_tpu_torch import Camera  # noqa: E402
from clpathtracer_tpu_torch.render.integrator import (  # noqa: E402
    RenderOptions, render_image)
from clpathtracer_tpu_torch.utils.device import pick_device  # noqa: E402
from clpathtracer_tpu_torch.utils.png import tonemap, write_png  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", nargs="?", help=".obj, .kd or .npz model")
    ap.add_argument("out", nargs="?", default="out.png")
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    args = ap.parse_args()
    device = pick_device("cpu" if args.cpu else "gpu")
    if args.model:
        from clpathtracer_tpu_torch.scene.cache import load_model
        scene, tree = load_model(args.model, leaf_size=64, max_depth=18,
                                 device=device)
        cam = Camera.create([0.0, 0.1, -0.4], [0.0, 0.0, 1.0],
                            device=device)
    else:
        from clpathtracer_tpu_torch.accel.sah import build_kd_tree
        from clpathtracer_tpu_torch.scene.procedural import terrain_mesh
        scene = terrain_mesh(50_000, device=device)
        tree = build_kd_tree(scene.tri_corners(), leaf_size=64, max_depth=16,
                             device=device)
        cam = Camera.create([6.0, 12.0, -10.0], [-0.4, -0.8, 0.8],
                            device=device)

    opts = RenderOptions(width=256, height=256, mode="normal")
    img = render_image(scene, cam, opts, tree=tree)
    write_png(args.out, tonemap(img.cpu().numpy()))
    print(f"wrote {args.out} ({scene.num_tris} tris, {device})")


if __name__ == "__main__":
    main()
