"""The rendering integrator: scene + camera -> image (the slice's part of
clpathtracer_tpu/render/integrator.py).

This slice renders the primary-ray frame in normal mode: pinhole rays,
the prepass-list engine (ops/plist.py::traverse_plist) on the scene's
windows, and normals-as-color shading, with miss -> background. Anything
else raises NotImplementedError naming the ROADMAP queue-1 item that
ports it; nothing quietly takes another route. Unlike the JAX package,
the route needs no kd-tree: it takes the windows (MortonWindows with
shared-origin tables and fused resolve rows attached) directly.
"""

from __future__ import annotations

import dataclasses

import torch

from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu_torch.ops.plist import GH, GW, traverse_plist
from clpathtracer_tpu_torch.render.shading import normal_color


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Render configuration: the fields this slice reads."""

    width: int = 256
    height: int = 256
    mode: str = "normal"       # normal | mirror | path
    spp: int = 1               # samples per pixel
    background: float = 1.0    # miss shade
    differentiable: bool = False
    edge_aware: bool = False


def _check_supported(scene, opts: RenderOptions, mwin) -> None:
    """Raise NotImplementedError for what this slice does not carry."""
    todo = None
    if opts.mode != "normal":
        todo = (f"mode {opts.mode!r}: mirror mode is ROADMAP queue 1 item "
                "12, path mode item 10")
    elif opts.spp != 1:
        todo = f"spp={opts.spp}: jittered primaries are queue 1 item 9"
    elif opts.differentiable or opts.edge_aware:
        todo = "differentiable / edge-aware rendering is queue 1 item 14"
    elif scene.num_spheres:
        todo = "sphere primitives come with queue 1 item 12"
    elif mwin is None:
        todo = ("rendering without windows (kd-tree and stream engines) is "
                "queue 1 items 12-13")
    elif opts.height % GH or opts.width % GW:
        todo = (f"a {opts.width}x{opts.height} frame is not a multiple of "
                f"{GW}x{GH} gates; other frames take the kd-tree engines of "
                "queue 1 items 12-13")
    if todo:
        raise NotImplementedError(f"not ported yet: {todo}")


def intersect_scene(scene, mwin, orig, dir, opts: RenderOptions):
    """Nearest hit of shared-origin pixel-grid primary rays: the plist
    branch. Returns hit [N], t [N], tri [N], u/v [N] and the fused shade
    attributes snormal/salbedo/semission [N, 3]."""
    rec = traverse_plist(mwin, orig, dir, (opts.height, opts.width))
    return {k: rec[k] for k in ("hit", "t", "tri", "u", "v", "snormal",
                                "salbedo", "semission")}


def _surface(scene, rec, orig, dir):
    """Hit point and surface attributes of a hit record, from the shade
    attributes the fused resolve carried out of the winner gather."""
    point = orig + rec["t"][:, None] * dir
    return point, rec["snormal"], rec["salbedo"], rec["semission"]


def shade_normal(scene, mwin, orig, dir, opts: RenderOptions):
    """Reference parity: hit -> (normal + 1) / 2, miss -> background."""
    rec = intersect_scene(scene, mwin, orig, dir, opts)
    _, normal, _, _ = _surface(scene, rec, orig, dir)
    return torch.where(rec["hit"][:, None], normal_color(normal),
                       opts.background)


def render_rays(scene, mwin, orig, dir, opts: RenderOptions):
    _check_supported(scene, opts, mwin)
    return shade_normal(scene, mwin, orig, dir, opts)


def render_image(scene, camera, opts: RenderOptions, mwin=None):
    """Render an [H, W, 3] image. mwin: the scene's MortonWindows with
    shared-origin tables and fused resolve rows attached
    (ops/plist.py::build_morton_windows, attach_so, attach_resolve)."""
    cam_inv = cam_matrix(camera, opts.height)
    orig, dir = generate_rays(cam_inv, opts.width, opts.height)
    img = render_rays(scene, mwin, orig, dir, opts)
    return img.reshape(opts.height, opts.width, 3)
