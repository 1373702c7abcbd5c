"""Diagnostics: traversal-cost heatmaps and tree-quality metrics (the
port's counterpart of clpathtracer_tpu/render/debug.py).

The reference carries a per-ray traversal step counter whose only
consumer is commented-out heatmap shading (src/kernel.cl:319-331,
373-380, 390-394). Here it is an output channel: per-pixel walk steps of
the rope walk W1 (ops/traverse_fast.py::traverse_fast on a tri_block 4
tree, ops/traverse.py::traverse on another), per-tile costs of the packet
kernel K3 (ops/packet.py::traverse_packet's tile_stats), and a colorized
rendering of either. On a CUDA tree the kernels run; on the CPU their
plain versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from clpathtracer_tpu_torch.core.camera import cam_matrix, generate_rays
from clpathtracer_tpu_torch.ops.packet import traverse_packet
from clpathtracer_tpu_torch.ops.traverse import traverse
from clpathtracer_tpu_torch.ops.traverse_fast import traverse_fast
from clpathtracer_tpu_torch.render.integrator import (MAX_ITERS,
                                                      RenderOptions)

TILE_STATS = {"nodes": 0, "chunks": 1, "active": 2, "culled": 3}


def _primaries(camera, opts: RenderOptions):
    return generate_rays(cam_matrix(camera, opts.height), opts.width,
                         opts.height)


def traversal_steps_image(scene, camera, opts: RenderOptions, tree):
    """[H, W] i32 tensor of W1's walk steps per primary ray (its rec
    ["steps"], on the tree's device). scene is unused: the tree's records
    hold the triangles (the JAX function packs them from the scene)."""
    orig, dir = _primaries(camera, opts)
    if tree.tri_block == 4:
        rec = traverse_fast(tree, orig, dir, max_iters=MAX_ITERS)
    else:
        rec = traverse(tree, orig, dir, tree.tri_block, MAX_ITERS)
    return rec["steps"].reshape(opts.height, opts.width)


def colorize_heatmap(steps, max_steps: int = None) -> np.ndarray:
    """Steps -> RGB: black (0) through red to yellow/white (hot spots),
    the shading the reference sketched at src/kernel.cl:373-380."""
    if isinstance(steps, torch.Tensor):
        steps = steps.cpu().numpy()
    s = np.asarray(steps, np.float32)
    m = float(max_steps if max_steps is not None else max(s.max(), 1.0))
    x = np.clip(s / m, 0.0, 1.0)
    r = np.clip(3.0 * x, 0, 1)
    g = np.clip(3.0 * x - 1.0, 0, 1)
    b = np.clip(3.0 * x - 2.0, 0, 1)
    return np.stack([r, g, b], axis=-1)


def traversal_report(scene, camera, opts: RenderOptions, tree) -> dict:
    """Aggregate traversal-cost metrics for a view: steps a ray (mean,
    max, p99) and the tree stats the reference printfs
    (src/kd_tree.c:232-235)."""
    steps = traversal_steps_image(scene, camera, opts, tree).cpu().numpy()
    return {
        "mean_steps_per_ray": float(steps.mean()),
        "max_steps_per_ray": int(steps.max()),
        "p99_steps_per_ray": float(np.percentile(steps, 99)),
        **{f"tree_{k}": v for k, v in tree.stats().items()},
    }


def packet_tile_image(scene, camera, opts: RenderOptions, tree,
                      stat: str = "chunks"):
    """[H/side, W/side] tensor of per-tile packet-kernel cost of a
    primary frame, from K3's tile_stats column: "nodes" (node pops),
    "chunks" (windows streamed), "active" (live lanes) or "culled"
    (windows culled). tree: a tri_block 4 tree with window tables; tiles
    of opts.packet_tile rays, square. Colorize with colorize_heatmap."""
    col = TILE_STATS[stat]
    side = math.isqrt(opts.packet_tile)
    if side * side != opts.packet_tile:
        raise ValueError(f"packet_tile {opts.packet_tile}: square tiles only")
    if opts.height % side or opts.width % side:
        raise ValueError(f"a {opts.width}x{opts.height} frame is not whole "
                         f"{side}x{side} tiles")
    orig, dir = _primaries(camera, opts)
    rec = traverse_packet(tree, orig, dir, (opts.height, opts.width),
                          tile=opts.packet_tile)
    return rec["tile_stats"][:, col].reshape(opts.height // side,
                                             opts.width // side)
