"""Inverse-rendering optimization (port of clpathtracer_tpu/parallel/
train.py).

Given a target image, optimize scene parameters (vertex positions,
materials) by gradient descent through the differentiable renderer
(RenderOptions.differentiable), on one device or over a mesh
(parallel/mesh.py::default_mesh). On a mesh every rank renders its block
of the frame's pixels (render/integrator.py::render_lanes: whole rows
when the ranks divide the height) and takes its share of the loss;
backward() gives the rank's gradients, all_reduce(SUM) over the world
makes them the frame's (the JAX package's GSPMD inserts that
all-reduce), and every rank applies the same update, so the parameters
stay equal on every rank. With a parallel/treelet.py::
ShardedTree the blocks split over both mesh axes and the hit topology
comes through the treelet ring.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

import torch.distributed as dist

from clpathtracer_tpu_torch.parallel.mesh import (_check_lanes, axis_size,
                                                  block_generator)
from clpathtracer_tpu_torch.parallel.treelet import ShardedTree, resident
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      _check_supported,
                                                      render_lanes)


class TrainState(NamedTuple):
    params: dict                      # field name -> leaf tensor
    optimizer: torch.optim.Optimizer  # over params' tensors


def apply_params(scene, params: dict):
    """The scene with the optimizable fields replaced: a new object each
    step, so that no cached table (Scene.tri_records) outlives one."""
    return scene.replace(**params)


def make_train_step(scene, opts: RenderOptions,
                    optimizer: Callable[[dict], torch.optim.Optimizer], *,
                    tree=None, grid=None, shadow=None, mesh=None):
    """Build a train step: returns (step, init).

    optimizer: builds a torch.optim optimizer from the parameter dict
    (for example `lambda p: torch.optim.SGD(p.values(), lr=0.1)`).
    init(params=None) -> TrainState: leaf copies (requires_grad) of the
    given dict's tensors (interop.params_from_numpy), by default the
    scene's verts, albedo and emission, and the optimizer over them.
    step(state, camera, target, draws=None, marks=None) -> (state, loss):
    renders the frame as render_image does (tree, grid, shadow as its),
    loss = mean((image - target)^2) in linear radiance over the [H, W, 3]
    target, then backward() and one optimizer step (the state's tensors
    change in place). Path mode takes draws as a torch.Generator or as
    render_image's (jitter, bounce, light), else render_image's default
    generator. marks (optional): called with "forward", "backward" and
    "update" after each part, for timing.

    mesh (a ("rows", "scene") DeviceMesh over the whole world): the
    frame's H * W pixels split into R * S equal ranges in row-major order,
    one a rank (rank rows_idx * S + scene_idx takes range rows_idx * S +
    scene_idx, the JAX package's P(("rows", "scene")); R * S must divide
    H * W), each rendered by render_lanes (whole rows when R * S divides
    H, else a row of its own) and held to its pixels of the [H, W, 3]
    target.
    The rank's loss is its block's mean squared error times its share of
    the pixels, so the ranks' losses sum to the frame's mean (on a world
    of 1 the factor is 1.0 and the step is the one-device step's bit for
    bit); after backward() every parameter's gradient is all-reduced
    (SUM) over the world before the optimizer step; step returns the
    summed loss on every rank. A ShardedTree as `tree` is placed on the
    mesh (parallel/treelet.py::resident: one block a rank of a "scene"
    axis of S > 1, its hits through the ring). Explicit draws are the full
    frame's and each rank takes its pixels (light uniforms: its range
    must be whole runs of nee_light_stride); a generator seeds each
    block's own (parallel/mesh.py::block_generator), so a generator's step
    differs from the one-device step's and has the same distribution.

    Raises ValueError without opts.differentiable (the port's walks and
    scans carry no gradient). Unlike the JAX step, which shades the
    pixel-grid rays once, the frame is render_image's: spp > 1 averages
    jittered samples."""
    if not opts.differentiable:
        raise ValueError(
            "training needs opts.differentiable=True: the walks and scans "
            "of a plain frame carry no gradient")
    _check_supported(scene, opts, None, tree, grid, shadow)
    index, n_blocks = 0, 1
    if mesh is not None:
        n_blocks = mesh.size()
        if n_blocks != dist.get_world_size():
            raise ValueError(f"a mesh of {n_blocks} ranks in a world of "
                             f"{dist.get_world_size()}")
        _check_lanes(opts, n_blocks, "the mesh's ranks")
        index = mesh.get_local_rank("rows") * axis_size(mesh, "scene") \
            + mesh.get_local_rank("scene")
        if isinstance(tree, ShardedTree):
            tree = resident(tree, mesh)
    n_pix = opts.width * opts.height
    n_lanes = n_pix // n_blocks
    lanes = slice(index * n_lanes, (index + 1) * n_lanes)

    def init(params: dict = None) -> TrainState:
        src = params if params is not None else {
            f: getattr(scene, f) for f in ("verts", "albedo", "emission")}
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in src.items()}
        return TrainState(leaves, optimizer(leaves))

    def block_draws(draws, device):
        if mesh is None or draws is None:
            return draws
        if isinstance(draws, torch.Generator):
            return block_generator(draws, index, device)
        jitter, bounce, light = draws
        if light is not None:
            stride = opts.nee_light_stride
            if lanes.start % stride or n_lanes % stride:
                raise ValueError(f"pixels {lanes.start}-{lanes.stop} are not "
                                 f"whole runs of nee_light_stride {stride}")
            light = light[:, :, lanes.start // stride:lanes.stop // stride]
        return (None if jitter is None else jitter[:, lanes],
                bounce[:, :, lanes], light)

    def step(state: TrainState, camera, target, draws=None, marks=None):
        mark = marks or (lambda part: None)
        kw = {}
        draws = block_draws(draws, camera.position.device)
        if isinstance(draws, torch.Generator):
            kw["generator"] = draws
        elif draws is not None:
            kw["jitter"], kw["bounce"], kw["light"] = draws
        state.optimizer.zero_grad(set_to_none=True)
        img = render_lanes(apply_params(scene, state.params), camera, opts,
                           lanes.start, n_lanes, tree=tree, grid=grid,
                           shadow=shadow, **kw)
        loss = torch.mean((img - target.reshape(-1, 3)[lanes]) ** 2)
        if mesh is not None:
            loss = loss * (img.numel() / (n_pix * 3))
        mark("forward")
        loss.backward()
        if mesh is not None:
            for p in state.params.values():
                if p.grad is None and n_blocks > 1:   # every rank reduces
                    p.grad = torch.zeros_like(p)
                if p.grad is not None:
                    dist.all_reduce(p.grad)
        mark("backward")
        state.optimizer.step()
        mark("update")
        loss = loss.detach()
        if mesh is not None:
            dist.all_reduce(loss)
        return state, loss

    return step, init
