"""Inverse-rendering optimization on one device (the one-device part of
clpathtracer_tpu/parallel/train.py).

Given a target image, optimize scene parameters (vertex positions,
materials) by gradient descent through the differentiable renderer
(RenderOptions.differentiable). The JAX package shards the pixels over a
mesh's "rows" axis and can shard the scene over a treelet ring; both are
ROADMAP queue 1 item 6 and raise here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      _check_supported,
                                                      render_image)


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
    renders the frame with render_image (tree, grid, shadow as its),
    loss = mean((image - target)^2) in linear radiance over the [H, W, 3]
    target, then backward() and one optimizer step (the state's tensors
    change in place). Path mode takes draws as a torch.Generator or as
    render_image's (jitter, bounce, light), else render_image's default
    generator. marks (optional): called with "forward", "backward" and
    "update" after each part, for timing.

    Raises ValueError without opts.differentiable (the port's walks and
    scans carry no gradient) and NotImplementedError for a mesh (the JAX
    package's row-sharded and scene-sharded steps, ROADMAP queue 1 item
    6). Unlike the JAX step, which shades the pixel-grid rays once, the
    frame is render_image's: spp > 1 averages jittered samples."""
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet: the mesh-sharded train step (pixel rows, "
            "treelet rings) is ROADMAP queue 1 item 6")
    if not opts.differentiable:
        raise ValueError(
            "training needs opts.differentiable=True: the walks and scans "
            "of a plain frame carry no gradient")
    _check_supported(scene, opts, None, tree, grid)

    def init(params: dict = None) -> TrainState:
        src = params if params is not None else {
            f: getattr(scene, f) for f in ("verts", "albedo", "emission")}
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in src.items()}
        return TrainState(leaves, optimizer(leaves))

    def step(state: TrainState, camera, target, draws=None, marks=None):
        mark = marks or (lambda part: None)
        kw = {}
        if isinstance(draws, torch.Generator):
            kw["generator"] = draws
        elif draws is not None:
            kw["jitter"], kw["bounce"], kw["light"] = draws
        state.optimizer.zero_grad(set_to_none=True)
        img = render_image(apply_params(scene, state.params), camera, opts,
                           tree=tree, grid=grid, shadow=shadow, **kw)
        loss = torch.mean((img - target) ** 2)
        mark("forward")
        loss.backward()
        mark("backward")
        state.optimizer.step()
        mark("update")
        return state, loss.detach()

    return step, init
