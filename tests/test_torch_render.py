"""Port parity, the whole slice: the port's render_image (normal mode,
64x64, ~16k-triangle terrain, windows from the port's own builder)
against the JAX package's render_image on its plist route (Morton
windows with shared-origin tables and resolve rows attached to a
kd-tree, its Pallas kernel in interpret mode on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from clpathtracer_tpu.accel.sah import attach_morton_windows, build_kd_tree
from clpathtracer_tpu.core.camera import Camera as JCamera
from clpathtracer_tpu.render import integrator as jint
from clpathtracer_tpu.scene.procedural import terrain_mesh as jterrain
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops import plist as tpl
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from clpathtracer_tpu_torch.scene.procedural import terrain_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]


@pytest.fixture(scope="module")
def port_scene():
    scene = terrain_mesh(16_000, seed=0, extent=10.0, device=CPU) \
        .bake_shading()
    mwin = tpl.build_morton_windows(scene.tri_corners(), 16, device=CPU)
    mwin = tpl.attach_resolve(tpl.attach_so(mwin), scene.shade_rows)
    return scene, mwin


@pytest.fixture(scope="module")
def jax_image():
    """One JAX render_image compile."""
    scene = jterrain(16_000, seed=0, extent=10.0).bake_shading()
    tv = np.asarray(scene.tri_corners())
    tree = build_kd_tree(tv, max_depth=12, leaf_size=64, tri_block=4)
    tree = attach_morton_windows(tree, tv, win_rows=16, with_so=True,
                                 shade_rows=scene.shade_rows)
    opts = jint.RenderOptions(width=64, height=64, mode="normal",
                              intersector="packet")
    cam = JCamera.create(position=POS, forward=FWD)
    return np.asarray(jint.render_image(scene, cam, opts, tree=tree))


def test_render_image_matches_jax(port_scene, jax_image):
    scene, mwin = port_scene
    cam = Camera.create(POS, FWD, device=CPU)
    img = render_image(scene, cam, RenderOptions(width=64, height=64), mwin)
    assert img.shape == (64, 64, 3) and img.dtype == torch.float32
    img = img.numpy()
    assert np.isfinite(img).all()
    # same hits -> same image, up to exact-t tie winners at shared mesh
    # edges, which carry different per-face normals: the tie budget of
    # tests/test_plist.py::test_render_image_uses_plist_when_attached
    differ = (np.abs(img - jax_image).max(axis=-1) > 1e-5).mean()
    assert differ < 1.5e-2, differ
    assert (img < 1.0).any(axis=-1).all()      # this camera sees only terrain


def _budget(img, ref, px=1e-5, share=1.5e-2, mad=None):
    """Pixels that differ by more than px stay under `share` of the image
    (the tie budget above), and with `mad` the mean abs difference under
    it (the NEE image budgets of tests/test_torch_nee.py)."""
    img, ref = img.numpy(), ref.numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    differ = (np.abs(img - ref).max(axis=-1) > px).mean()
    assert differ < share, differ
    if mad is not None:
        assert np.abs(img - ref).mean() <= mad


@pytest.mark.parametrize("case", [
    "mirror", "path", "spp", "differentiable", "edge_aware", "spheres",
    "no_windows", "frame_shape"])
def test_outside_the_slice_raises(port_scene, case):
    """What these cases do now: each renders, held to another route of
    the port on the same draws. Differentiable frames (also edge-aware
    ones) take the kd-tree: with windows alone they raise ValueError
    naming tree=; with the tree (the rope walk's plain version) the
    forward image equals the plain frame's (on the windows; an edge-aware
    one on the tree).
    Mirror mode and a frame without windows take the flat scan (W2's
    plain version), NEE without a grid the windows' sorted bundles (K1'),
    spheres merge after the windows route. A windows-only frame that is
    not whole gates raises ValueError naming tree=; with the tree it
    takes the rope walk."""
    scene, mwin = port_scene
    cam = Camera.create(POS, FWD, device=CPU)
    opts = RenderOptions(width=64, height=64)
    if case in ("differentiable", "edge_aware"):
        from clpathtracer_tpu_torch.accel.sah import build_kd_tree
        opts = RenderOptions(width=64, height=64, differentiable=True,
                             edge_aware=case == "edge_aware")
        with pytest.raises(ValueError, match="tree="):
            render_image(scene, cam, opts, mwin)
        tree = build_kd_tree(scene.tri_corners(), max_depth=12,
                             leaf_size=64, device=CPU)
        # the plain frame: the windows', or for the edge-aware frame (whose
        # band spreads a tie winner's change to its neighbours) the tree's
        _budget(render_image(scene, cam, opts, mwin, tree=tree),
                render_image(scene, cam, dataclasses.replace(
                    opts, differentiable=False),
                    None if opts.edge_aware else mwin, tree=tree))
    elif case in ("mirror", "no_windows"):
        opts = RenderOptions(width=32, height=32,
                             mode="mirror" if case == "mirror" else "normal")
        _budget(render_image(scene, cam, opts), render_image(
            scene, cam, opts, mwin))
    elif case in ("path", "spp"):      # NEE: windows alone against a grid
        from clpathtracer_tpu_torch.accel.grid import build_grid
        opts = RenderOptions(width=32, height=32, mode="path", nee=True,
                             background=0.0,
                             spp=2 if case == "spp" else 1)
        img = render_image(scene, cam, opts, mwin)
        ref = render_image(scene, cam, opts, mwin,
                           grid=build_grid(scene.tri_corners(), device=CPU))
        _budget(img, ref, px=1e-4, share=2e-2, mad=2e-3)
    elif case == "spheres":            # against the flat scan
        opts = RenderOptions(width=32, height=32)
        plain = render_image(scene, cam, opts, mwin)
        scene = scene.replace(sphere_pos=torch.tensor([[0.0, 3.0, 0.0]]),
                              sphere_radius=torch.full((1,), 3.0),
                              sphere_albedo=torch.full((1, 3), 0.5),
                              sphere_emission=torch.zeros((1, 3)))
        img = render_image(scene, cam, opts, mwin)
        _budget(img, render_image(scene, cam, opts))
        assert (img != plain).any(dim=-1).float().mean() > 0.05
    else:                              # 48x48 is not whole 32x16 gates
        opts = RenderOptions(width=48, height=48)
        with pytest.raises(ValueError, match="tree="):
            render_image(scene, cam, opts, mwin)
        from clpathtracer_tpu_torch.accel.sah import build_kd_tree
        tree = build_kd_tree(scene.tri_corners(), max_depth=12,
                             leaf_size=64, device=CPU)
        _budget(render_image(scene, cam, opts, mwin, tree=tree),
                render_image(scene, cam, opts))


def test_traverse_plist_without_tables_raises(port_scene):
    """Without shared-origin tables the gates run K1' on the raw records
    (the same image up to edge flips and tie winners); without fused
    resolve rows the winners resolve from the records and _surface
    gathers their shading: the frame equals the fused frame exactly."""
    scene, mwin = port_scene
    cam = Camera.create(POS, FWD, device=CPU)
    opts = RenderOptions(width=64, height=64)
    so = render_image(scene, cam, opts, mwin).numpy()
    mt = render_image(scene, cam, opts, mwin.replace(so_base=None)).numpy()
    assert (np.abs(mt - so).max(axis=-1) > 1e-5).mean() < 1.5e-2
    unfused = render_image(scene, cam, RenderOptions(width=64, height=64),
                           mwin.replace(resolve_rows=None)).numpy()
    np.testing.assert_array_equal(unfused, so)
