"""Port parity, the whole slice: the port's render_image (normal mode,
64x64, ~16k-triangle terrain, windows from the port's own builder)
against the JAX package's render_image on its plist route (Morton
windows with shared-origin tables and resolve rows attached to a
kd-tree, its Pallas kernel in interpret mode on the CPU)."""

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


@pytest.mark.parametrize("case", [
    "mirror", "path", "spp", "differentiable", "edge_aware", "spheres",
    "no_windows", "frame_shape"])
def test_outside_the_slice_raises(port_scene, case):
    scene, mwin = port_scene
    cam = Camera.create(POS, FWD, device=CPU)
    opts = dict(width=64, height=64)
    if case == "mirror":       # without windows: queue 1 items 12-13
        opts.update(mode="mirror")
        mwin = None
    elif case == "path":       # next-event estimation: queue 1 item 10
        opts.update(mode="path", nee=True)
    elif case == "spp":        # jittered samples with NEE
        opts.update(mode="path", spp=2, nee=True)
    elif case in ("differentiable", "edge_aware"):
        opts[case] = True
    elif case == "spheres":
        scene = scene.replace(sphere_pos=torch.zeros((1, 3)),
                              sphere_radius=torch.ones((1,)))
    elif case == "no_windows":
        mwin = None
    else:
        opts.update(width=48, height=48)
    with pytest.raises(NotImplementedError):
        render_image(scene, cam, RenderOptions(**opts), mwin)


def test_traverse_plist_without_tables_raises(port_scene):
    """Without shared-origin tables the gates run K1' on the raw records
    (the same image up to edge flips and tie winners); without fused
    resolve rows the render raises."""
    scene, mwin = port_scene
    cam = Camera.create(POS, FWD, device=CPU)
    opts = RenderOptions(width=64, height=64)
    so = render_image(scene, cam, opts, mwin).numpy()
    mt = render_image(scene, cam, opts, mwin.replace(so_base=None)).numpy()
    assert (np.abs(mt - so).max(axis=-1) > 1e-5).mean() < 1.5e-2
    with pytest.raises(NotImplementedError):
        render_image(scene, cam, RenderOptions(width=64, height=64),
                     mwin.replace(resolve_rows=None))
