"""Port parity, core and scene: the torch matrix/camera/ray/procedural code
against clpathtracer_tpu on the same inputs (made with numpy from a
seed), on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clpathtracer_tpu.core import camera as jcam
from clpathtracer_tpu.core.matrix import mat_inverse as j_mat_inverse
from clpathtracer_tpu.scene import procedural as jproc
from clpathtracer_tpu_torch.core import camera as tcam
from clpathtracer_tpu_torch.core.matrix import mat_inverse, mat_multiply
from clpathtracer_tpu_torch.scene import procedural as tproc

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_mat_inverse_matches_jax():
    m = np.random.default_rng(0).normal(size=(32, 4, 4)).astype(np.float32)
    got = mat_inverse(torch.as_tensor(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_mat_inverse(m)), rtol=1e-6,
                               atol=1e-6)
    eye = mat_multiply(torch.as_tensor(m), torch.as_tensor(got)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-3)


def test_mat_inverse_singular_is_zero():
    m = np.random.default_rng(1).normal(size=(3, 4, 4)).astype(np.float32)
    # exactly singular in f32: a zero column, a zero matrix, a zero row
    m[0, :, 2] = 0.0
    m[1] = 0.0
    m[2, 3, :] = 0.0
    got = mat_inverse(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, np.zeros_like(m))
    np.testing.assert_allclose(got, np.asarray(j_mat_inverse(m)), rtol=1e-6)


@pytest.mark.parametrize("pose", [
    ([0.0, 14.0, 0.0], [0.0, -1.0, 0.01]),
    ([0.3, -0.2, -1.5], [0.1, 0.2, 1.0]),
])
def test_cam_matrix_and_rays_match_jax(pose):
    pos, fwd = pose
    jc = jcam.Camera.create(position=pos, forward=fwd)
    tc = tcam.Camera.create(pos, fwd, device=CPU)
    np.testing.assert_allclose(tc.forward.numpy(), np.asarray(jc.forward),
                               rtol=1e-6, atol=1e-7)
    jm = jcam.cam_matrix(jc, 64)
    tm = tcam.cam_matrix(tc, 64)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)
    jo, jd = jcam.generate_rays(jm, 64, 64)
    # rays from the same matrix isolate generate_rays
    to, td = tcam.generate_rays(torch.as_tensor(np.array(jm)), 64, 64)
    assert td.shape == (64 * 64, 3) and to.shape == (64 * 64, 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_terrain_and_bake_shading_bit_exact():
    js = jproc.terrain_mesh(8000, seed=3, extent=10.0).bake_shading()
    ts = tproc.terrain_mesh(8000, seed=3, extent=10.0, device=CPU) \
        .bake_shading()
    for name in ("verts", "faces", "normals", "albedo", "emission",
                 "shade_rows"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_array_equal(ts.tri_corners(), js.tri_corners())
    for a, b in zip(ts.tri_verts(), js.tri_verts()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_two_triangles_bit_exact():
    js = jproc.two_triangles().bake_shading()
    ts = tproc.two_triangles(device=CPU).bake_shading()
    for name in ("verts", "faces", "shade_rows"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.num_spheres == 0 and ts.num_tris == 2
    assert jnp.asarray(js.verts).shape == tuple(ts.verts.shape)
