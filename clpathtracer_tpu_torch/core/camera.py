"""Camera model: view/projection/device matrix chain and ray generation.

Port of clpathtracer_tpu/core/camera.py (the reference's camera.c chain:
a horizon-locked view frame, an OpenGL-style perspective, a pixel-scale
device transform, composed and inverted so that ray generation is an
unprojection of pixel coordinates).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.core.matrix import mat_inverse, mat_multiply
from clpathtracer_tpu_torch.core.struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class Camera(TensorStruct):
    """Pinhole fly-camera.

    near, far: clip planes (far only shapes the unprojection points).
    fov: vertical field of view in radians.
    position: [3] world-space eye position.
    forward: [3] unit view direction.
    """

    near: torch.Tensor
    far: torch.Tensor
    fov: torch.Tensor
    position: torch.Tensor
    forward: torch.Tensor

    @classmethod
    def create(cls, position, forward, *, device, fov=math.pi / 3,
               near=0.1, far=1.0) -> "Camera":
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)
        return cls(near=f32(near), far=f32(far), fov=f32(fov),
                   position=f32(position),
                   forward=vm.normalize(f32(forward)))


def camera_transform(cam: Camera) -> torch.Tensor:
    """World->view matrix: left = normalize((fz, 0, -fx)), up = forward x
    left; translation entries are dot(axis, -position)."""
    f = cam.forward
    left = vm.normalize(torch.stack([f[2], torch.zeros_like(f[2]), -f[0]]))
    up = vm.cross(f, left)
    rot = torch.stack([left, up, f], dim=0)                     # [3, 3]
    trans = vm.dot(rot, -cam.position[None, :])                 # [3]
    top = torch.cat([rot, trans[:, None]], dim=1)               # [3, 4]
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=f.dtype,
                          device=f.device)
    return torch.cat([top, bottom], dim=0)


def projection_transform(cam: Camera) -> torch.Tensor:
    """Perspective matrix, rows
    [c 0 0 0; 0 c 0 0; 0 0 -(f+n)/(n-f) 2fn/(n-f); 0 0 1 0]."""
    c = 1.0 / torch.tan(cam.fov / 2.0)
    n, f = cam.near, cam.far
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, z, z]),
        torch.stack([z, c, z, z]),
        torch.stack([z, z, -(f + n) / (n - f), (2 * f * n) / (n - f)]),
        torch.stack([z, z, one, z]),
    ])


def device_transform(height, *, device,
                     dtype=torch.float32) -> torch.Tensor:
    """Pixel-scale transform diag(h/2, h/2, 1, 1)."""
    h = torch.as_tensor(height, dtype=dtype, device=device) / 2.0
    one = torch.ones_like(h)
    return torch.diag(torch.stack([h, h, one, one]))


def cam_matrix(cam: Camera, height) -> torch.Tensor:
    """Inverse of device @ projection @ view: the one 4x4 that unprojects
    pixel-centered coordinates back to world space."""
    dev = device_transform(height, device=cam.position.device,
                           dtype=cam.position.dtype)
    proj = projection_transform(cam)
    view = camera_transform(cam)
    return mat_inverse(mat_multiply(mat_multiply(dev, proj), view))


def _transform_point(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Projective transform with perspective divide. m: [4, 4];
    x: [..., 3] -> [..., 3]."""
    num = vm.dot(x[..., None, :], m[:3, :3]) + m[:3, 3]
    den = vm.dot(x, m[3, :3]) + m[3, 3]
    return num / den[..., None]


def generate_rays(cam_inv: torch.Tensor, width: int, height: int):
    """Primary-ray origins/directions for a width x height pixel grid.

      origin_i = cam_inv[i, 2] / cam_inv[3, 2]
      ncp/fcp  = unproject((px - W/2, py - H/2, -1/+1))
      dir      = normalize(fcp - ncp)

    Returns (origins [H*W, 3], dirs [H*W, 3]) flattened row-major, so pixel
    (x, y) is element y*W + x.
    """
    dtype, device = cam_inv.dtype, cam_inv.device
    xs = torch.arange(width, dtype=dtype, device=device) - width / 2.0
    ys = torch.arange(height, dtype=dtype, device=device) - height / 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")              # [H, W]
    pix = torch.stack([px, py], dim=-1).reshape(-1, 2)          # [H*W, 2]

    origin = cam_inv[:3, 2] / cam_inv[3, 2]
    ones = torch.ones((pix.shape[0], 1), dtype=dtype, device=device)
    ncp = _transform_point(cam_inv, torch.cat([pix, -ones], dim=-1))
    fcp = _transform_point(cam_inv, torch.cat([pix, ones], dim=-1))
    dirs = vm.normalize(fcp - ncp)
    origins = origin.expand_as(dirs)
    return origins, dirs


def generate_rays_jittered(cam_inv: torch.Tensor, width: int, height: int,
                           jitter: torch.Tensor):
    """generate_rays with per-ray subpixel offsets: jitter [S, H*W, 2] in
    [0, 1)^2, one set per sample. Returns (origins [S, H*W, 3], dirs
    [S, H*W, 3])."""
    dtype, device = cam_inv.dtype, cam_inv.device
    xs = torch.arange(width, dtype=dtype, device=device) - width / 2.0
    ys = torch.arange(height, dtype=dtype, device=device) - height / 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py], dim=-1).reshape(-1, 2)[None] + jitter

    origin = cam_inv[:3, 2] / cam_inv[3, 2]
    z = torch.ones(pix.shape[:-1] + (1,), dtype=dtype, device=device)
    ncp = _transform_point(cam_inv, torch.cat([pix, -z], dim=-1))
    fcp = _transform_point(cam_inv, torch.cat([pix, z], dim=-1))
    dirs = vm.normalize(fcp - ncp)
    return origin.expand_as(dirs), dirs
