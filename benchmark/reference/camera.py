"""The pinhole camera's rays for chosen pixels (the reference's camera.c
chain as clpathtracer_tpu_torch/core/camera.py computes it, frozen): a
horizon-locked view frame, an OpenGL-style perspective, a pixel-scale
device transform, composed and inverted; a pixel's ray unprojects its
centred coordinates at the near and far planes."""

from __future__ import annotations

import torch


def _normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def cam_inverse(position, forward, height: int, fov: float, near: float = 0.1,
                far: float = 1.0, device="cpu"):
    """inverse(device @ projection @ view) as a float64 [4, 4]."""
    f64 = dict(dtype=torch.float64, device=device)
    p = torch.as_tensor(position, **f64)
    f = _normalize(torch.as_tensor(forward, **f64))
    left = _normalize(torch.stack([f[2], torch.zeros_like(f[2]), -f[0]]))
    up = torch.linalg.cross(f, left)
    view = torch.eye(4, **f64)
    view[:3, :3] = torch.stack([left, up, f])
    view[:3, 3] = -(view[:3, :3] @ p)
    c = 1.0 / torch.tan(torch.tensor(fov / 2.0, **f64))
    proj = torch.zeros((4, 4), **f64)
    proj[0, 0] = proj[1, 1] = c
    proj[2, 2] = -(far + near) / (near - far)
    proj[2, 3] = 2.0 * far * near / (near - far)
    proj[3, 2] = 1.0
    dev = torch.diag(torch.tensor([height / 2.0, height / 2.0, 1.0, 1.0],
                                  **f64))
    return torch.linalg.inv(dev @ proj @ view)


def _unproject(m, x):
    num = x @ m[:3, :3].T + m[:3, 3]
    den = x @ m[3, :3] + m[3, 3]
    return num / den[:, None]


def pixel_rays(cam_inv, width: int, height: int, pixels, jitter=None):
    """Rays (orig [P, 3], dir [P, 3], float64) of the flat pixel indices
    `pixels` [P] (y * width + x), offset by jitter [P, 2] in [0, 1)^2 when
    given."""
    dev = cam_inv.device
    pix = torch.as_tensor(pixels, device=dev)
    pxy = torch.stack([(pix % width).double() - width / 2.0,
                       (pix // width).double() - height / 2.0], dim=1)
    if jitter is not None:
        pxy = pxy + jitter.double()
    ones = torch.ones((pxy.shape[0], 1), dtype=torch.float64, device=dev)
    ncp = _unproject(cam_inv, torch.cat([pxy, -ones], dim=1))
    fcp = _unproject(cam_inv, torch.cat([pxy, ones], dim=1))
    orig = (cam_inv[:3, 2] / cam_inv[3, 2]).expand(pxy.shape[0], 3)
    return orig, _normalize(fcp - ncp)
