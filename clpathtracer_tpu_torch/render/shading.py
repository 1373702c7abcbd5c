"""Shading building blocks (the slice's part of
clpathtracer_tpu/render/shading.py)."""

from __future__ import annotations

import math

import torch

from clpathtracer_tpu_torch.core import vecmath as vm


def normal_color(normal: torch.Tensor) -> torch.Tensor:
    """The reference's normals-as-color visualization."""
    return (normal + 1.0) / 2.0


def cosine_sample_hemisphere(normal: torch.Tensor, u1: torch.Tensor,
                             u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction about `normal` [N, 3] from the uniforms
    u1, u2 [N], in a branchless Frisvad-style basis."""
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx ** 2 * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny ** 2 * a, -ny], dim=-1)
    return vm.normalize(
        x[..., None] * t1 + y[..., None] * t2 + z[..., None] * normal,
        eps=1e-30)
