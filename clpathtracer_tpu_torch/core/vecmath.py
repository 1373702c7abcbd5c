"""Batched 3-vector math over trailing-axis-3 tensors.

Port of clpathtracer_tpu/core/vecmath.py. Sums of three products are
written out left to right so that the CPU and the GPU round them in the
same order.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis. Keeps leading axes."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the trailing axis: divide by the exact length when
    eps=0 (the reference's vec_normalize); with eps>0, vectors whose
    squared length is at most eps map to zero."""
    if eps:
        n2 = length_squared(a)
        ok = n2 > eps
        inv_len = torch.where(ok, torch.rsqrt(torch.where(ok, n2, 1.0)), 0.0)
        return a * inv_len[..., None]
    return a / length(a)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def vmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def vmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction d about normal n."""
    return normalize(d - 2.0 * dot(d, n)[..., None] * n)
