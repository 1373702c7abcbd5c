"""Shading building blocks (the slice's part of
clpathtracer_tpu/render/shading.py)."""

from __future__ import annotations

import torch


def normal_color(normal: torch.Tensor) -> torch.Tensor:
    """The reference's normals-as-color visualization."""
    return (normal + 1.0) / 2.0
