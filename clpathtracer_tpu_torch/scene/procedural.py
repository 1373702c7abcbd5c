"""Procedural scenes, generated on the host with numpy.

Port of the slice's part of clpathtracer_tpu/scene/procedural.py: the
numpy arithmetic is the JAX package's own, so the same seed gives the
same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

from clpathtracer_tpu_torch.scene.scene import Scene


def random_tri_soup(num_tris: int, seed: int = 0, extent: float = 10.0,
                    tri_size: float = 0.05, emissive_frac: float = 0.0, *,
                    device) -> Scene:
    """num_tris random small triangles in a [-extent, extent]^3 cube: the
    adversarial "fog" scene. emissive_frac > 0 marks that fraction of the
    triangles as emitters (emission 5)."""
    r = np.random.default_rng(seed)
    centers = r.uniform(-extent, extent, size=(num_tris, 3)).astype(np.float32)
    offsets = r.normal(scale=tri_size * extent,
                       size=(num_tris, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offsets).reshape(-1, 3)
    idx = np.arange(num_tris * 3, dtype=np.int32).reshape(num_tris, 3)
    f = np.full((num_tris, 3, 3), -1, np.int32)
    f[:, :, 0] = idx
    emission = None
    if emissive_frac > 0:
        emission = np.zeros((num_tris, 3), np.float32)
        n_lit = max(1, int(num_tris * emissive_frac))
        lit = r.choice(num_tris, n_lit, replace=False)
        emission[lit] = 5.0
    return Scene.create(verts, f, emission=emission, device=device)


def terrain_mesh(num_tris: int, seed: int = 0, extent: float = 10.0,
                 relief: float = 2.5, emissive_frac: float = 0.0, *,
                 device) -> Scene:
    """~num_tris-triangle fractal heightfield: a (g x g) grid over
    [-extent, extent]^2 in x/z with multi-octave sine/cosine heights, two
    triangles per cell, windings facing +y so a camera above sees front
    faces."""
    g = max(2, int(np.sqrt(num_tris / 2.0)) + 1)
    r = np.random.default_rng(seed)
    xs = np.linspace(-extent, extent, g, dtype=np.float32)
    zs = np.linspace(-extent, extent, g, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = np.zeros_like(x)
    for octave in range(5):
        f = (2.0 ** octave) * np.pi / extent
        px, pz = r.uniform(0, 2 * np.pi, 2)
        amp = relief / (2.0 ** octave)
        y += amp * np.sin(f * x + px) * np.cos(f * z + pz)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    i, j = np.meshgrid(np.arange(g - 1), np.arange(g - 1), indexing="ij")
    v00 = (i * g + j).ravel()
    v10 = ((i + 1) * g + j).ravel()
    v01 = (i * g + j + 1).ravel()
    v11 = ((i + 1) * g + j + 1).ravel()
    tris = np.concatenate([
        np.stack([v00, v01, v10], axis=1),
        np.stack([v10, v01, v11], axis=1),
    ], axis=0).astype(np.int32)
    f = np.full((len(tris), 3, 3), -1, np.int32)
    f[:, :, 0] = tris
    emission = None
    if emissive_frac > 0:
        emission = np.zeros((len(tris), 3), np.float32)
        n_lit = max(1, int(len(tris) * emissive_frac))
        lit = r.choice(len(tris), n_lit, replace=False)
        emission[lit] = 5.0
    return Scene.create(verts, f, emission=emission, device=device)


def two_triangles(*, device) -> Scene:
    """Minimal 2-triangle fixture for unit tests."""
    v = np.array([
        [-1, -1, 2], [1, -1, 2], [0, 1, 2],     # facing -z
        [-1, -1, 4], [1, -1, 4], [0, 1, 4],
    ], np.float32)
    tris = np.array([[0, 2, 1], [3, 5, 4]], np.int32)
    f = np.full((2, 3, 3), -1, np.int32)
    f[:, :, 0] = tris
    return Scene.create(v, f, device=device)
