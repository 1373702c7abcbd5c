"""Random small triangles filling a cube, the "fog" scene: the arithmetic
of clpathtracer_tpu_torch/scene/procedural.py::random_tri_soup, frozen.
Centres uniform in [-extent, extent]^3, corners offset by normal draws of
scale tri_size * extent; emissive_frac of the triangles emit 5."""

from __future__ import annotations

import numpy as np


def make(spec: dict, seed: int) -> dict:
    num_tris, extent = int(spec["num_tris"]), float(spec["extent"])
    tri_size = float(spec["tri_size"])
    emissive_frac = float(spec.get("emissive_frac", 0.0))
    r = np.random.default_rng(seed)
    centers = r.uniform(-extent, extent, size=(num_tris, 3)).astype(np.float32)
    offsets = r.normal(scale=tri_size * extent,
                       size=(num_tris, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offsets).reshape(-1, 3)
    faces = np.arange(num_tris * 3, dtype=np.int32).reshape(num_tris, 3)
    emission = np.zeros((num_tris, 3), np.float32)
    if emissive_frac > 0:
        n_lit = max(1, int(num_tris * emissive_frac))
        emission[r.choice(num_tris, n_lit, replace=False)] = 5.0
    return {"verts": verts, "faces": faces, "emission": emission}
