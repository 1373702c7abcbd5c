"""A fractal heightfield: the arithmetic of clpathtracer_tpu_torch/scene/
procedural.py::terrain_mesh, frozen. A g x g grid over [-extent,
extent]^2 in x/z, five sine-cosine octaves of height, two triangles a
cell wound to face +y; emissive_frac of the triangles emit 5.

The octave phases come from the spec's shape_seed, the emitters from the
run's seed: every seed then renders the same surface, so that the seed
reorders the work and does not change it (terrain_mesh draws both from
one generator; with shape_seed equal to the seed the arrays are its)."""

from __future__ import annotations

import numpy as np


def make(spec: dict, seed: int) -> dict:
    num_tris, extent = int(spec["num_tris"]), float(spec["extent"])
    relief = float(spec["relief"])
    emissive_frac = float(spec.get("emissive_frac", 0.0))
    g = max(2, int(np.sqrt(num_tris / 2.0)) + 1)
    shape_seed = int(spec.get("shape_seed", seed))
    r = np.random.default_rng(shape_seed)
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
    faces = np.concatenate([np.stack([v00, v01, v10], axis=1),
                            np.stack([v10, v01, v11], axis=1)],
                           axis=0).astype(np.int32)
    emission = np.zeros((len(faces), 3), np.float32)
    if shape_seed != seed:
        r = np.random.default_rng(seed)
    if emissive_frac > 0:
        n_lit = max(1, int(len(faces) * emissive_frac))
        emission[r.choice(len(faces), n_lit, replace=False)] = 5.0
    return {"verts": verts, "faces": faces, "emission": emission}
