"""Host-side triangle record packing (the slice's part of
clpathtracer_tpu/accel/sah.py)."""

from __future__ import annotations

import numpy as np


def pack_quads_host(tri_indices: np.ndarray,
                    tri_verts: np.ndarray) -> np.ndarray:
    """Triangle records [T, 16] f32: (v0, e1, e2, tri_id, pad 6), one per
    entry of `tri_indices`; an index of -1 gives a pad record with
    tri_id -1 (geometry of triangle 0, never a hit: every consumer
    rejects tri_id < 0).

    The JAX package folds four records into a [T/4, 64] quad row for the
    TPU's lanes; the port keeps the flat [T, 16] records, whose row index
    is the slot that the kernels return."""
    idx = np.asarray(tri_indices)
    safe = np.maximum(idx, 0)
    tv = np.asarray(tri_verts, np.float32)
    a = tv[safe, 0]
    rows16 = np.zeros((idx.shape[0], 16), np.float32)
    rows16[:, 0:3] = a
    rows16[:, 3:6] = tv[safe, 1] - a
    rows16[:, 6:9] = tv[safe, 2] - a
    rows16[:, 9] = idx.astype(np.float32)
    return rows16
