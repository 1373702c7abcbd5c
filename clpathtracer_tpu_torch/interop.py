"""State carried across from the JAX package.

Each function takes the JAX package's state as numpy arrays (np.asarray
of its fields) and builds the port's object on `device`, so that both
packages can compute on identical inputs. The JAX package's TPU layouts
become the port's flat ones: [R, 128] rows of eight 16-float records
become [S, 16] records, f32-exact ids become int32.
"""

from __future__ import annotations

import numpy as np
import torch

from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops.plist import MortonWindows
from clpathtracer_tpu_torch.scene.scene import Scene


def scene_from_numpy(verts, faces, normals, albedo, emission,
                     shade_rows=None, *, device) -> Scene:
    """Scene from clpathtracer_tpu.scene.scene.Scene's arrays."""
    scene = Scene.create(verts, faces, normals, albedo, emission,
                         device=device)
    if shade_rows is not None:
        scene = scene.replace(shade_rows=torch.as_tensor(
            np.array(shade_rows, np.float32), device=device))
    return scene


def windows_from_numpy(tris128, win_bnd, so_base, resolve_rows, slot_of_tri,
                       win_rows: int, *, device) -> MortonWindows:
    """MortonWindows from clpathtracer_tpu.ops.plist.MortonWindows' arrays:
    tris128 [R, 128], win_bnd [W, 8], so_base [4, R, 128] or None,
    resolve_rows [ceil(S/4), 128] or None, slot_of_tri [T]."""
    tris = np.asarray(tris128, np.float32).reshape(-1, 16)
    s = tris.shape[0]

    def dev(x):  # a writable contiguous copy: JAX's host views are read-only
        return torch.as_tensor(np.array(x), device=device)
    return MortonWindows(
        tris=dev(tris),
        tri_id=dev(tris[:, 9].astype(np.int32)),
        win_bnd=dev(np.asarray(win_bnd, np.float32)[:, :6]),
        slot_of_tri=dev(np.asarray(slot_of_tri, np.int32)),
        so_base=(None if so_base is None else dev(
            np.asarray(so_base, np.float32).reshape(4, -1, 16)[:, :s])),
        resolve_rows=(None if resolve_rows is None else
                      dev(np.asarray(resolve_rows, np.float32)
                          .reshape(-1, 32)[:s])),
        win_rows=int(win_rows))


def camera_from_numpy(position, forward, fov, near, far, *,
                      device) -> Camera:
    """Camera from clpathtracer_tpu.core.camera.Camera's fields, taken as
    they are (forward is already unit length there)."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    return Camera(near=f32(near), far=f32(far), fov=f32(fov),
                  position=f32(position), forward=f32(forward))
