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

from clpathtracer_tpu_torch.accel.grid import UniformGrid
from clpathtracer_tpu_torch.accel.sah import (CHUNK_ROWS, FlatKdTree,
                                              tree_from_arrays)
from clpathtracer_tpu_torch.core.camera import Camera
from clpathtracer_tpu_torch.ops.plist import MortonWindows
from clpathtracer_tpu_torch.scene.scene import Scene


def scene_from_numpy(verts, faces, normals, albedo, emission,
                     shade_rows=None, sphere_pos=None, sphere_radius=None,
                     sphere_albedo=None, sphere_emission=None, *,
                     device) -> Scene:
    """Scene from clpathtracer_tpu.scene.scene.Scene's arrays, spheres
    included."""
    has_spheres = sphere_pos is not None and np.asarray(sphere_pos).size
    scene = Scene.create(
        verts, faces, normals, albedo, emission,
        sphere_pos if has_spheres else None,
        sphere_radius if has_spheres else None,
        sphere_albedo if has_spheres else None,
        sphere_emission if has_spheres else None, device=device)
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


def grid_from_numpy(lo, hi, h, res, table=None, cells=None, quads=None, *,
                    device) -> UniformGrid:
    """UniformGrid from clpathtracer_tpu.accel.grid.UniformGrid's arrays, in
    either layout: table [C + S, 128] (inline), or cells [C, 8] and quads
    [Q, 64] (split); lo, hi, h [3]; res (rx, ry, rz)."""
    if (table is None) == (cells is None or quads is None):
        raise ValueError("grid_from_numpy: give table (inline) or cells and "
                         "quads (split)")

    def dev(x):  # a writable contiguous copy: JAX's host views are read-only
        return None if x is None else torch.as_tensor(
            np.array(x, np.float32), device=device)
    return UniformGrid(lo=dev(lo), hi=dev(hi), h=dev(h), table=dev(table),
                       cells=dev(cells), quads=dev(quads),
                       res=tuple(int(r) for r in res))


def tree_from_numpy(node_table, tri_indices, quads, chunk_start=None,
                    chunk_bnd=None, so_base=None, max_leaf_tris: int = 0,
                    wide_table=None, *, device) -> FlatKdTree:
    """FlatKdTree from clpathtracer_tpu.accel.sah.FlatKdTree's arrays, for
    a tri_block 4 tree (the main tree or its shadow tree): node_table
    [M, 24], tri_indices [T], quads [T/4, 64], chunk_start [M] or None,
    chunk_bnd [ceil(W/16), 128] (8 lanes per window, padded to whole rows
    of 16 windows) or None, so_base [4, R, 128] or None, wide_table
    [S, 128] or None."""
    table = np.array(node_table, np.float32)
    flags = table[:, 7].astype(np.int32)
    leaf_start = table[:, 10].astype(np.int32) * 4
    leaf_count = table[:, 11].astype(np.int32)
    # the window count W: the leaves' windows on the clamped grid
    row0 = leaf_start // 8
    row_end = (leaf_start + leaf_count + 7) // 8
    n_win = int(np.where((flags >= 4) & (leaf_count > 0),
                         (row_end - row0 + CHUNK_ROWS - 1) // CHUNK_ROWS,
                         0).sum())

    def dev(x):  # a writable contiguous copy: JAX's host views are read-only
        return torch.as_tensor(np.array(x), device=device)
    return FlatKdTree(
        node_table=dev(table),
        tri_indices=dev(np.asarray(tri_indices, np.int32)),
        node_min=dev(table[:, 0:3]), node_max=dev(table[:, 3:6]),
        is_leaf=dev(flags >= 4), leaf_start=dev(leaf_start),
        leaf_count=dev(leaf_count),
        tris=dev(np.asarray(quads, np.float32).reshape(-1, 16)),
        chunk_start=(None if chunk_start is None else
                     dev(np.asarray(chunk_start, np.int32))),
        chunk_bnd=(None if chunk_bnd is None else
                   dev(np.asarray(chunk_bnd, np.float32)
                       .reshape(-1, 8)[:n_win, :6])),
        so_base=(None if so_base is None else dev(
            np.asarray(so_base, np.float32).reshape(4, -1, 16))),
        wide_table=(None if wide_table is None else dev(
            np.asarray(wide_table, np.float32))),
        max_leaf_tris=int(max_leaf_tris))


def kd_tree_from_numpy(node_min, node_max, is_leaf, split_axis, split_value,
                       child_lo, child_hi, leaf_start, leaf_count, ropes,
                       tri_indices, tri_verts, tri_block: int, *,
                       device) -> FlatKdTree:
    """FlatKdTree from clpathtracer_tpu.accel.sah.FlatKdTree's column
    arrays (the JAX package's SoA tree, as its Python builder returns it
    for any tri_block): the port's node table and records, packed from the
    same columns and leaf lists, and tri_verts [F, 3, 3]; no window
    tables."""
    arrays = {"node_min": node_min, "node_max": node_max,
              "is_leaf": np.asarray(is_leaf, bool),
              "split_axis": split_axis, "split_value": split_value,
              "child_lo": child_lo, "child_hi": child_hi,
              "leaf_start": np.asarray(leaf_start, np.int32),
              "leaf_count": np.asarray(leaf_count, np.int32),
              "ropes": ropes}
    return tree_from_arrays(arrays, np.asarray(tri_indices, np.int32),
                            np.asarray(tri_verts, np.float32), tri_block,
                            device=device)


def params_from_numpy(params: dict, *, device) -> dict:
    """The port's parameter tensors from the JAX TrainState.params dict
    (field name -> array): float32 leaves on `device` with requires_grad,
    for parallel/train.py::make_train_step's init(params)."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            .requires_grad_(True) for k, v in params.items()}


def camera_from_numpy(position, forward, fov, near, far, *,
                      device) -> Camera:
    """Camera from clpathtracer_tpu.core.camera.Camera's fields, taken as
    they are (forward is already unit length there)."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)
    return Camera(near=f32(near), far=f32(far), fov=f32(fov),
                  position=f32(position), forward=f32(forward))
