"""On-disk acceleration-structure cache and model loading (the port's
counterpart of clpathtracer_tpu/scene/cache.py).

The reference serializes its built kd-tree as raw length-prefixed C
structs to `<model>.kd` next to the OBJ (src/kd_tree.c:239-274) and
reloads it by extension dispatch in LoadModel (src/model.c:147-176,
src/kd_tree.c:278-311), skipping parse and build. Here, as in the JAX
package, the cache is one `.npz` of named arrays: the tree's and the
scene's.

The port's cache is `<model>.torch.kd.npz` (CACHE_SUFFIX): the port's
flat layouts ([T, 16] records, [M, 24] node table, [W, 6] window boxes)
under a `format` entry that names them (CACHE_FORMAT), and the build
parameters. The JAX package writes `<model>.kd.npz` with its TPU layouts
and no `format` entry; the port reads such a file (any `.npz` without
the entry) through interop.py's conversions, and never writes one.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Iterable, Tuple

import numpy as np
import torch

from clpathtracer_tpu_torch.accel.sah import (CHUNK_ROWS, FlatKdTree,
                                              build_kd_tree)
from clpathtracer_tpu_torch.scene.scene import Scene

CACHE_SUFFIX = ".torch.kd.npz"   # the reference's <model>.kd, src/model.c:22
JAX_CACHE_SUFFIX = ".kd.npz"     # the JAX package's cache, read only
CACHE_FORMAT = "clpathtracer_tpu_torch/flat-v1"

_TREE_FIELDS = ("node_table", "tri_indices", "node_min", "node_max",
                "is_leaf", "leaf_start", "leaf_count", "tris", "chunk_start",
                "chunk_bnd", "wide_table")
_TREE_INTS = ("max_leaf_tris", "tri_block")
_SCENE_FIELDS = ("verts", "faces", "normals", "albedo", "emission",
                 "sphere_pos", "sphere_radius", "sphere_albedo",
                 "sphere_emission", "shade_rows")


def _stage(timer, name, device):
    """timer.stage(name, device), or a no-op scope without a timer."""
    return (contextlib.nullcontext() if timer is None
            else timer.stage(name, device))


def save_scene_cache(path: str, scene: Scene, tree: FlatKdTree,
                     build_params: dict = None) -> None:
    """Serialize scene + built tree in the port's layout (reference:
    src/kd_tree.c:239-274). build_params (tri_block, max_depth,
    leaf_size, chunk_rows) are stored so that a cache hit can be refused
    when the caller asks for a differently built tree."""
    arrays = {"format": np.array(CACHE_FORMAT)}
    for f in _TREE_FIELDS:
        val = getattr(tree, f)
        if val is not None:
            arrays["tree_" + f] = val.cpu().numpy()
    for f in _TREE_INTS:
        arrays["tree_" + f] = np.array(int(getattr(tree, f)))
    for f in _SCENE_FIELDS:
        val = getattr(scene, f)
        if val is not None:
            arrays["scene_" + f] = val.cpu().numpy()
    if build_params:
        arrays["build_params"] = np.array(
            [f"{k}={v}" for k, v in sorted(build_params.items())],
            dtype=np.str_)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def cache_build_params(path: str):
    """The build-params record stored in a cache file (None when the file
    has none)."""
    with np.load(path) as z:
        if "build_params" not in z:
            return None
        return dict(kv.split("=", 1) for kv in z["build_params"].tolist())


def load_scene_cache(path: str, *, device) -> Tuple[Scene, FlatKdTree]:
    """Deserialize a cache onto `device` (reference: parse_kd,
    src/kd_tree.c:278-311): the port's own, or a JAX package's cache
    (no `format` entry), converted by interop.py."""
    with np.load(path) as z:
        if "format" not in z:
            return _load_jax_cache(z, device)
        fmt = str(z["format"])
        if fmt != CACHE_FORMAT:
            raise ValueError(f"{path}: cache format {fmt!r}, this port "
                             f"reads {CACHE_FORMAT!r}")

        def dev(name):
            return torch.as_tensor(z[name], device=device)
        tree = FlatKdTree(
            **{f: dev("tree_" + f) for f in _TREE_FIELDS
               if "tree_" + f in z},
            **{f: int(z["tree_" + f]) for f in _TREE_INTS})
        scene = Scene(**{f: dev("scene_" + f) for f in _SCENE_FIELDS
                         if "scene_" + f in z})
    return scene, tree


def _load_jax_cache(z, device) -> Tuple[Scene, FlatKdTree]:
    """The JAX package's cache (clpathtracer_tpu/scene/cache.py::
    save_scene_cache) as the port's scene and tree: a quad tree
    (tri_block 4, node_table present) through interop.tree_from_numpy,
    a column tree of another tri_block through kd_tree_from_numpy."""
    from clpathtracer_tpu_torch.interop import (kd_tree_from_numpy,
                                                scene_from_numpy,
                                                tree_from_numpy)
    scene = scene_from_numpy(**{f: z["scene_" + f] for f in _SCENE_FIELDS
                                if "scene_" + f in z}, device=device)
    if "tree_node_table" in z:
        tree = tree_from_numpy(
            z["tree_node_table"], z["tree_tri_indices"], z["tree_quads"],
            chunk_start=z["tree_chunk_start"] if "tree_chunk_start" in z
            else None,
            chunk_bnd=z["tree_chunk_bnd"] if "tree_chunk_bnd" in z else None,
            max_leaf_tris=int(np.asarray(z["tree_leaf_count"]).max(initial=0)),
            wide_table=z["tree_wide_table"] if "tree_wide_table" in z
            else None, device=device)
        return scene, tree
    params = (dict(kv.split("=", 1) for kv in z["build_params"].tolist())
              if "build_params" in z else {})
    tri_block = int(params.get("tri_block", 1))
    cols = ("node_min", "node_max", "is_leaf", "split_axis", "split_value",
            "child_lo", "child_hi", "leaf_start", "leaf_count", "ropes",
            "tri_indices")
    tree = kd_tree_from_numpy(**{c: z["tree_" + c] for c in cols},
                              tri_verts=scene.tri_corners(),
                              tri_block=tri_block, device=device)
    return scene, tree


def load_model(path: str, tri_block: int = 4, max_depth: int = 24,
               leaf_size: int = 4, use_cache: bool = True, *, device,
               timer=None, **material_kwargs) -> Tuple[Scene, FlatKdTree]:
    """Load a model by extension dispatch onto `device`, building and
    caching the kd-tree.

    Mirrors LoadModel (src/model.c:147-176): `.obj` -> parse, build the
    tree, write `<model>.torch.kd.npz`; `.npz` -> load that cache (the
    port's or a JAX one) directly; `.kd` -> the reference's own format,
    whose scene is taken and a packed tree built. Unknown extensions
    raise ValueError listing the supported types (the reference prints
    them, src/model.c:162-174). timer: an optional utils/profiling.py::
    StageTimer, which gets the stages "parse", "kd build", "cache write"
    or "cache load"."""
    if path.endswith(".npz"):
        with _stage(timer, "cache load", device):
            return load_scene_cache(path, device=device)
    if path.endswith(".kd"):
        from clpathtracer_tpu_torch.scene.kdformat import load_reference_kd
        with _stage(timer, "parse", device):
            scene, _ref_tree = load_reference_kd(path, device=device)
            scene = scene.bake_shading()
        with _stage(timer, "kd build", device):
            tree = build_kd_tree(scene.tri_corners(), max_depth=max_depth,
                                 leaf_size=leaf_size, tri_block=tri_block,
                                 device=device)
        return scene, tree
    if not path.endswith(".obj"):
        raise ValueError(
            f"{path}: unsupported file type; supported: .obj, .kd, "
            f"{CACHE_SUFFIX}, {JAX_CACHE_SUFFIX}")

    params = {"tri_block": tri_block, "max_depth": max_depth,
              "leaf_size": leaf_size,
              # the window grid is baked into the cached tree's tables
              # (accel/sah.py::attach_chunk_info): a retune invalidates it
              "chunk_rows": CHUNK_ROWS}
    cache = path[:-len(".obj")] + CACHE_SUFFIX
    if use_cache and os.path.exists(cache) and (
            os.path.getmtime(cache) >= os.path.getmtime(path)):
        # a hit only when the tree was built with the same parameters
        if cache_build_params(cache) == {k: str(v)
                                         for k, v in params.items()}:
            with _stage(timer, "cache load", device):
                return load_scene_cache(cache, device=device)

    with _stage(timer, "parse", device):
        scene = Scene.from_obj(path, device=device,
                               **material_kwargs).bake_shading()
    with _stage(timer, "kd build", device):
        tree = build_kd_tree(scene.tri_corners(), max_depth=max_depth,
                             leaf_size=leaf_size, tri_block=tri_block,
                             device=device)
    if use_cache:
        with _stage(timer, "cache write", None):
            save_scene_cache(cache, scene, tree, build_params=params)
    return scene, tree


def merge_scenes(scenes: Iterable[Scene]) -> Scene:
    """Concatenate scenes into one (N-mesh support: the reference only
    ever uploads models[0] and silently drops the rest,
    src/CLState.c:130). As in the JAX package the merged scene carries no
    baked shading rows."""
    scenes = list(scenes)
    if not scenes:
        raise ValueError("merge_scenes needs at least one scene")
    if len(scenes) == 1:
        return scenes[0]
    faces = []
    v_off = n_off = 0
    for s in scenes:
        f = s.faces.clone()
        f[:, :, 0] += v_off
        # normal indices: shift only valid (>= 0) entries
        nidx = f[:, :, 1]
        f[:, :, 1] = torch.where(nidx >= 0, nidx + n_off, -1)
        faces.append(f)
        v_off += s.verts.shape[0]
        n_off += s.normals.shape[0]

    def cat(field):
        return torch.cat([getattr(s, field) for s in scenes])
    return Scene(verts=cat("verts"), faces=torch.cat(faces),
                 normals=cat("normals"), albedo=cat("albedo"),
                 emission=cat("emission"), sphere_pos=cat("sphere_pos"),
                 sphere_radius=cat("sphere_radius"),
                 sphere_albedo=cat("sphere_albedo"),
                 sphere_emission=cat("sphere_emission"))


def load_models(paths: Iterable[str], tri_block: int = 4, *, device,
                timer=None, **kwargs) -> Tuple[Scene, FlatKdTree, list]:
    """Load several models into one merged scene and one tree over all of
    them, on `device`. A model that fails to load is skipped with a
    warning, not fatal (reference behavior, src/game.c:254-256). Returns
    (scene, tree, skipped_paths).

    As in the JAX package, the returned tree is built again from the
    (merged) scene with build_kd_tree's defaults, depth DEFAULT_DEPTH
    (15) and leaf 1, and `tri_block`: max_depth and leaf_size in kwargs
    shape only the cached tree of each model (timer stage "kd rebuild")."""
    scenes = []
    skipped = []
    for p in paths:
        try:
            s, _ = load_model(p, tri_block=tri_block, device=device,
                              timer=timer, **kwargs)
            scenes.append(s)
        except (OSError, ValueError) as e:  # skip-bad-asset
            print(f"warning: skipping {p}: {e}", file=sys.stderr)
            skipped.append(p)
    if not scenes:
        raise ValueError("no loadable models")
    scene = merge_scenes(scenes)
    with _stage(timer, "kd rebuild", device):
        tree = build_kd_tree(scene.tri_corners(), tri_block=tri_block,
                             device=device)
    return scene, tree, skipped
