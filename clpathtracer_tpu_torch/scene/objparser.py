"""Wavefront OBJ parser (pure Python/numpy, host side): the port's copy of
clpathtracer_tpu/scene/objparser.py.

Covers the subset the reference consumes from its vendored tinyobj
(reference: src/model.c:91-132, include/tinyobj_loader_c.h:1208): `v`, `vn`,
`vt` records and `f` faces with v / v/vt / v//vn / v/vt/vn forms, fan-
triangulation of n-gons (TINYOBJ_FLAG_TRIANGULATE), negative (relative)
indices, and `o`/`g`/`s`/`usemtl`/`mtllib` records skipped gracefully.

Output is already SoA numpy: verts [V,3] f32, normals [VN,3] f32, and
per-corner index triples faces [F,3,3] i32 with columns (v_idx, vn_idx,
vt_idx); -1 marks an absent index (the reference uses the same sentinel,
src/kernel.cl:349).
"""

from __future__ import annotations

import numpy as np


class ObjParseError(ValueError):
    pass


def _resolve(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices count from the end."""
    if idx > 0:
        return idx - 1
    if idx < 0:
        return count + idx
    raise ObjParseError("OBJ index 0 is invalid")


def _parse_corner(token: str, nv: int, nvt: int, nvn: int):
    """Parse one face corner `v[/vt][/vn]` → (v, vn, vt) with -1 sentinels."""
    parts = token.split("/")
    v = _resolve(int(parts[0]), nv)
    vt = -1
    vn = -1
    if len(parts) >= 2 and parts[1]:
        vt = _resolve(int(parts[1]), nvt)
    if len(parts) >= 3 and parts[2]:
        vn = _resolve(int(parts[2]), nvn)
    return v, vn, vt


def parse_mtl(text: str) -> dict:
    """Parse a Wavefront .mtl file → {name: {"Kd": [3], "Ke": [3]}}.

    The subset that drives shading here: Kd (diffuse albedo) and Ke
    (emission). The reference's vendored tinyobj parses materials too
    (tinyobj_material_t) but its kernel never reads them — this framework
    shades with them (per-face albedo/emission in Scene).
    """
    mats: dict = {}
    cur = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        tokens = line.split()
        tag = tokens[0]
        if tag == "newmtl" and len(tokens) > 1:
            cur = {"Kd": [0.75, 0.75, 0.75], "Ke": [0.0, 0.0, 0.0]}
            mats[tokens[1]] = cur
        elif tag in ("Kd", "Ke") and cur is not None and len(tokens) >= 4:
            cur[tag] = [float(tokens[1]), float(tokens[2]), float(tokens[3])]
    return mats


def parse_obj(text: str, mtl_loader=None):
    """Parse OBJ text → dict of numpy arrays.

    Returns {"verts": [V,3] f32, "normals": [VN,3] f32, "texcoords": [VT,2]
    f32, "faces": [F,3,3] i32 (corner-major: faces[f,c] = (v, vn, vt)),
    "albedo": [F,3] f32, "emission": [F,3] f32}.

    mtl_loader: optional callable name → mtl text, used to resolve
    `mtllib` records (load_obj wires this to sibling-file reads).
    """
    verts: list = []
    normals: list = []
    texcoords: list = []
    corners: list = []  # flat list of (v, vn, vt)
    face_mat: list = []  # material name per emitted triangle
    materials: dict = {}
    cur_mat = None

    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        # line continuation
        while line.endswith("\\"):
            line = line[:-1]
        tokens = line.split()
        tag = tokens[0]
        if tag == "v":
            if len(tokens) < 4:
                raise ObjParseError(f"short vertex record: {raw_line!r}")
            verts.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
        elif tag == "vn":
            if len(tokens) < 4:
                raise ObjParseError(f"short normal record: {raw_line!r}")
            normals.append([float(tokens[1]), float(tokens[2]), float(tokens[3])])
        elif tag == "vt":
            if len(tokens) < 3:
                raise ObjParseError(f"short texcoord record: {raw_line!r}")
            texcoords.append([float(tokens[1]), float(tokens[2])])
        elif tag == "f":
            face = [
                _parse_corner(t, len(verts), len(texcoords), len(normals))
                for t in tokens[1:]
            ]
            if len(face) < 3:
                raise ObjParseError(f"face with <3 corners: {raw_line!r}")
            # fan triangulation, as tinyobj's TINYOBJ_FLAG_TRIANGULATE does
            for k in range(1, len(face) - 1):
                corners.extend([face[0], face[k], face[k + 1]])
                face_mat.append(cur_mat)
        elif tag == "mtllib" and len(tokens) > 1 and mtl_loader is not None:
            for name in tokens[1:]:
                try:
                    materials.update(parse_mtl(mtl_loader(name)))
                except OSError:
                    pass  # missing .mtl is non-fatal (skip-bad-asset)
        elif tag == "usemtl":
            cur_mat = tokens[1] if len(tokens) > 1 else None
        else:
            # o / g / s / l / p — ignored, like the reference ignores
            # everything but geometry.
            continue

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    vn = np.asarray(normals, np.float32).reshape(-1, 3)
    vt = np.asarray(texcoords, np.float32).reshape(-1, 2)
    f = np.asarray(corners, np.int32).reshape(-1, 3, 3)

    if f.size and (np.any(f[..., 0] < 0) or np.any(f[..., 0] >= len(v))):
        raise ObjParseError("face references out-of-range vertex index")
    if f.size and np.any(f[..., 1] >= len(vn)):
        raise ObjParseError("face references out-of-range normal index")

    nf = f.shape[0]
    albedo = np.full((nf, 3), 0.75, np.float32)
    emission = np.zeros((nf, 3), np.float32)
    for i, m in enumerate(face_mat):
        if m is not None and m in materials:
            albedo[i] = materials[m]["Kd"]
            emission[i] = materials[m]["Ke"]
    return {"verts": v, "normals": vn, "texcoords": vt, "faces": f,
            "albedo": albedo, "emission": emission}


def _apply_materials(nf: int, tri_mat, mat_names, mtllib_names, mtl_loader):
    """Resolve mtllib files + per-tri material ids → albedo/emission
    arrays (the Python half of the native parse: file IO and Kd/Ke
    lookup run once per material, not per line)."""
    materials: dict = {}
    if mtl_loader is not None:
        for name in mtllib_names:
            try:
                materials.update(parse_mtl(mtl_loader(name)))
            except OSError:
                pass  # missing .mtl is non-fatal (skip-bad-asset)
    albedo = np.full((nf, 3), 0.75, np.float32)
    emission = np.zeros((nf, 3), np.float32)
    for mid, name in enumerate(mat_names):
        if name in materials:
            sel = tri_mat == mid
            albedo[sel] = materials[name]["Kd"]
            emission[sel] = materials[name]["Ke"]
    return albedo, emission


def load_obj(path: str, native: bool = True):
    """Read and parse an OBJ file (reference entry: src/model.c:74-145),
    resolving `mtllib` records relative to the OBJ's directory.

    native=True runs the C++ scanner (scene/native/, the reference's
    tinyobj analogue), built with g++ at first use: a missing or failing
    g++ raises scene.native.NativeBuildError. On input the scanner
    rejects, the Python parser is the arbiter: its ObjParseError messages
    are the contract. native=False runs the Python parser alone.
    """
    import os
    base = os.path.dirname(os.path.abspath(path))

    def mtl_loader(name):
        with open(os.path.join(base, name), "r", encoding="utf-8",
                  errors="replace") as fh:
            return fh.read()

    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    if not native:
        return parse_obj(text, mtl_loader=mtl_loader)

    from clpathtracer_tpu_torch.scene.native import (NativeObjError,
                                                     parse_obj_native)
    try:
        geo, tri_mat, mats, libs = parse_obj_native(text)
    except NativeObjError:
        return parse_obj(text, mtl_loader=mtl_loader)
    albedo, emission = _apply_materials(
        geo["faces"].shape[0], tri_mat, mats, libs, mtl_loader)
    return {**geo, "albedo": albedo, "emission": emission}
