"""Reader and writer for the reference's binary `.kd` cache format (the
port's counterpart of clpathtracer_tpu/scene/kdformat.py).

The reference serializes its built tree as raw packed C structs
(src/kd_tree.c:239-274): five sections, each a little-endian size_t count
followed by `count` elements:

  1. kdnode[]      68 B packed (include/kd_tree.h:31-50 under
                   #pragma pack(1)): min/max as cl_float4 (16 B each),
                   int type (0 split / 1 leaf), then a 32 B union:
                   split {f32 value, i32 axis, i32 children[2], 16 B pad}
                   or leaf {i32 tris, i32 tri_count, i32 ropes[6]}
  2. cl_float4[]   vertex positions (xyz used)
  3. cl_float4[]   vertex normals
  4. i32[]         tri_indices (concatenated leaf triangle lists)
  5. cl_int3[]     per-corner (v, vn, vt) index triples, 16 B each
                   (cl_int3 is padded to int4), three per triangle

load_reference_kd reads such a file into a Scene and the compact
(tri_block 1) FlatKdTree of the same nodes, ropes included, which the rope
walk takes (ops/traverse.py::traverse); scene/cache.py::load_model builds
a packed tree from the scene for the other routes. save_reference_kd
writes a compact tree back out, unpacking split, children and ropes from
the port's packed node table, byte for byte as the JAX writer writes the
same tree.
"""

from __future__ import annotations

import numpy as np

_NODE_DTYPE = np.dtype([
    ("min", "<f4", (4,)),
    ("max", "<f4", (4,)),
    ("type", "<i4"),
    ("u0", "<i4"), ("u1", "<i4"),
    ("u2", "<i4", (6,)),
], align=False)   # 68 bytes, the packed kdnode


def load_reference_kd(path: str, *, device):
    """Parse a reference `.kd` file -> (Scene, FlatKdTree) on `device`.

    The tree is the reference's exact structure: tri_block 1, the node
    columns, ropes and leaf lists as stored, records packed from the
    file's vertices (accel/sah.py::tree_from_arrays)."""
    from clpathtracer_tpu_torch.accel.sah import tree_from_arrays
    from clpathtracer_tpu_torch.scene.scene import Scene

    with open(path, "rb") as fh:
        data = fh.read()
    buf = memoryview(data)
    off = 0

    def section(dtype):
        nonlocal off
        count = int(np.frombuffer(buf, "<u8", count=1, offset=off)[0])
        off += 8
        arr = np.frombuffer(buf, dtype, count=count, offset=off).copy()
        off += count * np.dtype(dtype).itemsize
        return arr

    nodes = section(_NODE_DTYPE)
    verts4 = section(np.dtype(("<f4", (4,))))
    norms4 = section(np.dtype(("<f4", (4,))))
    tri_indices = section(np.dtype("<i4")).astype(np.int32)
    corners = section(np.dtype(("<i4", (4,))))

    verts = verts4[:, :3]
    normals = norms4[:, :3]
    faces = corners[:, :3].reshape(-1, 3, 3)  # [F, corner, (v, vn, vt)]

    is_leaf = nodes["type"] == 1
    split_value = nodes["u0"].view("<f4").copy()
    split_value[is_leaf] = 0.0
    arrays = {
        "node_min": nodes["min"][:, :3], "node_max": nodes["max"][:, :3],
        "is_leaf": is_leaf,
        "split_axis": np.where(is_leaf, 0, nodes["u1"]).astype(np.int32),
        "split_value": split_value,
        "child_lo": np.where(is_leaf, -1, nodes["u2"][:, 0]).astype(np.int32),
        "child_hi": np.where(is_leaf, -1, nodes["u2"][:, 1]).astype(np.int32),
        "leaf_start": np.where(is_leaf, nodes["u0"], 0).astype(np.int32),
        "leaf_count": np.where(is_leaf, nodes["u1"], 0).astype(np.int32),
        "ropes": np.where(is_leaf[:, None], nodes["u2"], -1).astype(np.int32),
    }
    scene = Scene.create(verts, faces, normals if len(normals) else None,
                         device=device)
    tree = tree_from_arrays(arrays, tri_indices, scene.tri_corners(), 1,
                            device=device)
    return scene, tree


def save_reference_kd(path: str, scene, tree) -> None:
    """Write a `.kd` file the reference renderer can load (parse_kd,
    src/kd_tree.c:278-311). The tree must be compact (no padded leaf
    slot: padded -1 slots would crash the reference's double
    indirection), as build_kd_tree(tri_block=1) builds it."""
    tri_indices = tree.tri_indices.cpu().numpy()
    if (tri_indices < 0).any():
        raise ValueError("tree has padded leaf lists; build with "
                         "tri_block=1 for reference interop")
    table = tree.node_table.cpu().numpy()
    is_leaf = tree.is_leaf.cpu().numpy()
    m = len(is_leaf)
    # the packed table's lanes (ops/traverse_fast.py::pack_node_table)
    split_axis = table[:, 7].astype(np.int32) - 4 * is_leaf.astype(np.int32)
    nodes = np.zeros(m, _NODE_DTYPE)
    nodes["min"][:, :3] = tree.node_min.cpu().numpy()
    nodes["max"][:, :3] = tree.node_max.cpu().numpy()
    nodes["type"] = is_leaf.astype(np.int32)
    sv = np.ascontiguousarray(table[:, 6]).view("<i4")
    nodes["u0"] = np.where(is_leaf, tree.leaf_start.cpu().numpy(), sv)
    nodes["u1"] = np.where(is_leaf, tree.leaf_count.cpu().numpy(),
                           split_axis)
    ch2 = np.zeros((m, 6), np.int32)
    ch2[:, 0:2] = table[:, 8:10].astype(np.int32)
    nodes["u2"] = np.where(is_leaf[:, None],
                           table[:, 12:18].astype(np.int32), ch2)

    v = scene.verts.cpu().numpy()
    verts4 = np.zeros((len(v), 4), "<f4")
    verts4[:, :3] = v
    nrm = scene.normals.cpu().numpy()
    norms4 = np.zeros((len(nrm), 4), "<f4")
    norms4[:, :3] = nrm
    corners = np.full((scene.num_tris * 3, 4), 0, "<i4")
    corners[:, :3] = scene.faces.cpu().numpy().reshape(-1, 3)

    with open(path, "wb") as fh:
        for arr in (nodes, verts4, norms4,
                    tri_indices.astype("<i4"), corners):
            fh.write(np.uint64(len(arr)).tobytes())
            fh.write(arr.tobytes())
