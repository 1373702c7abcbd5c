"""8-wide supernode collapse of the binary kd-tree (the port's copy of
clpathtracer_tpu/accel/wide.py), the node table of the wide packet walk
(ops/packet.py::packet_wide, kernel K9).

One supernode holds up to 8 binary descendants, reached by greedily
expanding internal nodes (about 3 levels), as one row of 128 f32, 16 per
child slot:

  0:3 child AABB min | 3:6 max | 6 kind (0 empty, 1 internal, 2 leaf)
  7 index (supernode row of an internal child; quad-row start of a leaf)
  8 leaf triangle count | 9:16 pad

One pop of the walk then replaces about 3 levels of binary pops.
"""

from __future__ import annotations

import numpy as np

WIDE_EMPTY = 0.0
WIDE_INTERNAL = 1.0
WIDE_LEAF = 2.0


def build_wide_table(tree) -> np.ndarray:
    """accel/sah.py::FlatKdTree (tri_block=4) -> [S, 128] f32 supernode
    table, host numpy. Row 0 is the root supernode; rows follow in
    preorder. Leaf children carry quad-row starts (leaf_start // 4) and
    triangle counts, as the leaf stream reads them.

    The greedy expansion takes, while fewer than 8 children are found,
    the internal frontier node of the largest AABB surface, the first of
    equal surfaces, and replaces it by its two children at the frontier's
    end. Array-exact against the JAX package's build_wide_table."""
    table = tree.node_table.cpu().numpy()
    is_leaf = tree.is_leaf.cpu().numpy()
    nmin = table[:, 0:3]
    nmax = table[:, 3:6]
    cl = table[:, 8].astype(np.int32)
    ch = table[:, 9].astype(np.int32)
    leaf_start = tree.leaf_start.cpu().numpy()
    leaf_count = tree.leaf_count.cpu().numpy()
    rows = []

    def collect_children(node):
        if is_leaf[node]:
            return [node]
        frontier = [cl[node], ch[node]]
        while len(frontier) < 8:
            pick, best = -1, -1.0
            for i, f in enumerate(frontier):
                if not is_leaf[f]:
                    ext = nmax[f] - nmin[f]
                    s = ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0]
                    if s > best:
                        best, pick = s, i
            if pick < 0:
                break
            f = frontier.pop(pick)
            frontier.extend([cl[f], ch[f]])
        return frontier

    # recursion depth: the supernode depth, below the builder's max_depth
    def emit(node):
        idx = len(rows)
        row = np.zeros(128, np.float32)
        rows.append(row)
        for k, c in enumerate(collect_children(node)):
            base = k * 16
            row[base:base + 3] = nmin[c]
            row[base + 3:base + 6] = nmax[c]
            if is_leaf[c]:
                row[base + 6] = WIDE_LEAF
                row[base + 7] = float(leaf_start[c] // 4)
                row[base + 8] = float(leaf_count[c])
            else:
                row[base + 6] = WIDE_INTERNAL
                row[base + 7] = float(emit(c))
        return idx

    emit(0)
    return np.stack(rows)
