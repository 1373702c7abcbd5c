"""Hand-built edge waves of the kd walk W1's split-leaf rule and the
brute force W2's tie rule: small scenes and rays whose winners and steps
follow from where the triangles sit. chip_smoke.py runs them through the
kernels on the card and tests/test_torch_walk_edges.py through the plain
versions and the JAX package on the CPU; host numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from clpathtracer_tpu_torch.ops.traverse_fast import BIG, _mt_pre

# Hand-built edge waves of W1's split-leaf rule: a kd-tree of one leaf
# (EDGE_LEAF triangles; a leaf of at most 128 records keeps its build
# order, so record j is triangle j) and a two-leaf tree, rays whose
# winners and steps follow from where their triangles sit.
EDGE_LEAF = 70      # records of the one leaf: not a multiple of 16, 32 or 64
EDGE_DIR = (1e-3, -1.0, 2e-3)   # near-vertical, no component exactly 0
# the one leaf's columns: rays straight down through (2 k, 0); triangle
# id -> height (equal heights: identical triangles, equal t)
EDGE_COLUMNS = (
    {1: 1.0, 6: 1.0},             # a tie across blocks 0 and 1
    {8: 1.0, 9: 1.0},             # a tie inside block 2
    {5: 1.0, 66: 1.0},            # a tie across chunks (blocks 1 and 16)
    {2: 0.5, 13: 1.5, 50: 1.2},   # the first block's hit is not the nearest
    {20: 0.8, 23: 1.3, 30: 1.8},  # two hits in block 5, a nearer one later
    {3: 0.7, 45: 1.6, 69: 1.9},   # hits before and after a mid-leaf cap;
                                  # 69 in the last, partial block
    {60: 1.0},                    # the t_max cases
)
# per wave form: the winner of each column (-1: none) and its steps; the
# forms without a cap add lanes (walk_edge_cases)
EDGE_WANT = {
    "nearest": ((6, 9, 66, 13, 30, 69, 60), (18,) * 7),
    "t_max": ((6, 9, 66, 13, 30, 69, 60), (18,) * 7),
    "any-hit": ((1, 9, 5, 2, 23, 3, 60), (1, 3, 2, 1, 6, 1, 16)),
    "cap 10": ((6, 9, 5, 13, 30, 3, -1), (10,) * 7),
    "cap 12": ((6, 9, 5, 13, 30, 45, -1), (12,) * 7),
    "any-hit cap 4": ((1, 9, 5, 2, -1, 3, -1), (1, 3, 2, 1, 4, 1, 4)),
}


def _edge_tri(x0, y, z0, x1=None, z1=None, size=0.8):
    """A horizontal triangle at height y, corners (x0, z0), (x1, z0), (x0,
    z1) (x1 = x0 + size, z1 = z0 + size by default), wound so that a ray
    going down meets its front face (Moller-Trumbore's det > 0)."""
    x1 = x0 + size if x1 is None else x1
    z1 = z0 + size if z1 is None else z1
    return np.array([[x0, y, z0], [x0, y, z1], [x1, y, z0]], np.float32)


def _edge_rays(xz, y=5.0):
    o = np.array([[x + 0.2, y, z + 0.2] for x, z in xz], np.float32)
    d = np.tile(np.asarray(EDGE_DIR, np.float32), (len(xz), 1))
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def edge_tri_t(tv, tri, o, d):
    """The t at which each ray (o, d [K, 3]) meets triangle tri[k] of tv,
    by the walk's own Moller-Trumbore (float32, one rounding an op)."""
    v = torch.as_tensor(tv[tri])
    _, t, _, _ = _mt_pre(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0],
                         torch.as_tensor(o), torch.as_tensor(d))
    return t.numpy()


def walk_edge_cases():
    """W1's hand-built edge waves, host numpy. Returns a list of (name,
    tri_verts [F, 3, 3], build (max_depth, leaf_size for the Python
    builder at tri_block 4), wave (orig, dir and traverse_fast's keyword
    arguments: t_max, active, any_hit, max_iters), want (slot, steps,
    t: [K] each)).

    One leaf of EDGE_LEAF triangles: a column of triangles per ray
    (EDGE_COLUMNS), the rest off to the side, in every form of EDGE_WANT.
    The nearest wave adds a dead lane and two misses of the root box (a ray
    going up, a ray beside the box): no step. The t_max and any-hit waves
    (t_max 100) add two rays at triangle 60 with t_max its exact t (missed:
    t < t_max is strict) and one ulp above (hit). Two leaves (a split at
    depth 1): a triangle that straddles the split lies in both leaves, and
    the ray meets it in the first and again in the second: the second
    leaf's record wins (<=), after 1 + 3 + 3 steps."""
    tris = [_edge_tri(30.0 + i % 10, 1.0, 5.0 + i // 10)
            for i in range(EDGE_LEAF)]
    xz = []
    for c, col in enumerate(EDGE_COLUMNS):
        for i, y in col.items():
            tris[i] = _edge_tri(2.0 * c, y, 0.0)
        xz.append((2.0 * c, 0.0))
    tv = np.stack(tris)
    leaf = dict(max_depth=0, leaf_size=EDGE_LEAF)
    o, d = _edge_rays(xz)
    k = len(xz)
    # the extra lanes: dead, going up, beside the box; two at triangle 60
    o_x = np.concatenate([o[:1], o[:1], [[-50.0, 5.0, -50.0]]]).astype(
        np.float32)
    d_x = np.concatenate([d[:1], -d[:1], d[:1]]).astype(np.float32)
    g = np.array([6, 6])
    t60 = edge_tri_t(tv, np.array([60, 60]), o[g], d[g])
    tm60 = np.array([t60[0], np.nextafter(t60[1], np.float32(np.inf))],
                    np.float32)
    cases = []
    for form, (slot, steps) in EDGE_WANT.items():
        wave = dict(orig=o, dir=d)
        slot, steps = np.asarray(slot, np.int32), np.asarray(steps, np.int32)
        if form == "nearest":
            wave = dict(orig=np.concatenate([o, o_x]),
                        dir=np.concatenate([d, d_x]),
                        active=np.arange(k + 3) != k)
            slot = np.concatenate([slot, [-1, -1, -1]]).astype(np.int32)
            steps = np.concatenate([steps, [0, 0, 0]]).astype(np.int32)
        elif form in ("t_max", "any-hit"):
            wave = dict(orig=np.concatenate([o, o[g]]),
                        dir=np.concatenate([d, d[g]]),
                        t_max=np.concatenate(
                            [np.full(k, 100.0, np.float32), tm60]),
                        any_hit=form == "any-hit")
            slot = np.concatenate([slot, [-1, 60]]).astype(np.int32)
            steps = np.concatenate(
                [steps, [18, 16 if form == "any-hit" else 18]]).astype(
                np.int32)
        elif form.startswith("any-hit"):
            wave.update(t_max=np.full(k, 100.0, np.float32), any_hit=True)
        if "cap" in form:
            wave["max_iters"] = int(form.split()[-1])
        tb = wave.get("t_max")
        t = np.full(slot.shape, BIG, np.float32) if tb is None else tb.copy()
        hit = slot >= 0
        t[hit] = edge_tri_t(tv, slot[hit], wave["orig"][hit],
                            wave["dir"][hit])
        cases.append((f"one leaf, {form}", tv, leaf, wave, (slot, steps, t)))
    # two leaves: slivers across z at x 0-4 and 11-15 (heights 0.5 and
    # 1.5, below and above the ray's band), the straddler (id 16) from x
    # 3.5 to 20 at height 1
    two = [_edge_tri(x0 + 0.5 * i, 0.5 + (i % 2), -5.0, x0 + 0.5 * i + 0.4,
                     10.0) for x0 in (0.0, 11.0) for i in range(8)] + [
        _edge_tri(3.5, 1.0, -5.0, 20.0, 10.0)]
    tv2 = np.stack(two)
    o2 = np.array([[3.0, 1.4, 0.3]], np.float32)
    d2 = np.array([[1.0, -0.045, 0.001]], np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    cases.append(("two leaves, a tie across them", tv2,
                  dict(max_depth=1, leaf_size=8), dict(orig=o2, dir=d2),
                  (np.array([20], np.int32), np.array([7], np.int32),
                   edge_tri_t(tv2, np.array([16]), o2, d2))))
    return cases


def bf_tie_case(recs, targets, copies):
    """W2's tie wave over records recs [F, 16]: ray k is aimed from above
    (EDGE_DIR, nearly vertical) at the centroid of record targets[k], and
    each target's record is copied to the rows copies[k] (its own row among
    them; rows past F are appended, one per target), so that its equal-t
    copies lie in its own tile, other tiles and, with few rays, other
    splits. Returns (rows, orig, dir, want): the tie wave's records are
    recs[rows]; want [K] is the last copy's row, the winner on equal t."""
    f = recs.shape[0]
    rows = np.arange(f + len(targets))
    for tgt, cp in zip(targets, copies):
        rows[cp] = tgt
    if not all(int(c.max()) < rows.size for c in copies) or not (
            rows[f:] < f).all():
        raise ValueError("bf_tie_case: each target needs one row past F")
    dev = recs.device
    tgt = torch.as_tensor(np.asarray(targets), device=dev)
    c = recs[tgt, 0:3] + (recs[tgt, 3:6] + recs[tgt, 6:9]) / 3.0
    d = torch.tensor(EDGE_DIR, device=dev).expand(len(targets), 3)
    d = d / d.norm(dim=1, keepdim=True)
    o = c - 3.0 * d
    want = torch.as_tensor([int(cp.max()) for cp in copies],
                           dtype=torch.int32, device=dev)
    return (torch.as_tensor(rows, device=dev), o.contiguous(),
            d.contiguous(), want)
