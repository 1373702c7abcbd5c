"""Shared-origin tables, gate frustum planes and pixel-block layout.

The slice's part of clpathtracer_tpu/ops/packet.py, in plain torch on the
tensors' device.
"""

from __future__ import annotations

import torch

from clpathtracer_tpu_torch.core import vecmath as vm

BIG = 3.4e38        # "no hit" distance (f32-representable)
INV_BIG = 1e30      # clamp for 1/d of a zero direction component


def so_affine_tables(tris16: torch.Tensor) -> torch.Tensor:
    """Origin-independent shared-origin (SO) tables: [4, S, 16] f32
    (B0, B1, B2, B3) such that B0 + ox*B1 + oy*B2 + oz*B3 is the SO record
    of every triangle for a ray origin o.

    For rays that share the origin o, with a = v0 - o, b = v1 - o,
    c = v2 - o, a direction d hits a front face iff the signed volumes
    S1 = d.(a x b), S2 = d.(b x c), S3 = d.(c x a) are all <= 0 with
    S1 + S2 + S3 = d.n < 0, and then t = (a.n) / (d.n). Each of a x b,
    b x c, c x a and a.n is affine in o, so the tables are built once per
    scene.

    Record layout: cols 0-2 ab, 3-5 bc, 6-8 ca, 9 d0 = a.n, 10 tri_id,
    11-15 zero. The slot space is that of `tris16` (one record per row).
    Pad records (tri_id < 0) are all zero, so every S and d.n is exactly 0
    and the strict d.n < 0 test rejects them.

    Conditioning: the affine form rounds v0 x e1 and o x e1 separately, so
    edge tests lose ~|v0||o|/|a x e1| relative accuracy; rare edge-grazing
    winners can flip against a general Moller-Trumbore test. t, u and v
    re-resolve exactly from the winning slot.
    """
    v0, e1, e2, tid = (tris16[:, 0:3], tris16[:, 3:6], tris16[:, 6:9],
                       tris16[:, 9:10])
    n = vm.cross(e1, e2)
    c01 = vm.cross(v0, e1)
    c02 = vm.cross(v0, e2)
    g = e2 - e1
    z1 = torch.zeros_like(tid)
    z5 = torch.zeros((tris16.shape[0], 5), dtype=tris16.dtype,
                     device=tris16.device)

    # d(o x e)/d o_k for k = x, y, z
    def cx(e):
        return torch.stack([torch.zeros_like(e[:, 0]), -e[:, 2], e[:, 1]], 1)

    def cy(e):
        return torch.stack([e[:, 2], torch.zeros_like(e[:, 0]), -e[:, 0]], 1)

    def cz(e):
        return torch.stack([-e[:, 1], e[:, 0], torch.zeros_like(e[:, 0])], 1)

    b0 = torch.cat([c01, c02 - c01 + n, -c02,
                    vm.dot(v0, n)[:, None], tid, z5], dim=1)

    def bk(ck, nk):
        return torch.cat([-ck(e1), -ck(g), ck(e2), -nk[:, None], z1, z5],
                         dim=1)

    tabs = torch.stack([b0, bk(cx, n[:, 0]), bk(cy, n[:, 1]),
                        bk(cz, n[:, 2])])
    return torch.where(tid[None] < 0.0, 0.0, tabs)


def so_combine(so_base: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """The per-frame SO records [S, 16] for one shared ray origin [3]:
    B0 + ox*B1 + oy*B2 + oz*B3, summed left to right (the combine that
    clpathtracer_tpu/ops/plist.py::traverse_plist does inline)."""
    return (so_base[0] + origin[0] * so_base[1]
            + origin[1] * so_base[2] + origin[2] * so_base[3])


def _frustum_rows(dir_b: torch.Tensor, origin: torch.Tensor, tile: int,
                  th: int, tw: int) -> torch.Tensor:
    """Per-tile pinhole frustum planes: [n_tiles, 16] f32 rows of 4 unit
    outward plane normals (12), the shared origin (3) and a pad (1).

    A tile's lanes are a th x tw pixel block in row-major order, so its
    corner rays are lanes (0, tw-1, (th-1)*tw, tile-1). Degenerate edges
    (zero cross) give a zero normal, which never culls."""
    nt = dir_b.shape[0] // tile
    d2 = dir_b.reshape(nt, tile, 3)
    c = d2[:, [0, tw - 1, (th - 1) * tw, tile - 1], :]           # [nt, 4, 3]
    ns = []
    for a, b in ((0, 1), (1, 3), (3, 2), (2, 0)):
        o0, o1 = (i for i in range(4) if i not in (a, b))
        n = vm.cross(c[:, a], c[:, b])
        s = vm.dot(n, c[:, o0] + c[:, o1])[:, None]
        n = torch.where(s > 0.0, -n, n)          # interior dirs: n . d <= 0
        nn = vm.length(n)[:, None]
        ns.append(torch.where(nn > 1e-20, n / torch.clamp(nn, min=1e-30),
                              0.0))
    o = origin.reshape(1, 3).to(torch.float32).expand(nt, 3)
    return torch.cat(ns + [o, torch.zeros((nt, 1), dtype=torch.float32,
                                          device=dir_b.device)], dim=1)


def _blockify(x: torch.Tensor, h: int, w: int, th: int,
              tw: int) -> torch.Tensor:
    """Row-major [h*w, ...] -> tile-major: each (th, tw) pixel block is
    contiguous, its lanes in row-major order."""
    tail = x.shape[1:]
    x = x.reshape(h // th, th, w // tw, tw, *tail)
    return x.transpose(1, 2).reshape(h * w, *tail)


def _unblockify(x: torch.Tensor, h: int, w: int, th: int,
                tw: int) -> torch.Tensor:
    tail = x.shape[1:]
    x = x.reshape(h // th, w // tw, th, tw, *tail)
    return x.transpose(1, 2).reshape(h * w, *tail)
