"""The plane-form packet engine (the port's part of clpathtracer_tpu/ops/
packet_mxu.py): Moller-Trumbore over 128-triangle chunks as four planes
per (ray, triangle) pair, for traverse_packet(engine="mxu").

For ray features F = [d, o, o x d, 1, 0...] (16) and per-triangle
coefficient columns (n = e1 x e2, the unnormalized geometric normal):

    det   = -n . d
    u*det =  e2 . (o x d) - (e2 x v0) . d
    v*det = -e1 . (o x d) - (v0 x e1) . d
    t*det =  n . o - (v0 . n) * 1

so one [tile, 16] x [16, 512] product per chunk gives all four for every
pair of the chunk; accept masks are scaled by det and one divide gives t
at each accepted pair. The TPU kernel runs that product on its matrix unit
at HIGHEST precision. The port's kernel K8 (ops/csrc/packet_mxu.cu) sums
the same terms in exact FP32 on the CUDA cores, in feature order, rounding
every operation and skipping the coefficient rows that are zero by
construction; its plain version (packet_mxu_reference) replays those sums
with elementwise torch ops. Against the JAX kernel, whose product sums in
another order, the results agree within a budget (grazing edges can flip),
as the JAX package's own test budgets its engine against the wavefront
walk.
"""

from __future__ import annotations

import numpy as np
import torch

from clpathtracer_tpu_torch.core import vecmath as vm
from clpathtracer_tpu_torch.ops.packet import (BIG, _REF_PAIRS,
                                               _box_interval, _axinfo,
                                               _check_stream_args,
                                               _launch_walk, _leaf_span,
                                               _per_tile, _push_children,
                                               packet_rays, stream_nodes)

MXU_TRIS = 128       # triangles per chunk
MXU_ROWS = 16        # feature rows per chunk block ([16, 512])
# t_upper refreshes after a leaf when the pop count is a multiple of 4: the
# TPU kernel's own constant, not the stream engine's TUP_MASK
MXU_TUP_MASK = 3
# The coefficients K8 reads: (row, plane) of each of the 19 rows that are
# not zero by construction (planes 0-3: det, u*det, v*det, t*det), in the
# order the kernel stages them for one triangle (ops/csrc/packet_mxu.cu's
# kSegRow, kSegPlane): det xyz, t const, u xyz, u o x d, v xyz, v o x d,
# t xyz.
SEG_ROWS = (0, 1, 2, 9, 0, 1, 2, 6, 7, 8, 0, 1, 2, 6, 7, 8, 3, 4, 5)
SEG_PLANES = (0, 0, 0, 3, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3)


def mxu_rows_from_quads(tris16: torch.Tensor) -> torch.Tensor:
    """Records [T, 16] (v0, e1, e2, tri_id) -> [C*16, 512] feature-major
    coefficient chunks, C = ceil(T / 128), on the records' device
    (clpathtracer_tpu/ops/packet_mxu.py::mxu_rows_from_quads, which takes
    the same records as [T/4, 64] quads). Chunk c's rows 16c..16c+15 are
    the features; its columns the det, u*det, v*det and t*det planes of
    triangles 128c..128c+127. Pad triangles (tri_id < 0, and the rows
    that fill the last chunk) get all-zero det columns, so det = 0 rejects
    them."""
    t = tris16.shape[0]
    pad = (-t) % MXU_TRIS
    if pad:
        fill = torch.zeros((pad, 16), dtype=tris16.dtype,
                           device=tris16.device)
        fill[:, 9] = -1.0
        tris16 = torch.cat([tris16, fill])
    v0, e1, e2 = tris16[:, 0:3], tris16[:, 3:6], tris16[:, 6:9]
    tid = tris16[:, 9]
    n = vm.cross(e1, e2)
    e2xv0 = vm.cross(e2, v0)
    v0xe1 = vm.cross(v0, e1)
    v0n = vm.dot(v0, n)[:, None]
    z3 = torch.zeros_like(n)
    z1 = torch.zeros_like(v0n)
    z6 = torch.zeros((n.shape[0], 6), dtype=n.dtype, device=n.device)
    # features: rows 0-2 d, 3-5 o, 6-8 o x d, 9 the constant 1, 10-15 pad
    valid = (tid >= 0.0).to(tris16.dtype)[:, None]
    c_det = torch.cat([-n, z3, z3, z1, z6], dim=1) * valid
    c_u = torch.cat([-e2xv0, z3, e2, z1, z6], dim=1)
    c_v = torch.cat([-v0xe1, z3, -e1, z1, z6], dim=1)
    c_t = torch.cat([z3, n, z3, -v0n, z6], dim=1)
    nchunk = tris16.shape[0] // MXU_TRIS

    def fold(c):   # [T, 16] -> [C, 16, 128]
        return c.reshape(nchunk, MXU_TRIS, 16).transpose(1, 2)

    block = torch.cat([fold(c_det), fold(c_u), fold(c_v), fold(c_t)], dim=2)
    return block.reshape(nchunk * MXU_ROWS, 4 * MXU_TRIS).contiguous()


def mxu_nodes(tree):
    """K8's node tables: stream_nodes' with a leaf's columns 1 and 3 its
    chunk range by the JAX kernel's arithmetic (_kernel_mxu's stream_leaf):
    first chunk c0 = first // 128 and count ceil((first + count) / 128) -
    c0, for first = 4 * quad start (an empty leaf not on a chunk boundary
    gets one chunk). Column 2 of a leaf is 0."""
    nodes_i, nodes_f = stream_nodes(tree)
    leaf, first, cnt = _leaf_span(tree)
    c0 = first // MXU_TRIS
    nch = (first + cnt + MXU_TRIS - 1) // MXU_TRIS - c0
    nodes_i = torch.stack([nodes_i[:, 0], torch.where(leaf, c0, nodes_i[:, 1]),
                           torch.where(leaf, 0, nodes_i[:, 2]),
                           torch.where(leaf, nch, 0)], dim=1)
    return nodes_i.contiguous(), nodes_f


def mxu_kernel_args(tree, orig, dir, image_shape=None, tile: int = 1024,
                    active=None):
    """The host side of traverse_packet's mxu branch (K8): (args, layout)
    with packet_mxu(*args, tile=tile) the kernel call and layout as
    ops/packet.py::packet_rays'. The coefficient chunks of tree.tris
    (mxu_rows_from_quads, per call as in the JAX package), mxu_nodes, the
    rays pixel-blocked when image_shape divides into tiles, the active
    mask."""
    orig_t, dir_t, act, layout = packet_rays(orig, dir, image_shape, tile,
                                             active)
    return (*mxu_nodes(tree), mxu_rows_from_quads(tree.tris), orig_t, dir_t,
            act), layout


def _check_chunks(chunks, device, name):
    if chunks.device != device:
        raise ValueError(f"{name}: chunks on {chunks.device}, the rays on "
                         f"{device}")
    if (chunks.dtype != torch.float32 or not chunks.is_contiguous()
            or chunks.dim() != 2 or chunks.shape[1] != 4 * MXU_TRIS
            or chunks.shape[0] % MXU_ROWS or chunks.shape[0] == 0):
        raise ValueError(f"{name}: chunks {chunks.dtype} "
                         f"{tuple(chunks.shape)} is not a contiguous f32 "
                         f"[C*{MXU_ROWS}, {4 * MXU_TRIS}] "
                         "(mxu_rows_from_quads)")


def packet_mxu(nodes_i, nodes_f, chunks, orig_t, dir_t, act, *, tile: int):
    """Nearest hit of every ray of every packet tile through the kd-tree
    with each chunk's test in plane form (K8; replaces clpathtracer_tpu/
    ops/packet_mxu.py::_kernel_mxu).

    nodes_i / nodes_f: mxu_nodes; chunks: [C*16, 512] mxu_rows_from_quads;
    orig_t / dir_t: [3, N] tile-major rays; act: [N] f32, > 0 for an active
    lane. K3's interval walk with no window cull; a leaf streams its chunk
    range, each chunk's planes summed in exact FP32 (see
    ops/csrc/packet_mxu.cu: a tile of 256k rays walks on a cluster of 8
    blocks; packet_mxu_shape). tile: as ops/packet.py::_walk_takes.

    Returns (best_t [N] f32, best_slot [N] i32 with -1 on a miss: the row
    of the [T, 16] records; stats [n_tiles, 5] i32 = node pops, chunks,
    active lanes, 0, 0).

    A CPU tensor runs the plain version (packet_mxu_reference); a CUDA
    tensor launches ops/csrc/packet_mxu.cu on the current stream or
    raises, also when the walk's stack overflows. `packet_mxu.launches`
    counts its launches."""
    name = "packet_mxu"
    _check_stream_args(nodes_i, nodes_f, None, orig_t, dir_t, act, tile,
                       None, None, None, None, 0, name=name)
    _check_chunks(chunks, act.device, name)
    device = act.device
    if device.type == "cpu":
        return packet_mxu_reference(nodes_i, nodes_f, chunks, orig_t, dir_t,
                                    act, tile=tile)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    out = _launch_walk(
        "packet_mxu_launch", tile, act.shape[0],
        (nodes_i, nodes_f, chunks, orig_t, dir_t, act),
        (act.shape[0], tile, chunks.shape[0] // MXU_ROWS))
    packet_mxu.launches += 1
    return out


packet_mxu.launches = 0


def staged_coefficients(chunks):
    """The coefficients K8 reads, per triangle: [C, 128, 19] in SEG_ROWS /
    SEG_PLANES order."""
    c = chunks.reshape(-1, MXU_ROWS, 4, MXU_TRIS)
    return c[:, list(SEG_ROWS), list(SEG_PLANES), :].transpose(1, 2)


def mxu_planes(w, f):
    """K8's four planes, summed as the kernel sums them: w [..., 19]
    staged coefficients (staged_coefficients), f the 9 ray features (d, o,
    o x d) broadcastable against w[..., 0]. Returns (det, ud, vd, td)."""
    d0, d1, d2, o0, o1, o2, c0, c1, c2 = f

    def plane(i):   # ((((d.w[i:i+3]) + c0 w) + c1 w) + c2 w)
        s = d0 * w[..., i] + d1 * w[..., i + 1] + d2 * w[..., i + 2]
        return s + c0 * w[..., i + 3] + c1 * w[..., i + 4] \
            + c2 * w[..., i + 5]
    det = d0 * w[..., 0] + d1 * w[..., 1] + d2 * w[..., 2]
    td = o0 * w[..., 16] + o1 * w[..., 17] + o2 * w[..., 18] + w[..., 3]
    return det, plane(4), plane(10), td


def mxu_features(rays):
    """The 9 features (dx, dy, dz, ox, oy, oz, (o x d)xyz) of rays (ox, oy,
    oz, dx, dy, dz), each product of o x d rounded separately."""
    ox, oy, oz, dx, dy, dz = rays
    return (dx, dy, dz, ox, oy, oz, oy * dz - oz * dy, oz * dx - ox * dz,
            ox * dy - oy * dx)


def packet_mxu_reference(nodes_i, nodes_f, chunks, orig_t, dir_t, act, *,
                         tile: int, tally=None):
    """Plain torch version of packet_mxu: same signature, same outputs,
    stats included, on any device. Each tile's walk runs on the host in
    numpy float32 scalars (_mxu_tile, K3's walk); a leaf's chunks run
    their plane tests as one batch of elementwise torch ops on the
    tensors' device (no matmul, einsum or sum over a dimension, whose
    orders are unspecified).

    tally (optional int64 [4] tensor): adds the pairs tested (active
    lanes x 128 per chunk), then those that pass det > 0, then also the u
    test, then also the v test: the kernel's early exits."""
    host = {"ni": nodes_i.cpu().numpy(), "nf": nodes_f.cpu().numpy()}
    coef = staged_coefficients(chunks)
    n_chunks = coef.shape[0]

    def walk(ti, ob, ib, n_act, rays, on):
        return _mxu_tile(host, ob, ib, n_act, coef, rays, on, n_chunks, tally)
    return _per_tile(walk, orig_t, dir_t, act, tile)


def _mxu_tile(host, ob, ib, n_act, coef, rays, on, n_chunks, tally):
    """One tile of the plain K8: (best_t [L], best_slot [L], stats [5])."""
    f32 = np.float32
    ni, nf = host["ni"], host["nf"]
    tile = on.shape[0]
    dev = on.device
    bt = torch.full((tile,), BIG, dtype=torch.float32, device=dev)
    bs = torch.full((tile,), -1, dtype=torch.int32, device=dev)
    feats = mxu_features(rays)
    axinfo = _axinfo(ob, ib)
    rt_lo, rt_hi = _box_interval(nf[0:3], nf[3:6], ob, ib)
    stack = [(0, rt_lo, rt_hi)] if rt_lo <= rt_hi and rt_hi > 0.0 else []
    t_upper = f32(BIG)
    nv = nl = 0
    while stack:
        node, tlo, thi = stack.pop()
        nv += 1
        if not (tlo <= np.minimum(thi, t_upper) and thi > 0.0):
            continue
        flags, a, b, c = (int(x) for x in ni[node])
        if flags >= 4:
            cs = np.minimum(a + np.arange(c), n_chunks - 1)
            bt, bs = _dense_chunks(coef, cs, feats, on, bt, bs, tally)
            nl += c
            if (nv & MXU_TUP_MASK) == 0:
                t_upper = f32(torch.where(on, bt, -BIG).amax().item())
        else:
            _push_children(stack, axinfo, nf, node, flags, a, b, tlo, thi,
                           t_upper)
    return bt, bs, (nv, nl, n_act, 0, 0)


def _dense_chunks(coef, cs, feats, on, bt, bs, tally):
    """Plane tests of chunks cs [K] (in stream order) against a tile's
    rays, merged into (bt, bs) with the kernel's tie rule: within a chunk
    the least t and the lowest slot among equal t; across chunks the later
    chunk wins at equal t."""
    if cs.shape[0] == 0:
        return bt, bs
    tile = bt.shape[0]
    dev = bt.device
    f = [x[None, None, :] for x in feats]
    lanes = torch.arange(MXU_TRIS, device=dev)[None, :, None]
    step = max(1, _REF_PAIRS // (MXU_TRIS * tile))
    for k0 in range(0, cs.shape[0], step):
        c = torch.as_tensor(cs[k0:k0 + step], device=dev)          # [K]
        k = c.shape[0]
        w = coef[c][:, :, None, :]                            # [K, 128, 1, 19]
        det, ud, vd, td = mxu_planes(w, f)                    # [K, 128, L]
        pass_det = det > 0.0
        pass_u = pass_det & (ud >= 0.0) & (ud <= det)
        pass_v = pass_u & (vd >= 0.0) & (ud + vd <= det)
        ok = pass_v & (td > 0.0) & on
        if tally is not None:
            tally[0] += k * MXU_TRIS * int(on.sum())
            tally[1:].add_(torch.stack([(x & on).sum()
                                        for x in (pass_det, pass_u, pass_v)]))
        t = torch.where(ok, td / torch.where(ok, det, 1.0), BIG)
        ct = t.amin(dim=1)                                     # [K, L]
        cj = torch.where(t == ct[:, None], lanes, MXU_TRIS).amin(dim=1)
        slot = c[:, None] * MXU_TRIS + cj                      # [K, L]
        m = ct.amin(dim=0)
        last = torch.where(ct == m, torch.arange(k, device=dev)[:, None],
                           -1).amax(dim=0)
        s_m = slot.gather(0, last[None]).squeeze(0).to(torch.int32)
        take = (m < BIG) & (m <= bt)
        bt = torch.where(take, m, bt)
        bs = torch.where(take, s_m, bs)
    return bt, bs
