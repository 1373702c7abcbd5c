"""The rope walk over a kd-tree of any leaf padding (port of
clpathtracer_tpu/ops/traverse.py).

The JAX package walks the reference's compact layout (build_kd_tree's
tri_block of 1, 2, ...) with its own lockstep loop, each leaf's records
in blocks of tri_block. The walk and its rules are traverse_fast's
(ops/traverse_fast.py), so here it is the same kernel, W1, with the block
size as an argument: its record equals the JAX traverse's in hit, t, tri,
u and v. The steps count split nodes too, as traverse_fast's do; the JAX
traverse counts leaf blocks only, and its max_iters caps those. Steps
belong to traverse_fast's contract only.
"""

from __future__ import annotations

import dataclasses

import torch

from clpathtracer_tpu_torch.core.struct import TensorStruct
from clpathtracer_tpu_torch.ops.traverse_fast import _record, ray_walk


@dataclasses.dataclass(frozen=True)
class PackedTris(TensorStruct):
    """Leaf-contiguous triangle corners: row i of v0/v1/v2 [T, 3] is
    triangle tri_id[i]'s (tree.tri_indices; -1 pads give triangle 0's
    corners and are never hit)."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    tri_id: torch.Tensor

    @classmethod
    def pack(cls, tree, v0, v1, v2) -> "PackedTris":
        idx = tree.tri_indices
        safe = idx.clamp(min=0).long()
        return cls(v0=v0[safe], v1=v1[safe], v2=v2[safe], tri_id=idx)

    def records(self) -> torch.Tensor:
        """The [T, 16] records (v0, e1, e2, tri_id, pad 6) the walk reads,
        e1 and e2 rounded in f32 as moller_trumbore rounds them."""
        t = self.v0.shape[0]
        pad = torch.zeros((t, 6), dtype=torch.float32, device=self.v0.device)
        return torch.cat([self.v0, self.v1 - self.v0, self.v2 - self.v0,
                          self.tri_id.to(torch.float32)[:, None], pad],
                         dim=1).contiguous()


def traverse(tree, orig, dir, tri_block: int = 4, max_iters: int = 16384,
             *, packed: PackedTris = None, active=None):
    """Trace a wave through the kd-tree with the rope walk, tri_block
    records a leaf step (W1 on the GPU, its plain version on the CPU).

    tree: accel/sah.py::FlatKdTree of any tri_block; packed: optional
    PackedTris whose records replace tree.tris (the JAX package packs them
    from the scene's vertices each call). active: optional [N] bool, dead
    lanes never walk. Returns hit, t, tri, u, v, steps [N]."""
    if packed is not None:
        tree = tree.replace(tris=packed.records())
    return _record(tree, ray_walk(tree, orig, dir, block=tri_block,
                                  max_iters=max_iters, active=active),
                   orig, dir, False)
