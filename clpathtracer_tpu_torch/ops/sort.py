"""Ray reordering for bounce coherence (port of clpathtracer_tpu/ops/sort.py).

Bounce rays scatter. Sorting the wave by direction octant, then by the
Morton code of the quantized origin, makes consecutive 512-ray bundles
see similar geometry again; results go back to wave order through the
inverse permutation.
"""

from __future__ import annotations

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits over 30 (Morton interleave), int32."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def ray_sort_keys(orig, dir, alive=None, bits: int = 7) -> torch.Tensor:
    """[N] int32 sort keys: direction octant (3 high bits), then the
    Morton code of the origin quantized to 2^bits per axis over the
    wave's bounding box (dead rays included). Dead rays get 0x7FFFFFFF
    and sort to the end."""
    lo = orig.amin(dim=0)
    ext = torch.clamp(orig.amax(dim=0) - lo, min=1e-12)
    # float -> int32 truncates toward zero, as astype(int32) does
    q = torch.clamp(((orig - lo) / ext) * (1 << bits), 0,
                    (1 << bits) - 1).to(torch.int32)
    morton = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
              | (_part1by2(q[:, 2]) << 2))
    octant = ((dir[:, 0] > 0).to(torch.int32)
              + 2 * (dir[:, 1] > 0).to(torch.int32)
              + 4 * (dir[:, 2] > 0).to(torch.int32))
    key = (octant << 27) | (morton & 0x7FFFFFF)
    if alive is not None:
        key = torch.where(alive, key, 0x7FFFFFFF)
    return key


def sort_rays(orig, dir, alive=None, bits: int = 7):
    """Returns (perm, inv_perm), int64: x[perm] reorders the wave
    coherently, results[inv_perm] restores wave order. The sort is
    stable, so rays with equal keys keep their wave order.
    `sort_rays.calls` counts the calls."""
    sort_rays.calls += 1
    keys = ray_sort_keys(orig, dir, alive, bits)
    perm = torch.argsort(keys, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


sort_rays.calls = 0
