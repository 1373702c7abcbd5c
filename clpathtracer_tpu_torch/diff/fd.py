"""Finite-difference gradient harness (port of clpathtracer_tpu/diff/fd.py).

The oracle of the differentiable mode: central differences element by
element, 2 evaluations a parameter, so use tiny scenes and images.
"""

from __future__ import annotations

import numpy as np
import torch


def fd_grad(f, x, eps: float = 1e-3):
    """Central-difference gradient of the scalar f at x, a tensor or a dict
    of tensors: d f / d x_i ~ (f(x + eps e_i) - f(x - eps e_i)) / (2 eps).

    Each perturbed value is formed in float64 on the host and handed to f
    as a tensor of the leaf's dtype and device, the other leaves as they
    are; f runs under torch.no_grad. Returns float64 CPU tensors shaped
    like x."""
    leaves = dict(x) if isinstance(x, dict) else {None: x}
    out = {}
    for name, leaf in leaves.items():
        base = leaf.detach().cpu().numpy().astype(np.float64)
        g = np.zeros(base.size)
        for i in range(base.size):
            for step, sign in ((eps, 1.0), (-eps, -1.0)):
                pert = base.reshape(-1).copy()
                pert[i] += step
                arg = torch.as_tensor(pert.reshape(base.shape),
                                      dtype=leaf.dtype, device=leaf.device)
                args = {**leaves, name: arg} if isinstance(x, dict) else arg
                with torch.no_grad():
                    g[i] += sign * float(f(args))
            g[i] /= 2.0 * eps
        out[name] = torch.as_tensor(g.reshape(base.shape))
    return out if isinstance(x, dict) else out[None]
