"""Error-checking harness: the reference's fail-fast layer (the port's
counterpart of clpathtracer_tpu/utils/errors.py).

The reference wraps every OpenCL call in HANDLE_ERR (name the error code,
print file:line, exit; src/error.c:147-154) and checks glGetError each
frame. The failure modes that matter for a renderer are numeric (NaN/Inf
radiance, negative t, degenerate normals). This module provides:

* `checked(fn)`: wrap a render or step function so that a NaN or Inf in
  its outputs raises FloatingPointError naming the first such output
  (the JAX package's checkify float checks, as explicit finite checks on
  what the function returns);
* `debug_nans()`: a scope with torch.autograd's anomaly detection on (a
  backward that produces NaN raises where it happens), restored after;
* `validate_image(img)`: host-side fail-fast assertions on a rendered
  frame (finite, non-negative), the analogue of the per-frame glGetError
  sweep (src/GLState.c:103-107).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def _tensors(out, path="output"):
    """(name, tensor) for every floating tensor in a nest of tuples,
    lists and dicts, in order."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _tensors(v, f"{path}[{k!r}]")
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _tensors(v, f"{path}[{i}]")


def checked(fn):
    """Wrap fn; the wrapper raises FloatingPointError when an output
    tensor holds a NaN or an Inf, naming the first such output. The check
    reads every output back once: use it in tests and debugging, not on a
    timed path."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name, t in _tensors(out):
            if not bool(torch.isfinite(t).all()):
                bad = int((~torch.isfinite(t)).sum())
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: {name} holds {bad} "
                    "non-finite values")
        return out

    return wrapper


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scope-local torch.autograd anomaly detection (a NaN produced in
    backward raises at the operation that made it)."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def validate_image(img, name: str = "frame") -> np.ndarray:
    """Fail fast on a bad rendered frame (host side, after the device)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    a = np.asarray(img)
    if not np.isfinite(a).all():
        bad = int((~np.isfinite(a)).sum())
        raise FloatingPointError(
            f"{name}: {bad} non-finite pixel channels")
    if (a < 0).any():
        raise FloatingPointError(
            f"{name}: negative radiance (min {a.min()})")
    return a
