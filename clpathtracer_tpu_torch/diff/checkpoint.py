"""Checkpoint and resume of inverse-rendering runs (port of
clpathtracer_tpu/diff/checkpoint.py, with torch.save in place of orbax).

A checkpoint is one file `<path>/<step>.pt` holding {step, params,
opt_state}: the parameter tensors (detached) and the optimizer's
state_dict(). It is written to a temporary name and renamed, so that a
run cut mid-write leaves the previous checkpoints whole.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def _steps(path: str) -> list:
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
                  if m)


def save_train_state(path: str, step: int, params: dict, opt_state: Any,
                     max_to_keep: int = 3) -> None:
    """Persist {params, opt_state} at `step` under the directory `path`,
    then keep only the max_to_keep latest steps. opt_state: the
    optimizer's state_dict()."""
    os.makedirs(path, exist_ok=True)
    file = os.path.join(path, f"{int(step)}.pt")
    torch.save({"step": int(step),
                "params": {k: v.detach() for k, v in params.items()},
                "opt_state": opt_state}, file + ".tmp")
    os.replace(file + ".tmp", file)
    for old in _steps(path)[:-max_to_keep]:
        os.remove(os.path.join(path, f"{old}.pt"))


def restore_train_state(path: str, step: Optional[int] = None,
                        map_location=None):
    """(step, {"params", "opt_state"}) of the checkpoint at `step` under
    `path`, the latest when step is None; tensors go to map_location (as
    torch.load's). Load opt_state into a fresh optimizer over the restored
    params (with requires_grad set) with load_state_dict."""
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    saved = torch.load(os.path.join(path, f"{int(step)}.pt"),
                       map_location=map_location, weights_only=True)
    return saved["step"], {"params": saved["params"],
                           "opt_state": saved["opt_state"]}
