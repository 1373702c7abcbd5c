"""The comparison that decides `correct`.

During the window the harness keeps, of every frame, the pixels that
inputs.sample_pixels draws from the seed, as the program put them on the
host. Once the window has closed (and the program's state is freed),
inputs.sample_frames draws the frames to compare, and the reference
(reference/render.py) works out the same pixels from the inputs alone.

The number compared is bad_px: the share of compared pixels of which a
channel differs from the reference by more than atol + rtol * |ref| (a
non-finite pixel is bad). The limit is the cell's (limits/<cell>.json),
set from the program's readings over a dozen seeds and more and the
control's: the reference with its ray-triangle test in bfloat16, one
precision below the configuration's float32, put in the program's
place."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import inputs, render


def compare(program: np.ndarray, ref: np.ndarray, atol: float,
            rtol: float) -> np.ndarray:
    """Per pixel: whether it is bad (any channel out of tolerance)."""
    diff = np.abs(program.astype(np.float64) - ref)
    bad = (diff > atol + rtol * np.abs(ref)).any(axis=1)
    return bad | ~np.isfinite(program).all(axis=1)


# the look at a bad pixel (readings only): the reference's inputs moved
# by a rounding's worth of the program's float32 arithmetic. A ray's pixel
# position by PX_EPS along x or y: the port's float32 camera chain turns
# its rays by up to about 5e-6 rad against the float64 chain's, some
# 3e-3 of a 720-row pixel; the draws by DRAW_EPS either way.
DRAW_EPS, PX_EPS = 1e-6, 4e-3
NUDGES = (dict(draw_eps=DRAW_EPS), dict(draw_eps=-DRAW_EPS),
          dict(px_eps=(PX_EPS, 0.0)), dict(px_eps=(-PX_EPS, 0.0)),
          dict(px_eps=(0.0, PX_EPS)), dict(px_eps=(0.0, -PX_EPS)))


def reference_pixels(ref_scene, cell, seed, draws_pool, k, pixels,
                     dtype=torch.float64, draw_eps=0.0, px_eps=(0.0, 0.0)):
    pos, fwd = inputs.pose(cell.config["camera"], seed, k)
    draws = inputs.frame_draws(draws_pool, k)
    if draw_eps:
        draws = {n: torch.clamp(x + draw_eps, 0.0, 1.0 - 2**-24)
                 for n, x in draws.items()}
    return render.frame_pixels(ref_scene, cell.traffic, cell.config["camera"],
                               pos, fwd, pixels, draws, dtype,
                               px_eps).cpu().numpy()


def explained(ref_scene, cell, seed, draws_pool, k, pixels, values) -> int:
    """How many of these bad pixels the reference reproduces under one of
    NUDGES: pixels whose value turns on a decision (an edge, a tie, a light
    table's boundary, a cosine's sign) within rounding of its threshold."""
    lim = cell.limits
    left = np.ones(len(pixels), bool)
    for kw in NUDGES:
        ref = reference_pixels(ref_scene, cell, seed, draws_pool, k, pixels,
                               **kw)
        left &= compare(values, ref, lim["atol"], lim["rtol"])
    return int((~left).sum())


def check(cell, seed, arrays, draws_pool, captured: dict, device,
          control: bool = False) -> dict:
    """captured: frame index -> (pixels [P], the program's values [P, 3]).
    Returns {"bad_px": share} and, with control (the readings), also
    "control_bad_px", the share by which the bfloat16 reference misses the
    float64 one on the same pixels, and "explained_bad", the bad pixels
    that a rounding's nudge of the inputs reproduces (NUDGES)."""
    lim = cell.limits
    ref_scene = render.Scene(arrays, device)
    frames = inputs.sample_frames(seed, len(captured), lim["frames"])
    bad, bad_ctl, n, why = 0, 0, 0, 0
    for k in frames:
        pixels, values = captured[int(k)]
        ref = reference_pixels(ref_scene, cell, seed, draws_pool, int(k),
                               pixels, torch.float64)
        off = compare(values, ref, lim["atol"], lim["rtol"])
        bad += int(off.sum())
        n += len(pixels)
        if control and off.any():
            why += explained(ref_scene, cell, seed, draws_pool, int(k),
                             pixels[off], values[off])
        if control:
            low = reference_pixels(ref_scene, cell, seed, draws_pool, int(k),
                                   pixels, torch.bfloat16)
            bad_ctl += int(compare(low.astype(np.float32), ref, lim["atol"],
                                   lim["rtol"]).sum())
    out = {"bad_px": bad / max(n, 1), "compared_px": n,
           "compared_frames": len(frames)}
    if control:
        out["control_bad_px"] = bad_ctl / max(n, 1)
        out["bad"], out["explained_bad"] = bad, why
    return out
