"""What the benchmark makes from --seed and hands to both the program and
the reference: the scene's arrays, the camera poses, the path draws and
the pixels and frames that the check samples. The same seed gives the
same inputs; every seed gives a scene of the same size and kind, the same
frame size and the same number of poses and draws."""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def make_scene(spec: dict, seed: int) -> dict:
    """The scene of a configuration's "scene" spec: numpy arrays verts
    [V, 3] f32, faces [F, 3] i32 (vertex indices, wound so that the front
    face's normal is (v1 - v0) x (v2 - v0)), emission [F, 3] f32. The
    generator is reference/scenes/<kind>.py."""
    gen = importlib.import_module(f"benchmark.reference.scenes.{spec['kind']}")
    return gen.make(spec, seed)


def pose_index(poses: int, seed: int, k: int) -> int:
    """The pose of frame k: the seed's starting pose plus k mod poses with
    its bits reversed, so that every seed visits the same poses, and any
    2^j consecutive frames spread evenly over the path."""
    bits = poses.bit_length() - 1
    if poses != 1 << bits:
        raise ValueError(f"poses {poses} is not a power of two")
    j = k % poses
    rev = int(format(j, f"0{bits}b")[::-1], 2) if bits else 0
    start = int(np.random.default_rng([seed, 1]).integers(poses))
    return (start + rev) % poses


def pose(camera: dict, seed: int, k: int):
    """Frame k's camera: (position [3], forward [3]) as float64 numpy. An
    "orbit" path has `poses` positions evenly on a circle of `radius` at
    `height` above `target`, each looking at the target; frame k takes
    pose_index's."""
    if camera["kind"] != "orbit":
        raise ValueError(f"unknown camera path {camera['kind']!r}")
    poses = int(camera["poses"])
    a = 2.0 * math.pi * pose_index(poses, seed, k) / poses
    target = np.asarray(camera["target"], np.float64)
    pos = target + np.array([camera["radius"] * math.cos(a), camera["height"],
                             camera["radius"] * math.sin(a)])
    fwd = target - pos
    return pos, fwd / np.linalg.norm(fwd)


def draw_shapes(traffic: dict) -> dict:
    """The shapes of one frame's path draws (clpathtracer_tpu_torch's
    path_draws): jitter [S, N, 2] when spp > 1, bounce [S, bounces, N, 2],
    light [S, bounces, N, 3] with NEE (one light sample a lane), with
    S = spp when spp > 1, else 1. Empty outside path mode."""
    if traffic["mode"] != "path":
        return {}
    n = traffic["width"] * traffic["height"]
    spp, bounces = traffic["spp"], traffic["bounces"]
    s = spp if spp > 1 else 1
    out = {"bounce": (s, bounces, n, 2)}
    if spp > 1:
        out["jitter"] = (s, n, 2)
    if traffic["nee"]:
        out["light"] = (s, bounces, n, 3)
    return out


def draws_pool(traffic: dict, seed: int, device) -> dict:
    """traffic["draw_sets"] sets of path draws, uniforms in [0, 1), made on
    the device by one torch.Generator in one call a kind: a dict kind ->
    [sets, *shape]; frame k takes set k mod sets."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    sets = int(traffic["draw_sets"])
    return {k: torch.rand((sets, *shape), generator=gen, device=device)
            for k, shape in sorted(draw_shapes(traffic).items())}


def frame_draws(pool: dict, k: int) -> dict:
    return {name: x[k % x.shape[0]] for name, x in pool.items()}


def sample_pixels(seed: int, k: int, n_pixels: int, count: int) -> np.ndarray:
    """The pixels of frame k that the check compares: `count` flat indices
    (y * W + x) drawn from the seed."""
    rng = np.random.default_rng([seed, 2, k])
    return rng.integers(0, n_pixels, size=count, dtype=np.int64)


def sample_frames(seed: int, n_frames: int, count: int) -> np.ndarray:
    """Which of the window's n_frames frames the check compares, drawn
    from the seed, in order."""
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(n_frames, min(n_frames, count), replace=False))
