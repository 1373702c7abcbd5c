#!/usr/bin/env python3
"""Run the PyTorch port's primary-ray frame once on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

1. device: require CUDA, print the card's name and power limit (nvidia-smi),
   turn TF32 off;
2. build: compile clpathtracer_tpu_torch/ops/csrc/*.cu with nvcc (sm_90a)
   and load the library;
3. scene: the procedural 1M-triangle terrain (seed 0), windows at
   win_rows 16 with shared-origin tables and resolve rows on the card;
   camera [0, 14, 0] looking down [0, -1, 0.01]; a 512x512 frame
   (512 gates of 16x32 pixels);
4. kernel: one prepass, then the super-list kernel (K1) on all gates and
   its plain torch version on every 8th gate; best t, best slot and stats
   must match exactly (the kernel rounds as the plain version does);
5. oracle: 4096 random pixels against a brute-force Moller-Trumbore over
   all triangles (hit mismatch < 2e-3, t rtol 1e-4);
6. frame: render_image at 512x512, 2 warm-up and 20 timed frames (CUDA
   events); K1's launch counter must rise by exactly 22; the image is
   finite and more than 99% of the pixels hit. Prints the frame time,
   rays/s, the split into rays / prepass / kernel / resolve+shade, windows
   per gate, triangle tests per ray, and the kernel's time beside its plain
   version's at the same shapes.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np
import torch

from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                generate_rays)
from clpathtracer_tpu_torch.ops import plist
from clpathtracer_tpu_torch.ops._cuda import load_kernels
from clpathtracer_tpu_torch.ops.packet import (BIG, _blockify, _unblockify,
                                               so_combine)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      render_image)
from clpathtracer_tpu_torch.render.shading import normal_color
from clpathtracer_tpu_torch.scene.procedural import terrain_mesh

N_TRIS = 1_000_000
SIZE = 512
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]
WIN_ROWS = 16
WARMUP, FRAMES = 2, 20
ORACLE_PIXELS = 4096


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_times_ms(fn, reps):
    """Per-call device times (CUDA events) of `reps` calls of fn."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def bruteforce_hits(scene, orig, dirs, chunk=16384):
    """Nearest front-face hit distance over every triangle (inf = miss)."""
    v0, v1, v2 = scene.tri_verts()
    e1, e2 = v1 - v0, v2 - v0
    best = torch.full((orig.shape[0],), float("inf"), device=orig.device)
    for c in range(0, v0.shape[0], chunk):
        ok, t, _, _ = _mt_pre(v0[None, c:c + chunk], e1[None, c:c + chunk],
                              e2[None, c:c + chunk], orig[:, None],
                              dirs[:, None])
        best = torch.minimum(
            best, torch.where(ok, t, float("inf")).amin(dim=1))
    return best


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say("device", f"{kind}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; card and power "
        "limit on the next line")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    lib = load_kernels()
    say("build", f"{lib.build_seconds:.2f} s nvcc -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            say("build", line.strip())

    # 3. scene at full size
    t = time.perf_counter()
    scene = terrain_mesh(N_TRIS, seed=0, extent=10.0,
                         device=device).bake_shading()
    mwin = plist.build_morton_windows(scene.tri_corners(), WIN_ROWS,
                                      device=device)
    mwin = plist.attach_resolve(plist.attach_so(mwin), scene.shade_rows)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    say("scene", f"{scene.num_tris} triangles, {mwin.tris.shape[0]} slots, "
        f"{mwin.num_windows} windows, {scene.nbytes() + mwin.nbytes()} "
        f"device bytes of scene state, host build {build_s:.2f} s")
    cam = Camera.create(POS, FWD, device=device)
    opts = RenderOptions(width=SIZE, height=SIZE)
    n = SIZE * SIZE
    n_gates = n // plist.GATE

    # 4. kernel against its plain version
    orig, dirs = generate_rays(cam_matrix(cam, SIZE), SIZE, SIZE)
    o = orig[0]

    def prepass():
        dir_b = _blockify(dirs, SIZE, SIZE, plist.GH, plist.GW)
        rows = so_combine(mwin.so_base, o)
        return (dir_b.T.contiguous(), rows,
                *plist.gate_lists_super(mwin.win_bnd, dir_b, o))
    dir_t, rows, key, sid, bits = prepass()
    t0 = torch.full((n,), BIG, device=device)
    k_args = (key, sid, bits, rows, dir_t, t0)
    best_t, best_slot, stats = plist.plist_super(*k_args, win_rows=WIN_ROWS)
    torch.cuda.synchronize()
    sel = torch.arange(0, n_gates, 8, device=device)
    lanes = (sel[:, None] * plist.GATE
             + torch.arange(plist.GATE, device=device)).reshape(-1)
    ref_t, ref_slot, ref_stats = plist.plist_super_reference(
        key[sel].contiguous(), sid[sel].contiguous(), bits[sel].contiguous(),
        rows, dir_t[:, lanes].contiguous(), t0[lanes], win_rows=WIN_ROWS)
    bad_t = int((best_t[lanes] != ref_t).sum())
    bad_slot = int((best_slot[lanes] != ref_slot).sum())
    bad_stats = int((stats[sel] != ref_stats).sum())
    hit_sel = ref_slot >= 0
    max_abs_err = float((best_t[lanes] - ref_t)[hit_sel].abs().max()) \
        if bool(hit_sel.any()) else 0.0
    say("kernel", f"{sel.numel()} gates against the plain version "
        f"(tolerance: exact): t mismatches {bad_t}, slot mismatches "
        f"{bad_slot}, stats mismatches {bad_stats}, max |dt| {max_abs_err}")
    if bad_t or bad_slot or bad_stats:
        raise AssertionError("plist_super kernel disagrees with "
                             "plist_super_reference")

    # 5. independent oracle
    rec = plist.traverse_plist(mwin, orig, dirs, (SIZE, SIZE))
    pix = torch.as_tensor(np.random.default_rng(0).choice(
        n, ORACLE_PIXELS, replace=False), device=device)
    bf_t = bruteforce_hits(scene, orig[pix], dirs[pix])
    bf_hit = torch.isfinite(bf_t)
    hit = rec["hit"][pix]
    mismatch = float((hit != bf_hit).float().mean())
    both = hit & bf_hit
    rel = ((rec["t"][pix] - bf_t).abs() / bf_t.abs())[both]
    t_ok = bool(torch.allclose(rec["t"][pix][both], bf_t[both], rtol=1e-4,
                               atol=1e-5))
    say("oracle", f"{ORACLE_PIXELS} pixels vs brute force over "
        f"{scene.num_tris} triangles: hit mismatch {mismatch} (< 2e-3), "
        f"max rel dt {float(rel.max()) if rel.numel() else 0.0} (rtol 1e-4): "
        f"{'ok' if t_ok else 'FAIL'}")
    if mismatch >= 2e-3 or not t_ok:
        raise AssertionError("render hits disagree with the brute force")

    # 6. the frame, through the public entry point
    plist.plist_super.launches = 0
    for _ in range(WARMUP):
        render_image(scene, cam, opts, mwin)
    torch.cuda.synchronize()
    wall = time.perf_counter()
    frame_ms = cuda_times_ms(lambda: render_image(scene, cam, opts, mwin),
                             FRAMES)
    wall = (time.perf_counter() - wall) / FRAMES * 1e3
    launches = plist.plist_super.launches
    img = render_image(scene, cam, opts, mwin)
    torch.cuda.synchronize()
    if launches != WARMUP + FRAMES:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{WARMUP + FRAMES} frames")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    hit_frac = float(rec["hit"].float().mean())
    img_hit_frac = float((img < 1.0).any(dim=-1).float().mean())
    if hit_frac <= 0.99 or img_hit_frac <= 0.99:
        raise AssertionError(f"hit fraction {hit_frac} / {img_hit_frac}")
    med = float(np.median(frame_ms))
    say("frame", f"{SIZE}x{SIZE} normal: median {med:.4f} ms over {FRAMES} "
        f"frames (min {min(frame_ms):.4f}, max {max(frame_ms):.4f}; host "
        f"wall {wall:.4f} ms/frame), {n / med * 1e3:.6g} rays/s, hit "
        f"fraction {hit_frac}, K1 launches {launches}")

    # the split, each part timed alone on the same inputs
    def resolve_shade():
        slots = _unblockify(best_slot, SIZE, SIZE, plist.GH, plist.GW)
        r = plist._resolve_winners(mwin, slots, orig, dirs, stats)
        return torch.where(r["hit"][:, None], normal_color(r["snormal"]),
                           opts.background)
    split = {
        "rays": cuda_times_ms(
            lambda: generate_rays(cam_matrix(cam, SIZE), SIZE, SIZE), 20),
        "prepass": cuda_times_ms(prepass, 20),
        "kernel": cuda_times_ms(
            lambda: plist.plist_super(*k_args, win_rows=WIN_ROWS), 20),
        "resolve+shade": cuda_times_ms(resolve_shade, 20),
    }
    split = {k: float(np.median(v)) for k, v in split.items()}
    say("frame", "split (median ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    plain_ms = float(np.median(cuda_times_ms(
        lambda: plist.plist_super_reference(*k_args, win_rows=WIN_ROWS), 3)))
    wpg = float(stats[:, 1].float().mean())
    say("frame", f"windows per gate {wpg:.3f} (max {int(stats[:, 1].max())}),"
        f" supers per gate {float(stats[:, 3].float().mean()):.3f}, triangle "
        f"tests per ray {wpg * WIN_ROWS * 8:.1f}")
    say("frame", f"K1 at {n_gates} gates: kernel {split['kernel']:.4f} ms, "
        f"plain torch version {plain_ms:.4f} ms")

    print(json.dumps({"kernels": [{
        "name": "plist_super", "route": "cuda",
        "source": "clpathtracer_tpu_torch/ops/csrc/plist_super.cu",
        "replaces": "clpathtracer_tpu/ops/plist.py:955",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": split["kernel"], "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
