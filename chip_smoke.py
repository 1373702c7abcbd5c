#!/usr/bin/env python3
"""Run the PyTorch port's paths once on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases, one line or more each (any failure raises and the exit code is
not 0):

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
6. normal frame: render_image at 512x512, 2 warm-up and 20 timed frames
   (CUDA events); K1's launch counter must rise by exactly 22; the image
   is finite and more than 99% of the pixels hit. Prints the frame time,
   rays/s, the split into rays / prepass / kernel / resolve+shade, windows
   per gate, triangle tests per ray, and the kernel's time beside its plain
   version's at the same shapes;
7. soup: random_tri_soup(1M, seed 0, tri_size 0.01) at win_rows 8, camera
   [0, 0, -25] looking [0, 0, 1]; K1 on all gates against its plain version
   on every 8th gate (exact); a normal frame (2 warm-up, 10 timed);
8. K1' (the general Moller-Trumbore form): 262,144 random rays on the 1M
   terrain (origins in [-12, 12]^3, unit-normal directions, half of the
   lanes dead), Morton-sorted; K1' on all 512 bundles against its plain
   version on every 8th bundle (exact);
9. oracle: 4096 of those live rays against the brute force (hit mismatch
   < 1e-3, t rtol 1e-5);
10. mirror frame: 512x512, bounces 2, 2 warm-up and 10 timed frames; K1
   and K1' each rise by 1 per frame; the bounce wave rebuilt with the
   frame's own functions (intersect_scene, mirror_wave, sort_wave,
   bundle_kernel_args) and K1' against its plain version on all of its
   bundles (exact), which also counts the tested pairs that leave the test
   at each early exit for K1''s bound; the split into primary / sort /
   bundle prepass / K1' / resolve+shade, and the bounce wave's live lanes,
   windows per bundle and tests per live ray;
11. path frame: 512x512, spp 4, bounces 2, no NEE, background 1.0,
   generator seeded 0, 1 warm-up and 5 timed frames; K1 and K1' each rise
   by 4 per frame; the image is finite with its mean in (0, 1]; paths/s
   and traversal rays/s.

The line before the last is a JSON object of the kernels: each kernel's
launches are those of the frames of the path that gives its ms (K1 the
normal frame, K1' the mirror frame), with every path's own count beside
them. The last line is {"ok": true, "device": {...}}.
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
                                                      intersect_scene,
                                                      mirror_wave,
                                                      render_image,
                                                      sort_wave)
from clpathtracer_tpu_torch.render.shading import normal_color
from clpathtracer_tpu_torch.scene.procedural import (random_tri_soup,
                                                     terrain_mesh)

N_TRIS = 1_000_000
SIZE = 512
POS, FWD = [0.0, 14.0, 0.0], [0.0, -1.0, 0.01]
SOUP_POS, SOUP_FWD = [0.0, 0.0, -25.0], [0.0, 0.0, 1.0]
WIN_ROWS = 16
SOUP_WIN_ROWS = 8
WARMUP, FRAMES = 2, 20
ORACLE_PIXELS = 4096
EVERY = 8            # plain versions run on every 8th gate or bundle
# FP32 operations per ray-triangle test, counted from the tests' sources
# (ops/csrc/plist_super.cu). K1 (so_hit) runs all of its test for every
# pair: 9 mul, 8 add, 2 max, 3 compares.
K1_OPS = 22
# K1' (mt_hit) leaves its test early. A pair rejected at det > 0 costs 15
# (p = d x e2: 6 mul, 3 sub; det: 3 mul, 2 add; 1 compare); at the u test
# 27 (1 reciprocal, 3 sub, 4 mul, 2 add, 2 compares more); at the v test
# 45 (q: 6 mul, 3 sub; v: 4 mul, 2 add; u + v; 2 compares more); past it
# 53 (t: 4 mul, 2 add; 2 compares more).
MT_EXIT_OPS = (15, 27, 45, 53)
# H100 SXM peaks (data sheet): 67 TFLOP/s FP32 counts an FMA as 2, so the
# kernels' FMA-free instructions issue at half that; 3.35 TB/s HBM
PEAK_FP32_OPS = 33.5e12
PEAK_BYTES = 3.35e12


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


def median_ms(fn, reps):
    return float(np.median(cuda_times_ms(fn, reps)))


def reset_counts():
    plist.plist_super.launches = 0
    plist.plist_super_mt.launches = 0


def counts():
    return {"plist_super": plist.plist_super.launches,
            "plist_super_mt": plist.plist_super_mt.launches}


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


def build_windows(scene, win_rows, device):
    mwin = plist.build_morton_windows(scene.tri_corners(), win_rows,
                                      device=device)
    return plist.attach_resolve(plist.attach_so(mwin), scene.shade_rows)


def compare_with_plain(name, kernel_out, plain_fn, args, n_units, win_rows,
                       device, every=EVERY, **plain_kw):
    """Run the plain version on every `every`-th gate (or bundle) of
    `args` (key, sid, bits, rows, *[3, N] ray arrays, t0) and hold the
    kernel's outputs to it exactly. Returns the max |dt| over the plain
    hits."""
    best_t, best_slot, stats = kernel_out
    key, sid, bits, rows, *rays, t0 = args
    sel = torch.arange(0, n_units, every, device=device)
    lanes = (sel[:, None] * plist.GATE
             + torch.arange(plist.GATE, device=device)).reshape(-1)
    ref_t, ref_slot, ref_stats = plain_fn(
        key[sel].contiguous(), sid[sel].contiguous(), bits[sel].contiguous(),
        rows, *(r[:, lanes].contiguous() for r in rays), t0[lanes],
        win_rows=win_rows, **plain_kw)
    bad_t = int((best_t[lanes] != ref_t).sum())
    bad_slot = int((best_slot[lanes] != ref_slot).sum())
    bad_stats = int((stats[sel] != ref_stats).sum())
    hit = ref_slot >= 0
    err = float((best_t[lanes] - ref_t)[hit].abs().max()) \
        if bool(hit.any()) else 0.0
    say(name, f"{sel.numel()} of {n_units} units against the plain version "
        f"(tolerance: exact): t mismatches {bad_t}, slot mismatches "
        f"{bad_slot}, stats mismatches {bad_stats}, max |dt| {err}")
    if bad_t or bad_slot or bad_stats:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             "version")
    return err


def n_tests(stats, win_rows):
    """Ray-triangle pairs a call tested: the windows it needed."""
    return int(stats[:, 1].sum()) * win_rows * 8 * plist.GATE


def mt_ops(tests, tally):
    """K1''s FP32 operations on these inputs: each tested pair weighted
    by the early exit it takes (tally: the pairs that pass det, u, v)."""
    passed = [tests, *(int(x) for x in tally)]
    left = [passed[i] - passed[i + 1] for i in range(3)] + [passed[3]]
    return sum(c * w for c, w in zip(left, MT_EXIT_OPS))


def bound(args, stats, ops):
    """(bound ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once) over the HBM rate
    and its FP32 operations `ops` over the FMA-free issue rate."""
    n = args[-1].numel()
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + n * 8 + stats.numel() * 4
    ops_ms = ops / PEAK_FP32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def run_frames(render, warmup, frames):
    """Warm-up and timed frames with the launch counts from 0 before the
    first: (frame ms list, host wall ms per frame, counts, last image)."""
    reset_counts()
    for _ in range(warmup):
        render()
    torch.cuda.synchronize()
    wall = time.perf_counter()
    ms = cuda_times_ms(render, frames)
    wall = (time.perf_counter() - wall) / frames * 1e3
    got = counts()
    img = render()
    torch.cuda.synchronize()
    return ms, wall, got, img


def check_counts(phase, got, want):
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, want {want}")


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
    mwin = build_windows(scene, WIN_ROWS, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    say("scene", f"{scene.num_tris} triangles, {mwin.tris.shape[0]} slots, "
        f"{mwin.num_windows} windows, {scene.nbytes() + mwin.nbytes()} "
        f"device bytes of scene state, host build {build_s:.2f} s")
    cam = Camera.create(POS, FWD, device=device)
    opts = RenderOptions(width=SIZE, height=SIZE)
    n = SIZE * SIZE
    n_gates = n // plist.GATE
    launches = {}    # path -> that path's frames' launch counts

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
    k1_err = compare_with_plain("kernel", (best_t, best_slot, stats),
                                plist.plist_super_reference, k_args,
                                n_gates, WIN_ROWS, device)

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

    # 6. the normal frame, through the public entry point
    frame_ms, wall, got, img = run_frames(
        lambda: render_image(scene, cam, opts, mwin), WARMUP, FRAMES)
    check_counts("frame", got, {"plist_super": WARMUP + FRAMES,
                                "plist_super_mt": 0})
    launches["normal"] = got
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
        f"fraction {hit_frac}, launches {got}")

    # the split, each part timed alone on the same inputs
    def resolve_shade():
        slots = _unblockify(best_slot, SIZE, SIZE, plist.GH, plist.GW)
        r = plist._resolve_winners(mwin, slots, orig, dirs, stats)
        return torch.where(r["hit"][:, None], normal_color(r["snormal"]),
                           opts.background)
    split = {
        "rays": median_ms(
            lambda: generate_rays(cam_matrix(cam, SIZE), SIZE, SIZE), 20),
        "prepass": median_ms(prepass, 20),
        "kernel": median_ms(
            lambda: plist.plist_super(*k_args, win_rows=WIN_ROWS), 20),
        "resolve+shade": median_ms(resolve_shade, 20),
    }
    say("frame", "split (median ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    k1_plain_ms = median_ms(
        lambda: plist.plist_super_reference(*k_args, win_rows=WIN_ROWS), 3)
    wpg = float(stats[:, 1].float().mean())
    say("frame", f"windows per gate {wpg:.3f} (max {int(stats[:, 1].max())}),"
        f" supers per gate {float(stats[:, 3].float().mean()):.3f}, triangle "
        f"tests per ray {wpg * WIN_ROWS * 8:.1f}")
    k1_tests = n_tests(stats, WIN_ROWS)
    k1_bound, k1_by = bound(k_args, stats, k1_tests * K1_OPS)
    say("frame", f"K1 at {n_gates} gates: kernel {split['kernel']:.4f} ms, "
        f"plain torch version {k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms "
        f"({k1_by}; {k1_tests} tests)")

    # 7. the soup at win_rows 8
    t = time.perf_counter()
    soup = random_tri_soup(N_TRIS, seed=0, extent=10.0, tri_size=0.01,
                           device=device).bake_shading()
    swin = build_windows(soup, SOUP_WIN_ROWS, device)
    torch.cuda.synchronize()
    say("soup", f"{soup.num_tris} triangles, {swin.num_windows} windows at "
        f"win_rows {SOUP_WIN_ROWS}, host build "
        f"{time.perf_counter() - t:.2f} s")
    scam = Camera.create(SOUP_POS, SOUP_FWD, device=device)
    s_orig, s_dirs = generate_rays(cam_matrix(scam, SIZE), SIZE, SIZE)
    s_dir_b = _blockify(s_dirs, SIZE, SIZE, plist.GH, plist.GW)
    s_args = (*plist.gate_lists_super(swin.win_bnd, s_dir_b, s_orig[0]),
              so_combine(swin.so_base, s_orig[0]), s_dir_b.T.contiguous(), t0)
    s_out = plist.plist_super(*s_args, win_rows=SOUP_WIN_ROWS)
    torch.cuda.synchronize()
    k1_err = max(k1_err, compare_with_plain(
        "soup", s_out, plist.plist_super_reference, s_args, n_gates,
        SOUP_WIN_ROWS, device))
    s_ms, _, got, s_img = run_frames(
        lambda: render_image(soup, scam, opts, swin), 2, 10)
    check_counts("soup", got, {"plist_super": 12, "plist_super_mt": 0})
    launches["soup"] = got
    if not bool(torch.isfinite(s_img).all()):
        raise AssertionError("soup: non-finite pixels")
    s_stats = s_out[2]
    s_med = float(np.median(s_ms))
    say("soup", f"{SIZE}x{SIZE} normal: median {s_med:.4f} ms over 10 frames "
        f"(min {min(s_ms):.4f}, max {max(s_ms):.4f}), "
        f"{n / s_med * 1e3:.6g} rays/s; windows per gate "
        f"{float(s_stats[:, 1].float().mean()):.3f} (max "
        f"{int(s_stats[:, 1].max())}), supers per gate "
        f"{float(s_stats[:, 3].float().mean()):.3f}; K1 "
        f"{median_ms(lambda: plist.plist_super(*s_args, win_rows=SOUP_WIN_ROWS), 10):.4f} ms")
    del soup, swin, s_args, s_out

    # 8. K1' on Morton-sorted random rays, half of the lanes dead
    rng = np.random.default_rng(0)
    r_orig = torch.as_tensor(rng.uniform(-12, 12, (n, 3)).astype(np.float32),
                             device=device)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    r_dirs = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                             device=device)
    r_alive = torch.arange(n, device=device) % 2 == 0
    _, ro, rd, ra = sort_wave(r_orig, r_dirs, r_alive)

    r_args = plist.bundle_kernel_args(mwin, ro, rd, active=ra)
    r_out = plist.plist_super_mt(*r_args, win_rows=WIN_ROWS)
    torch.cuda.synchronize()
    mt_err = compare_with_plain("K1'", r_out, plist.plist_super_mt_reference,
                                r_args, n_gates, WIN_ROWS, device)
    r_stats = r_out[2]
    live_b = ra.reshape(-1, plist.GATE).any(dim=1)
    say("K1'", f"windows per bundle: live bundles "
        f"{float(r_stats[live_b, 1].float().mean()):.1f}, all-dead bundles "
        f"{float(r_stats[~live_b, 1].float().mean()):.1f} (the windows whose "
        f"key is 0); kernel "
        f"{median_ms(lambda: plist.plist_super_mt(*r_args, win_rows=WIN_ROWS), 3):.4f} ms")

    # 9. oracle for K1'
    rrec = plist._resolve_winners(mwin, r_out[1], ro, rd, r_stats)
    live = torch.nonzero(ra).squeeze(1)
    pick = live[torch.as_tensor(np.random.default_rng(1).choice(
        live.numel(), ORACLE_PIXELS, replace=False), device=device)]
    bf_t = bruteforce_hits(scene, ro[pick], rd[pick])
    bf_hit = torch.isfinite(bf_t)
    hit = rrec["hit"][pick]
    mismatch = float((hit != bf_hit).float().mean())
    both = hit & bf_hit
    t_ok = bool(torch.allclose(rrec["t"][pick][both], bf_t[both], rtol=1e-5,
                               atol=1e-6))
    say("K1' oracle", f"{ORACLE_PIXELS} live rays vs brute force: hit "
        f"mismatch {mismatch} (< 1e-3), {int(both.sum())} common hits, t "
        f"rtol 1e-5: {'ok' if t_ok else 'FAIL'}")
    if mismatch >= 1e-3 or not t_ok or not bool(both.any()):
        raise AssertionError("K1' hits disagree with the brute force")
    del r_args, r_out, rrec

    # 10. the mirror frame
    m_opts = RenderOptions(width=SIZE, height=SIZE, mode="mirror", bounces=2)
    m_ms, m_wall, got, m_img = run_frames(
        lambda: render_image(scene, cam, m_opts, mwin), 2, 10)
    check_counts("mirror", got, {"plist_super": 12, "plist_super_mt": 12})
    launches["mirror"] = got
    if not bool(torch.isfinite(m_img).all()):
        raise AssertionError("mirror: non-finite pixels")
    m_med = float(np.median(m_ms))
    say("mirror", f"{SIZE}x{SIZE} bounces 2: median {m_med:.4f} ms over 10 "
        f"frames (min {min(m_ms):.4f}, max {max(m_ms):.4f}; host wall "
        f"{m_wall:.4f} ms/frame), launches {got}")

    # the bounce wave of shade_mirror, rebuilt with the functions the frame
    # runs (all lanes alive at bounce 0) to time each part alone
    prim = intersect_scene(scene, mwin, orig, dirs, m_opts)
    b_alive, b_orig, b_dirs = mirror_wave(
        prim, orig, dirs, torch.ones((n,), dtype=torch.bool, device=device))
    inv, bo, bd, ba = sort_wave(b_orig, b_dirs, b_alive)
    b_args = plist.bundle_kernel_args(mwin, bo, bd, active=ba)
    b_out = plist.plist_super_mt(*b_args, win_rows=WIN_ROWS)
    torch.cuda.synchronize()
    tally = torch.zeros(3, dtype=torch.int64, device=device)
    mt_err = max(mt_err, compare_with_plain(
        "mirror K1'", b_out, plist.plist_super_mt_reference, b_args, n_gates,
        WIN_ROWS, device, every=1, tally=tally))

    def resolve_shade():
        r = plist._resolve_winners(mwin, b_out[1], bo, bd, b_out[2])
        h = r["hit"][inv] & b_alive
        return torch.where(h[:, None], 0.8 * normal_color(r["snormal"][inv]),
                           0.2)
    m_split = {
        "primary": median_ms(lambda: intersect_scene(scene, mwin, orig, dirs,
                                                     m_opts), 10),
        "sort": median_ms(lambda: sort_wave(b_orig, b_dirs, b_alive), 10),
        "bundle prepass": median_ms(
            lambda: plist.bundle_kernel_args(mwin, bo, bd, active=ba), 10),
        "K1'": median_ms(
            lambda: plist.plist_super_mt(*b_args, win_rows=WIN_ROWS), 10),
        "resolve+shade": median_ms(resolve_shade, 10),
    }
    say("mirror", "split (median ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in m_split.items()))
    b_stats = b_out[2]
    n_live = int(b_alive.sum())
    b_tests = n_tests(b_stats, WIN_ROWS)
    say("mirror", f"bounce wave: {n_live} live lanes of {n}, "
        f"{int(b_out[1].ge(0).sum())} bounce hits; windows per bundle "
        f"{float(b_stats[:, 1].float().mean()):.3f} (max "
        f"{int(b_stats[:, 1].max())}), supers per bundle "
        f"{float(b_stats[:, 3].float().mean()):.3f}; tests per live ray "
        f"{b_tests / max(n_live, 1):.1f}")
    mt_plain_ms = median_ms(
        lambda: plist.plist_super_mt_reference(*b_args, win_rows=WIN_ROWS),
        1)
    b_ops = mt_ops(b_tests, tally)
    mt_bound, mt_by = bound(b_args, b_stats, b_ops)
    mt_ms = m_split["K1'"]
    say("mirror", f"K1' early exits: of {b_tests} tested pairs "
        f"{int(tally[0])} pass det > 0, {int(tally[1])} also the u test, "
        f"{int(tally[2])} also the v test; {b_ops} FP32 operations "
        f"({b_ops / max(b_tests, 1):.3f} per pair; {MT_EXIT_OPS[-1]} on the "
        f"full path would give {b_tests * MT_EXIT_OPS[-1]})")
    say("mirror", f"K1' at {n_gates} bundles: kernel {mt_ms:.4f} ms, "
        f"plain torch version {mt_plain_ms:.4f} ms, bound {mt_bound:.4f} ms "
        f"({mt_by}; {b_tests} tests)")
    del b_args, b_out

    # 11. the path frame
    spp = 4
    p_opts = RenderOptions(width=SIZE, height=SIZE, mode="path", spp=spp,
                           bounces=2, background=1.0)
    p_ms, p_wall, got, p_img = run_frames(
        lambda: render_image(scene, cam, p_opts, mwin,
                             generator=torch.Generator(device=device)
                             .manual_seed(0)), 1, 5)
    check_counts("path", got, {"plist_super": 6 * spp,
                               "plist_super_mt": 6 * spp})
    launches["path"] = got
    mean = float(p_img.mean())
    if not bool(torch.isfinite(p_img).all()) or not 0.0 < mean <= 1.0:
        raise AssertionError(f"path: image finite "
                             f"{bool(torch.isfinite(p_img).all())}, mean "
                             f"{mean}")
    p_med = float(np.median(p_ms))
    rays = spp * 2 * n   # per sample a primary and a bounce wave of n lanes
    say("path", f"{SIZE}x{SIZE} spp {spp} bounces 2: median {p_med:.4f} ms "
        f"over 5 frames (min {min(p_ms):.4f}, max {max(p_ms):.4f}; host wall "
        f"{p_wall:.4f} ms/frame), {n * spp / p_med * 1e3:.6g} paths/s, "
        f"{rays / p_med * 1e3:.6g} traversal rays/s (wave lanes, dead "
        f"bounce lanes included), image mean {mean:.6f}, "
        f"launches {got}")

    print(json.dumps({"kernels": [
        {"name": "plist_super", "route": "cuda",
         "source": "clpathtracer_tpu_torch/ops/csrc/plist_super.cu",
         "replaces": "clpathtracer_tpu/ops/plist.py:955",
         "launches": launches["normal"]["plist_super"],
         "launches_by_path": {p: c["plist_super"]
                              for p, c in launches.items()},
         "max_abs_err": k1_err,
         "ms": split["kernel"], "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "plist_super_mt", "route": "cuda",
         "source": "clpathtracer_tpu_torch/ops/csrc/plist_super.cu",
         "replaces": "clpathtracer_tpu/ops/plist.py:955",
         "launches": launches["mirror"]["plist_super_mt"],
         "launches_by_path": {p: c["plist_super_mt"]
                              for p, c in launches.items()},
         "max_abs_err": mt_err,
         "ms": mt_ms, "plain_ms": mt_plain_ms,
         "bound_ms": mt_bound, "bound_by": mt_by, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
