#!/usr/bin/env python3
"""Run the PyTorch port's paths once on one CUDA GPU and check them.

    python3 chip_smoke.py

Phases, one line or more each (any failure raises and the exit code is
not 0):

1. device: require CUDA, print the card's name and power limit (nvidia-smi),
   turn TF32 off;
2. build: compile clpathtracer_tpu_torch/ops/csrc/*.cu with nvcc (sm_90a),
   one nvcc per source, all started together, and load the libraries;
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
   bundles (exact; that run is also the plain version's time), which also
   counts the tested pairs that leave the test at each early exit for
   K1''s bound; the split into primary / sort / bundle prepass / K1' /
   resolve+shade, and the bounce wave's live lanes, windows per bundle and
   tests per live ray;
11. path frame: 512x512, spp 4, bounces 2, no NEE, background 1.0,
   generator seeded 0, 1 warm-up and 5 timed frames; K1 and K1' each rise
   by 4 per frame; the image is finite with its mean in (0, 1]; paths/s
   and traversal rays/s.

The kd-tree route (no windows: the stream engine, kernel K3):

12. kd scenes: the native SAH builder (g++ at first use) on the 1M terrain
   at bench.py's terrain tuning (depth 11, leaf 3072) and the 1M soup at
   its soup tuning (depth 14, leaf 512), window tables, SO tables and the
   8-wide supernode table on the card; build seconds, nodes, leaves,
   largest leaf, windows, supernodes and the wide table's build seconds;
13. K3 against its plain version on every 8th tile, exact in best t, best
   slot and all five stats lanes, in four forms: SO + strips with 512-lane
   gates (terrain, tile 2048, the normal frame's call), SO + AABB cull
   (soup, tile 512, the soup frame's call), SO + AABB cull + corner frustum
   (soup, tile 512, a kernel call only) and general Moller-Trumbore +
   active mask + AABB cull (terrain, tile 2048, the mirror bounce wave,
   rebuilt with intersect_scene, mirror_wave and sort_wave; the plain run
   also counts the early exits of its tested pairs);
14. oracles: 4096 primary pixels of the kd route and 4096 live lanes of its
   mirror bounce wave against the brute force, at phases 5 and 9's limits;
15. kd frames: normal terrain (tile 2048, strips; 2 warm-up, 20 timed),
   normal soup (tile 512, cull only; 2 + 10) and mirror terrain (tile 2048,
   bounces 2; 2 + 10); K3 rises by 1 per normal frame and 2 per mirror
   frame, K1 and K1' by 0. For each: frame median, the split, nodes
   visited, windows streamed and culled per tile, tests per ray, K3's time
   beside its bound; the plain K3's time on the normal terrain frame's
   call.

The bf16 preview (kernel K4, K3's kernel with a bf16 dense test) and the
queue engine (kernel K5):

16. K4 against its plain version on every 8th tile, exact in best t, best
   slot and all five stats lanes, on the inputs of its three calls: the
   terrain primaries (tile 2048, MT + AABB cull, the bf16 frame's own
   call), the soup primaries (tile 512) and the mirror bounce wave of phase
   13 (MT + active + cull; with its hit agreement against K3's f32 run);
   K4's time beside its bound;
17. bf16 frames through render_image(RenderOptions(precision="bf16")):
   normal terrain (2 warm-up, 20 timed), normal soup (2 + 10), mirror
   terrain (2 + 10); K4 rises by 1 per normal frame and 2 per mirror frame,
   K3, K1 and K1' by 0; images finite. For each: frame median, the split,
   and the primary hit agreement with the f32 frame (printed, not gated:
   the preview is lossy by design);
18. K5 through traverse_packet(engine="queue") on three inputs (terrain
   primaries SO + cull at tile 2048, soup primaries SO + cull at 512, the
   mirror bounce wave MT + active + cull), counted (3 launches, nothing
   else); then K5 against its plain version on every 8th tile of each,
   exact in t, slot and all five lanes;
19. K5 beside K3 (its cull form, no strips or frustum) on the same inputs:
   hits and best t equal, slots equal but at exact-t ties; both times,
   taken in turns, beside the bound, with windows tested and culled per
   tile; and the strips frame's K3 time of phase 15.

The v1 walks (kernels K6a, K6b and K9, ops/csrc/packet_v1.cu):

20. the stack guard: a degenerate 102-node table whose walk stays inside
   the 128-entry stack runs, one of 202 nodes raises (K6b), and the same
   with supernode chains of 12 and 32 rows (K9); the byte rule of
   engine="legacy" on both 1M trees (K6b: the records do not fit its
   budget, so K6a is reached only through its op-level entry,
   packet_legacy(resident=True));
21. K6b through traverse_packet(engine="legacy") and K9 through
   engine="wide" on three inputs at full width: the terrain primaries
   (tile 2048), the soup primaries (tile 512) and the mirror bounce wave
   of phase 13 (tile 2048; the v1 engines ignore its active mask, as the
   JAX package's do), counted (3 launches each, nothing else); K6a through
   packet_legacy(resident=True) on the same inputs, counted (3); 4096
   primary pixels and 4096 live bounce lanes of each kernel's results
   against the brute force, at phases 5 and 9's limits;
22. each kernel against its plain version, exact in best t, best slot and
   all five stats lanes, on every 8th tile of the primaries and every
   16th tile of the mirror wave (the plain walks there stream most of the
   tree's windows); the plain runs count the pairs tested and their early
   exits for the bounds;
23. K3 (its MT form with the AABB cull: the same records, the same rays,
   the same active mask on the mirror wave) and the three v1 kernels timed
   in turns on each input, with node pops and windows (K6a: leaves) per
   tile, mean and max, and each v1 kernel's bound.

The card's name and power limit are printed again before the kernels
line. The line before the last is a JSON object of the kernels: each
kernel's launches are those of the frames of the path that gives its ms
(K1 the normal frame, K1' the mirror frame, K3 the kd route's normal
terrain frame, K4 the bf16 normal terrain frame, K5 the three queue
calls, K6b and K9 the six v1 traverse_packet calls, K6a its three
op-level calls), with every path's own count beside them. The last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np
import torch

from clpathtracer_tpu_torch.accel import sah, wide
from clpathtracer_tpu_torch.core.camera import (Camera, cam_matrix,
                                                generate_rays)
from clpathtracer_tpu_torch.ops import packet, plist
from clpathtracer_tpu_torch.ops._cuda import load_kernels
from clpathtracer_tpu_torch.ops.packet import (BIG, _blockify, _unblockify,
                                               so_combine)
from clpathtracer_tpu_torch.ops.traverse_fast import _mt_pre
from clpathtracer_tpu_torch.render.integrator import (RenderOptions,
                                                      _surface,
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
# bench.py's SCENE_TUNING: the JAX package's kd configuration, taken so that
# both packages run the same trees (not tuned on this card)
TERRAIN_KD = dict(max_depth=11, leaf_size=3072, tile=2048)
SOUP_KD = dict(max_depth=14, leaf_size=512, tile=512)
WARMUP, FRAMES = 2, 20
ORACLE_PIXELS = 4096
EVERY = 8            # plain versions run on every 8th gate, bundle or tile
# FP32 operations per ray-triangle test, counted from the tests' sources
# (ops/csrc/pair_tests.cuh). so_hit runs all of its test for every pair:
# 9 mul, 8 add, 2 max, 3 compares.
K1_OPS = 22
# mt_hit leaves its test early. A pair rejected at det > 0 costs 15
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


def timed(fn):
    """(fn's result, its device time in ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def reset_counts():
    plist.plist_super.launches = 0
    plist.plist_super_mt.launches = 0
    packet.packet_stream.launches = 0
    packet.packet_stream.bf16_launches = 0
    packet.packet_queue.launches = 0
    packet.packet_legacy.launches = 0
    packet.packet_legacy.resident_launches = 0
    packet.packet_wide.launches = 0


def counts():
    return {"plist_super": plist.plist_super.launches,
            "plist_super_mt": plist.plist_super_mt.launches,
            "packet_stream": packet.packet_stream.launches,
            "packet_stream_bf16": packet.packet_stream.bf16_launches,
            "packet_queue": packet.packet_queue.launches,
            "packet_legacy": packet.packet_legacy.launches,
            "packet_legacy_resident": packet.packet_legacy.resident_launches,
            "packet_wide": packet.packet_wide.launches}


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


def check_oracle(phase, scene, rec, orig, dirs, pick, max_mismatch, rtol,
                 atol):
    """Hold a record's hits on the lanes `pick` to the brute force."""
    bf_t = bruteforce_hits(scene, orig[pick], dirs[pick])
    bf_hit = torch.isfinite(bf_t)
    hit = rec["hit"][pick]
    mismatch = float((hit != bf_hit).float().mean())
    both = hit & bf_hit
    rel = ((rec["t"][pick] - bf_t).abs() / bf_t.abs())[both]
    t_ok = bool(torch.allclose(rec["t"][pick][both], bf_t[both], rtol=rtol,
                               atol=atol))
    say(phase, f"{pick.numel()} lanes vs brute force over {scene.num_tris} "
        f"triangles: hit mismatch {mismatch} (< {max_mismatch}), "
        f"{int(both.sum())} common hits, max rel dt "
        f"{float(rel.max()) if rel.numel() else 0.0} (rtol {rtol}): "
        f"{'ok' if t_ok else 'FAIL'}")
    if mismatch >= max_mismatch or not t_ok or not bool(both.any()):
        raise AssertionError(f"{phase}: hits disagree with the brute force")


def build_windows(scene, win_rows, device):
    mwin = plist.build_morton_windows(scene.tri_corners(), win_rows,
                                      device=device)
    return plist.attach_resolve(plist.attach_so(mwin), scene.shade_rows)


def compare_with_plain(name, kernel_out, plain_fn, args, n_units, win_rows,
                       device, every=EVERY, **plain_kw):
    """Run the plain version on every `every`-th gate (or bundle) of
    `args` (key, sid, bits, rows, *[3, N] ray arrays, t0) and hold the
    kernel's outputs to it exactly. Returns (the max |dt| over the plain
    hits, the plain run's ms)."""
    best_t, best_slot, stats = kernel_out
    key, sid, bits, rows, *rays, t0 = args
    sel = torch.arange(0, n_units, every, device=device)
    lanes = (sel[:, None] * plist.GATE
             + torch.arange(plist.GATE, device=device)).reshape(-1)
    (ref_t, ref_slot, ref_stats), plain_ms = timed(lambda: plain_fn(
        key[sel].contiguous(), sid[sel].contiguous(), bits[sel].contiguous(),
        rows, *(r[:, lanes].contiguous() for r in rays), t0[lanes],
        win_rows=win_rows, **plain_kw))
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
    return err, plain_ms


def compare_k3(name, kernel_out, args, kw, every=EVERY, tally=None,
               plain=packet.packet_stream_reference):
    """Run the plain version (K3's, else `plain`: K4 takes K3's with
    precision="bf16" in kw, K5 packet_queue_reference) on every `every`-th
    tile of the call (args, kw) and hold the kernel's outputs to it
    exactly. Returns (max |dt| over the plain hits, the plain run's ms, its
    stats)."""
    best_t, best_slot, stats = kernel_out
    nodes_i, nodes_f, rows, orig_t, dir_t, act = args
    tile = kw["tile"]
    device = act.device
    n_tiles = act.shape[0] // tile
    sel = torch.arange(0, n_tiles, every, device=device)
    lanes = (sel[:, None] * tile
             + torch.arange(tile, device=device)).reshape(-1)
    sub = {k: (v[sel].contiguous() if k in ("frustum", "masks", "ten")
               else v) for k, v in kw.items()}
    (ref_t, ref_slot, ref_stats), plain_ms = timed(
        lambda: plain(
            nodes_i, nodes_f, rows, orig_t[:, lanes].contiguous(),
            dir_t[:, lanes].contiguous(), act[lanes].contiguous(),
            tally=tally, **sub))
    bad_t = int((best_t[lanes] != ref_t).sum())
    bad_slot = int((best_slot[lanes] != ref_slot).sum())
    bad_stats = int((stats[sel] != ref_stats).sum())
    hit = ref_slot >= 0
    err = float((best_t[lanes] - ref_t)[hit].abs().max()) \
        if bool(hit.any()) else 0.0
    say(name, f"{sel.numel()} of {n_tiles} tiles of {tile} rays against the "
        f"plain version (tolerance: exact): t mismatches {bad_t}, slot "
        f"mismatches {bad_slot}, stats mismatches {bad_stats} (5 lanes), "
        f"max |dt| {err}, {int(hit.sum())} hits; plain {plain_ms:.1f} ms")
    if bad_t or bad_slot or bad_stats:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             "version")
    return err, plain_ms, ref_stats


def n_tests(stats, win_rows):
    """Ray-triangle pairs a K1 call tested: the windows it needed."""
    return int(stats[:, 1].sum()) * win_rows * 8 * plist.GATE


def k3_tests(stats, tile, n_strips=0):
    """Ray-triangle pairs a K3 call tested: 128 records per dense
    execution, against the 512 lanes of a gate in half-gate mode, else
    against the tile's active lanes."""
    st = stats.to(torch.int64)
    if n_strips and tile // n_strips == packet.GATE_LANES:
        return int(st[:, 4].sum()) * 128 * packet.GATE_LANES
    return int((st[:, 1] * st[:, 2]).sum()) * 128


def mt_ops(tests, tally):
    """MT FP32 operations of `tests` pairs: each tested pair weighted by
    the early exit it takes (tally: the pairs that pass det, u, v)."""
    passed = [tests, *(int(x) for x in tally)]
    left = [passed[i] - passed[i + 1] for i in range(3)] + [passed[3]]
    return sum(c * w for c, w in zip(left, MT_EXIT_OPS))


def mt_bound(args, kw, out, ref_stats, tally):
    """The bound of an MT call of K3, K4 or K5: its tested pairs (k3_tests)
    weighted by the early exits that the plain run counted on its tiles
    (tally), applied to all pairs. Returns (bound ms, bound_by, tested
    pairs, pairs the plain run tested, FP32 operations)."""
    tests = k3_tests(out[2], kw["tile"])
    sample = k3_tests(ref_stats, kw["tile"])
    ops = int(mt_ops(sample, tally) * tests / max(sample, 1))
    return (*bound(k3_tensors(args, kw, out), ops), tests, sample, ops)


def turns_ms(fns, reps):
    """Median device ms of each of fns, timed in turns: in order on even
    repetitions, in reverse on odd ones."""
    acc = [[] for _ in fns]
    for i in range(reps):
        order = list(range(len(fns)))
        for j in (order if i % 2 == 0 else order[::-1]):
            acc[j].extend(cuda_times_ms(fns[j], 1))
    return [float(np.median(a)) for a in acc]


def bound(tensors, ops):
    """(bound ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once: `tensors`) over the
    HBM rate and its FP32 operations `ops` over the FMA-free issue rate."""
    nbytes = sum(a.numel() * a.element_size() for a in tensors
                 if a is not None)
    ops_ms = ops / PEAK_FP32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes")


def k3_tensors(args, kw, out):
    return [*args, *(kw.get(k) for k in ("cbnd", "frustum", "masks", "ten")),
            *out]


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
    want = {"plist_super": 0, "plist_super_mt": 0, "packet_stream": 0,
            "packet_stream_bf16": 0, "packet_queue": 0, "packet_legacy": 0,
            "packet_legacy_resident": 0, "packet_wide": 0, **want}
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, want {want}")


def tile_stats_line(stats, tile):
    st = stats.to(torch.float64)
    return (f"per tile: nodes visited {float(st[:, 0].mean()):.2f} (max "
            f"{int(st[:, 0].max())}), windows streamed "
            f"{float(st[:, 1].mean()):.2f} (max {int(st[:, 1].max())}), "
            f"culled {float(st[:, 3].mean()):.2f}, dense executions "
            f"{float(st[:, 4].mean()):.2f}; {stats.shape[0]} tiles of {tile}")


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
    say("build", f"{lib.build_seconds:.2f} s nvcc (parallel) -> "
        f"{', '.join(p.name for p in lib.paths)}")
    for line in lib.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            say("build", line.strip())

    kernels = smoke(device)
    print(card, flush=True)   # again, where the end of a long log shows it
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def smoke(device):
    """Phases 3-19 on `device`; returns the kernels line's entries."""
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
    k1_err, _ = compare_with_plain("kernel", (best_t, best_slot, stats),
                                   plist.plist_super_reference, k_args,
                                   n_gates, WIN_ROWS, device)

    # 5. independent oracle
    rec = plist.traverse_plist(mwin, orig, dirs, (SIZE, SIZE))
    pix = torch.as_tensor(np.random.default_rng(0).choice(
        n, ORACLE_PIXELS, replace=False), device=device)
    check_oracle("oracle", scene, rec, orig, dirs, pix, 2e-3, 1e-4, 1e-5)

    # 6. the normal frame, through the public entry point
    frame_ms, wall, got, img = run_frames(
        lambda: render_image(scene, cam, opts, mwin), WARMUP, FRAMES)
    check_counts("frame", got, {"plist_super": WARMUP + FRAMES})
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
    k1_bound, k1_by = bound([*k_args, best_t, best_slot, stats],
                            k1_tests * K1_OPS)
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
        SOUP_WIN_ROWS, device)[0])
    s_ms, _, got, s_img = run_frames(
        lambda: render_image(soup, scam, opts, swin), 2, 10)
    check_counts("soup", got, {"plist_super": 12})
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
    del swin, s_args, s_out

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
    mt_err, _ = compare_with_plain("K1'", r_out,
                                   plist.plist_super_mt_reference, r_args,
                                   n_gates, WIN_ROWS, device)
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
    check_oracle("K1' oracle", scene, rrec, ro, rd, pick, 1e-3, 1e-5, 1e-6)
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
    all_alive = torch.ones((n,), dtype=torch.bool, device=device)
    prim = intersect_scene(scene, mwin, orig, dirs, m_opts)
    b_alive, b_orig, b_dirs, _ = mirror_wave(scene, prim, orig, dirs,
                                             all_alive)
    inv, bo, bd, ba = sort_wave(b_orig, b_dirs, b_alive)
    b_args = plist.bundle_kernel_args(mwin, bo, bd, active=ba)
    b_out = plist.plist_super_mt(*b_args, win_rows=WIN_ROWS)
    torch.cuda.synchronize()
    tally = torch.zeros(3, dtype=torch.int64, device=device)
    err, mt_plain_ms = compare_with_plain(
        "mirror K1'", b_out, plist.plist_super_mt_reference, b_args, n_gates,
        WIN_ROWS, device, every=1, tally=tally)
    mt_err = max(mt_err, err)

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
    b_ops = mt_ops(b_tests, tally)
    mt_bound, mt_by = bound([*b_args, *b_out], b_ops)
    mt_ms = m_split["K1'"]
    say("mirror", f"K1' early exits: of {b_tests} tested pairs "
        f"{int(tally[0])} pass det > 0, {int(tally[1])} also the u test, "
        f"{int(tally[2])} also the v test; {b_ops} FP32 operations "
        f"({b_ops / max(b_tests, 1):.3f} per pair; {MT_EXIT_OPS[-1]} on the "
        f"full path would give {b_tests * MT_EXIT_OPS[-1]})")
    say("mirror", f"K1' at {n_gates} bundles: kernel {mt_ms:.4f} ms, "
        f"plain torch version {mt_plain_ms:.4f} ms (the exactness run), "
        f"bound {mt_bound:.4f} ms ({mt_by}; {b_tests} tests)")
    del b_args, b_out, prim

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
    del mwin

    k3, ctx = kd_route(device, scene, soup, cam, scam, launches)
    k4 = preview_route(ctx, launches)
    k5 = queue_engine(ctx, launches)
    v1 = v1_engines(ctx, launches)
    return [
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
        k3, k4, k5, *v1,
    ]


def kd_route(device, scene, soup, cam, scam, launches):
    """Phases 12-15: the kd-tree route. Returns K3's kernels entry and what
    phases 16-19 reuse (scenes, trees, rays, the mirror bounce wave and
    K3's result on it)."""
    n = SIZE * SIZE

    # 12. kd scenes
    def build_tree(sc, cfg):
        t = time.perf_counter()
        tree = sah.build_kd_tree(sc.tri_corners(), max_depth=cfg["max_depth"],
                                 leaf_size=cfg["leaf_size"], device=device)
        host_s = time.perf_counter() - t
        tree = sah.attach_so_tables(tree)
        torch.cuda.synchronize()
        so_s = time.perf_counter() - t - host_s
        st = tree.stats()
        t = time.perf_counter()
        wt = wide.build_wide_table(tree)
        wide_s = time.perf_counter() - t
        if not np.array_equal(wt, tree.wide_table.cpu().numpy()):
            raise AssertionError("kd scene: the attached wide table differs")
        say("kd scene", f"{sc.num_tris} triangles, depth {cfg['max_depth']}, "
            f"leaf {cfg['leaf_size']}: host build {host_s:.2f} s (g++ "
            f"builder, leaf sort, window tables, wide table), SO tables "
            f"{so_s:.2f} s; {st['nodes']} nodes, "
            f"{st['leaves']} leaves, largest leaf "
            f"{st['max_tris_per_leaf']}, {st['leaf_tris']} leaf slots, "
            f"{st['windows']} windows, {wt.shape[0]} supernodes (wide table "
            f"{wide_s:.3f} s on the host), {tree.nbytes()} device bytes")
        return tree
    tree = build_tree(scene, TERRAIN_KD)
    stree = build_tree(soup, SOUP_KD)
    t_tile, s_tile = TERRAIN_KD["tile"], SOUP_KD["tile"]
    orig, dirs = generate_rays(cam_matrix(cam, SIZE), SIZE, SIZE)
    s_orig, s_dirs = generate_rays(cam_matrix(scam, SIZE), SIZE, SIZE)

    # 13. K3 against its plain version, four forms
    def k3_call(name, tr, o, d, image_shape, tile, **kw):
        args, kkw, layout = packet.stream_kernel_args(
            tr, o, d, image_shape, tile, **kw)
        out = packet.packet_stream(*args, **kkw)
        torch.cuda.synchronize()
        return args, kkw, layout, out
    n_args, n_kw, n_layout, n_out = k3_call(
        "strips", tree, orig, dirs, (SIZE, SIZE), t_tile,
        shared_origin=True, grid_dirs=True)
    if n_kw.get("n_strips") != t_tile // packet.GATE_LANES:
        raise AssertionError(f"terrain frame: strips {n_kw.get('n_strips')}"
                             ", want 512-lane gates")
    k3_err, _, _ = compare_k3("K3 SO strips", n_out, n_args, n_kw)
    c_args, c_kw, _, c_out = k3_call(
        "cull", stree, s_orig, s_dirs, (SIZE, SIZE), s_tile,
        shared_origin=True, grid_dirs=True, strips=False, frustum=False)
    k3_err = max(k3_err, compare_k3("K3 SO cull", c_out, c_args, c_kw)[0])
    f_args, f_kw, _, f_out = k3_call(
        "frustum", stree, s_orig, s_dirs, (SIZE, SIZE), s_tile,
        shared_origin=True, grid_dirs=True, strips=False)
    k3_err = max(k3_err, compare_k3("K3 SO cull+frustum", f_out, f_args,
                                    f_kw)[0])
    say("K3 SO cull+frustum", f"soup windows streamed per tile "
        f"{float(f_out[2][:, 1].float().mean()):.2f} with the frustum, "
        f"{float(c_out[2][:, 1].float().mean()):.2f} without")
    del f_args, f_kw, f_out

    m_opts = RenderOptions(width=SIZE, height=SIZE, mode="mirror", bounces=2,
                           packet_tile=t_tile)
    all_alive = torch.ones((n,), dtype=torch.bool, device=device)
    prim = intersect_scene(scene, None, orig, dirs, m_opts, tree=tree)
    b_alive, b_orig, b_dirs, _ = mirror_wave(scene, prim, orig, dirs,
                                             all_alive)
    inv, bo, bd, ba = sort_wave(b_orig, b_dirs, b_alive)
    b_args, b_kw, _, b_out = k3_call("mt", tree, bo, bd, None, t_tile,
                                     active=ba)
    tally = torch.zeros(3, dtype=torch.int64, device=device)
    err, b_plain_ms, b_ref_stats = compare_k3("K3 MT active", b_out, b_args,
                                              b_kw, tally=tally)
    k3_err = max(k3_err, err)

    # 14. oracles
    p_rec = packet.traverse_packet(tree, orig, dirs, (SIZE, SIZE), t_tile,
                                   shared_origin=True, grid_dirs=True)
    pix = torch.as_tensor(np.random.default_rng(2).choice(
        n, ORACLE_PIXELS, replace=False), device=device)
    check_oracle("kd oracle", scene, p_rec, orig, dirs, pix, 2e-3, 1e-4, 1e-5)
    b_rec = packet._resolve_stream_winners(tree, b_out[1], bo, bd, b_out[2])
    live = torch.nonzero(ba).squeeze(1)
    pick = live[torch.as_tensor(np.random.default_rng(3).choice(
        live.numel(), min(ORACLE_PIXELS, live.numel()), replace=False),
        device=device)]
    check_oracle("kd bounce oracle", scene, b_rec, bo, bd, pick, 1e-3, 1e-5,
                 1e-6)
    del p_rec, b_rec

    # 15. kd frames
    opts = RenderOptions(width=SIZE, height=SIZE, packet_tile=t_tile)
    k_ms, k_wall, got, img = run_frames(
        lambda: render_image(scene, cam, opts, tree=tree), WARMUP, FRAMES)
    check_counts("kd frame", got, {"packet_stream": WARMUP + FRAMES})
    launches["kd normal"] = got
    img_hit = float((img < 1.0).any(dim=-1).float().mean())
    if not bool(torch.isfinite(img).all()) or img_hit <= 0.99:
        raise AssertionError(f"kd frame: finite "
                             f"{bool(torch.isfinite(img).all())}, hit "
                             f"fraction {img_hit}")
    med = float(np.median(k_ms))
    say("kd frame", f"{SIZE}x{SIZE} normal, terrain, tile {t_tile}, strips: "
        f"median {med:.4f} ms over {FRAMES} frames (min {min(k_ms):.4f}, max "
        f"{max(k_ms):.4f}; host wall {k_wall:.4f} ms/frame), "
        f"{n / med * 1e3:.6g} rays/s, hit fraction {img_hit}, launches "
        f"{got}")

    def n_resolve_shade():
        slots = packet._to_wave_order(n_out[1], n_layout)
        r = packet._resolve_stream_winners(tree, slots, orig, dirs, n_out[2])
        nrm = _surface(scene, r, orig, dirs)[1]
        return torch.where(r["hit"][:, None], normal_color(nrm),
                           opts.background)
    k3_ms = median_ms(lambda: packet.packet_stream(*n_args, **n_kw), 20)
    n_split = {
        "rays": median_ms(
            lambda: generate_rays(cam_matrix(cam, SIZE), SIZE, SIZE), 20),
        "strip prepass": median_ms(lambda: packet.stream_kernel_args(
            tree, orig, dirs, (SIZE, SIZE), t_tile, shared_origin=True,
            grid_dirs=True), 20),
        "K3": k3_ms,
        "resolve+shade": median_ms(n_resolve_shade, 20),
    }
    say("kd frame", "split (median ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in n_split.items()))
    n_stats = n_out[2]
    n_tests_k3 = k3_tests(n_stats, t_tile, n_kw["n_strips"])
    say("kd frame", tile_stats_line(n_stats, t_tile) + f"; triangle tests "
        f"per ray {n_tests_k3 / n:.1f}")
    k3_plain, k3_plain_ms = timed(
        lambda: packet.packet_stream_reference(*n_args, **n_kw))
    if not torch.equal(k3_plain[2], n_stats):
        raise AssertionError("kd frame: the plain K3 over all tiles "
                             "disagrees with the kernel")
    k3_bound, k3_by = bound(k3_tensors(n_args, n_kw, n_out),
                            n_tests_k3 * K1_OPS)
    say("kd frame", f"K3 at {n // t_tile} tiles: kernel {k3_ms:.4f} ms, "
        f"plain torch version {k3_plain_ms:.4f} ms (all tiles, stats equal),"
        f" bound {k3_bound:.4f} ms ({k3_by}; {n_tests_k3} SO tests x "
        f"{K1_OPS})")

    s_opts = RenderOptions(width=SIZE, height=SIZE, packet_tile=s_tile,
                           packet_strips=False, packet_frustum=False)
    s_ms, s_wall, got, s_img = run_frames(
        lambda: render_image(soup, scam, s_opts, tree=stree), 2, 10)
    check_counts("kd soup", got, {"packet_stream": 12})
    launches["kd soup"] = got
    if not bool(torch.isfinite(s_img).all()):
        raise AssertionError("kd soup: non-finite pixels")
    s_med = float(np.median(s_ms))
    c_ms = median_ms(lambda: packet.packet_stream(*c_args, **c_kw), 10)
    c_tests = k3_tests(c_out[2], s_tile)
    c_bound, c_by = bound(k3_tensors(c_args, c_kw, c_out), c_tests * K1_OPS)
    say("kd soup", f"{SIZE}x{SIZE} normal, soup, tile {s_tile}, cull only: "
        f"median {s_med:.4f} ms over 10 frames (min {min(s_ms):.4f}, max "
        f"{max(s_ms):.4f}; host wall {s_wall:.4f} ms/frame), "
        f"{n / s_med * 1e3:.6g} rays/s; " + tile_stats_line(c_out[2], s_tile)
        + f"; tests per ray {c_tests / n:.1f}; K3 {c_ms:.4f} ms, bound "
        f"{c_bound:.4f} ms ({c_by})")
    del c_args, c_kw, c_out

    m_ms, m_wall, got, m_img = run_frames(
        lambda: render_image(scene, cam, m_opts, tree=tree), 2, 10)
    check_counts("kd mirror", got, {"packet_stream": 24})
    launches["kd mirror"] = got
    if not bool(torch.isfinite(m_img).all()):
        raise AssertionError("kd mirror: non-finite pixels")
    m_med = float(np.median(m_ms))
    say("kd mirror", f"{SIZE}x{SIZE} bounces 2, terrain, tile {t_tile}: "
        f"median {m_med:.4f} ms over 10 frames (min {min(m_ms):.4f}, max "
        f"{max(m_ms):.4f}; host wall {m_wall:.4f} ms/frame), launches {got}")

    def b_resolve_shade():
        r = packet._resolve_stream_winners(tree, b_out[1], bo, bd, b_out[2])
        nrm = _surface(scene, r, bo, bd)[1]
        h = r["hit"][inv] & b_alive
        return torch.where(h[:, None], 0.8 * normal_color(nrm[inv]), 0.2)
    mk3_ms = median_ms(lambda: packet.packet_stream(*b_args, **b_kw), 10)
    m_split = {
        "primary": median_ms(lambda: intersect_scene(
            scene, None, orig, dirs, m_opts, tree=tree), 10),
        "sort": median_ms(lambda: sort_wave(b_orig, b_dirs, b_alive), 10),
        "prepass": median_ms(lambda: packet.stream_kernel_args(
            tree, bo, bd, tile=t_tile, active=ba), 10),
        "K3": mk3_ms,
        "resolve+shade": median_ms(b_resolve_shade, 10),
    }
    say("kd mirror", "split (median ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in m_split.items()))
    b_stats = b_out[2]
    mk3_bound, mk3_by, b_tests, sample_tests, b_ops = mt_bound(
        b_args, b_kw, b_out, b_ref_stats, tally)
    n_live = int(b_alive.sum())
    say("kd mirror", f"bounce wave: {n_live} live lanes of {n}, "
        f"{int(b_out[1].ge(0).sum())} bounce hits; "
        + tile_stats_line(b_stats, t_tile)
        + f"; tests per live ray {b_tests / max(n_live, 1):.1f}")
    say("kd mirror", f"K3 MT early exits on every {EVERY}th tile: of "
        f"{sample_tests} tested pairs {int(tally[0])} pass det > 0, "
        f"{int(tally[1])} also u, {int(tally[2])} also v; applied to "
        f"{b_tests} pairs: {b_ops} FP32 operations "
        f"({b_ops / max(b_tests, 1):.3f} per pair)")
    say("kd mirror", f"K3 MT at {n // t_tile} tiles: kernel {mk3_ms:.4f} ms, "
        f"plain torch version {b_plain_ms:.4f} ms on "
        f"{len(range(0, n // t_tile, EVERY))} tiles, bound {mk3_bound:.4f} "
        f"ms ({mk3_by})")
    entry = {"name": "packet_stream", "route": "cuda",
             "source": "clpathtracer_tpu_torch/ops/csrc/packet_stream.cu",
             "replaces": "clpathtracer_tpu/ops/packet.py:1507",
             "launches": launches["kd normal"]["packet_stream"],
             "launches_by_path": {p: c["packet_stream"]
                                  for p, c in launches.items()},
             "max_abs_err": k3_err,
             "ms": k3_ms, "plain_ms": k3_plain_ms,
             "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
             "mirror_ms": mk3_ms, "mirror_bound_ms": mk3_bound}
    ctx = dict(scene=scene, soup=soup, cam=cam, scam=scam, tree=tree,
               stree=stree, orig=orig, dirs=dirs, s_orig=s_orig,
               s_dirs=s_dirs, bo=bo, bd=bd, ba=ba, b_out=b_out, k3_ms=k3_ms)
    return entry, ctx


def k4_call(tree, orig, dirs, image_shape, tile, active=None):
    """The bf16 preview's K4 call of traverse_packet(precision="bf16"): MT
    records, the AABB cull, no strips or frustum. (args, kw, layout)."""
    args, kw, layout = packet.stream_kernel_args(
        tree, orig, dirs, image_shape, tile, active, strips=False,
        frustum=False)
    return args, dict(kw, precision="bf16"), layout


def preview_route(ctx, launches):
    """Phases 16-17: the bf16 preview K4. Returns its kernels entry."""
    n = SIZE * SIZE
    t_tile, s_tile = TERRAIN_KD["tile"], SOUP_KD["tile"]
    tree, stree = ctx["tree"], ctx["stree"]
    device = ctx["orig"].device

    # 16. K4 against its plain version on its three calls' inputs
    calls = {"terrain": (tree, ctx["orig"], ctx["dirs"], (SIZE, SIZE),
                         t_tile, None),
             "soup": (stree, ctx["s_orig"], ctx["s_dirs"], (SIZE, SIZE),
                      s_tile, None),
             "mirror wave": (tree, ctx["bo"], ctx["bd"], None, t_tile,
                             ctx["ba"])}
    k4, err = {}, 0.0
    for name, call in calls.items():
        args, kw, _ = k4_call(*call)
        out = packet.packet_stream(*args, **kw)
        torch.cuda.synchronize()
        tally = torch.zeros(3, dtype=torch.int64, device=device)
        e, plain_ms, ref_stats = compare_k3(f"K4 bf16 {name}", out, args, kw,
                                            tally=tally)
        err = max(err, e)
        ms = median_ms(lambda: packet.packet_stream(*args, **kw),
                       3 if name == "mirror wave" else 10)
        bnd, by, tests, _, ops = mt_bound(args, kw, out, ref_stats, tally)
        k4[name] = dict(ms=ms, plain_ms=plain_ms, bound=bnd, by=by)
        say(f"K4 bf16 {name}", tile_stats_line(out[2], call[4])
            + f"; K4 {ms:.4f} ms, plain {plain_ms:.1f} ms on every "
            f"{EVERY}th tile, bound {bnd:.4f} ms ({by}; {tests} MT tests, "
            f"{ops / max(tests, 1):.3f} FP32 operations each by early exit; "
            "the bf16 roundings not counted)")
        if name == "mirror wave":   # K3 ran this wave in phase 13
            live = ctx["ba"]
            hit_bf, hit_f32 = out[1] >= 0, ctx["b_out"][1] >= 0
            say("K4 bf16 mirror wave", "hit agreement with K3 (f32) on its "
                f"{int(live.sum())} live lanes "
                f"{float((hit_bf == hit_f32)[live].float().mean()):.6f} "
                f"({int(hit_bf.sum())} bf16 hits, {int(hit_f32.sum())} f32)")

    # 17. bf16 frames through render_image
    frames = {
        "bf16 normal": ("scene", "cam", tree, dict(packet_tile=t_tile),
                        WARMUP, FRAMES, 1),
        "bf16 soup": ("soup", "scam", stree,
                      dict(packet_tile=s_tile, packet_strips=False,
                           packet_frustum=False), 2, 10, 1),
        "bf16 mirror": ("scene", "cam", tree,
                        dict(packet_tile=t_tile, mode="mirror", bounces=2),
                        2, 10, 2),
    }
    for name, (sc, cm, tr, kw, warm, reps, per) in frames.items():
        sc, cm = ctx[sc], ctx[cm]
        opts = RenderOptions(width=SIZE, height=SIZE, precision="bf16", **kw)
        ms, wall, got, img = run_frames(
            lambda: render_image(sc, cm, opts, tree=tr), warm, reps)
        check_counts(name, got, {"packet_stream_bf16": per * (warm + reps)})
        launches[name] = got
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: non-finite pixels")
        med = float(np.median(ms))
        o, d = generate_rays(cam_matrix(cm, SIZE), SIZE, SIZE)
        prim = intersect_scene(sc, None, o, d, opts, tree=tr)
        ref = intersect_scene(sc, None, o, d,
                              RenderOptions(width=SIZE, height=SIZE, **kw),
                              tree=tr)
        agree = float((prim["hit"] == ref["hit"]).float().mean())
        say(name, f"{SIZE}x{SIZE}: median {med:.4f} ms over {reps} frames "
            f"(min {min(ms):.4f}, max {max(ms):.4f}; host wall {wall:.4f} "
            f"ms/frame), {n / med * 1e3:.6g} rays/s; primary hit agreement "
            f"with the f32 frame {agree:.6f} ({int(prim['hit'].sum())} bf16 "
            f"hits, {int(ref['hit'].sum())} f32), launches {got}")
        say(name, "split (median ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in
            preview_split(sc, cm, tr, opts, o, d, prim).items()))
    k = k4["terrain"]
    return {"name": "packet_stream_bf16", "route": "cuda",
            "source": "clpathtracer_tpu_torch/ops/csrc/packet_stream.cu",
            "replaces": "clpathtracer_tpu/ops/packet.py:899",
            "launches": launches["bf16 normal"]["packet_stream_bf16"],
            "launches_by_path": {p: c["packet_stream_bf16"]
                                 for p, c in launches.items()},
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "plain_tiles": f"every {EVERY}th",
            "bound_ms": k["bound"], "bound_by": k["by"], "library_ms": None,
            "soup_ms": k4["soup"]["ms"], "soup_bound_ms": k4["soup"]["bound"],
            "mirror_wave_ms": k4["mirror wave"]["ms"],
            "mirror_wave_bound_ms": k4["mirror wave"]["bound"]}


def preview_split(scene, cam, tree, opts, orig, dirs, prim):
    """A bf16 frame's parts, each timed alone on the frame's own inputs:
    rays, K4's prepass, K4, resolve+shade for a normal frame; primary,
    sort, prepass, K4 on the bounce wave, resolve+shade for a mirror
    frame."""
    tile = opts.packet_tile
    if opts.mode == "normal":
        args, kw, layout = k4_call(tree, orig, dirs, (SIZE, SIZE), tile)
        out = packet.packet_stream(*args, **kw)

        def resolve_shade():
            r = packet._resolve_stream_winners(
                tree, packet._to_wave_order(out[1], layout), orig, dirs,
                out[2])
            return torch.where(r["hit"][:, None],
                               normal_color(_surface(scene, r, orig,
                                                     dirs)[1]),
                               opts.background)
        return {"rays": median_ms(lambda: generate_rays(
                    cam_matrix(cam, SIZE), SIZE, SIZE), 10),
                "prepass": median_ms(lambda: k4_call(
                    tree, orig, dirs, (SIZE, SIZE), tile), 10),
                "K4": median_ms(lambda: packet.packet_stream(*args, **kw),
                                10),
                "resolve+shade": median_ms(resolve_shade, 10)}
    alive = torch.ones((SIZE * SIZE,), dtype=torch.bool, device=orig.device)
    b_alive, b_orig, b_dirs, _ = mirror_wave(scene, prim, orig, dirs, alive)
    inv, bo, bd, ba = sort_wave(b_orig, b_dirs, b_alive)
    args, kw, _ = k4_call(tree, bo, bd, None, tile, ba)
    out = packet.packet_stream(*args, **kw)

    def resolve_shade():
        r = packet._resolve_stream_winners(tree, out[1], bo, bd, out[2])
        nrm = _surface(scene, r, bo, bd)[1]
        h = r["hit"][inv] & b_alive
        return torch.where(h[:, None], 0.8 * normal_color(nrm[inv]), 0.2)
    return {"primary": median_ms(lambda: intersect_scene(
                scene, None, orig, dirs, opts, tree=tree), 5),
            "sort": median_ms(lambda: sort_wave(b_orig, b_dirs, b_alive), 5),
            "prepass": median_ms(lambda: k4_call(tree, bo, bd, None, tile,
                                                 ba), 5),
            "K4": median_ms(lambda: packet.packet_stream(*args, **kw), 3),
            "resolve+shade": median_ms(resolve_shade, 5)}


def queue_engine(ctx, launches):
    """Phases 18-19: the queue engine K5, beside K3. Returns K5's kernels
    entry."""
    t_tile, s_tile = TERRAIN_KD["tile"], SOUP_KD["tile"]
    tree, stree = ctx["tree"], ctx["stree"]
    device = ctx["orig"].device
    calls = {"terrain": (tree, ctx["orig"], ctx["dirs"], (SIZE, SIZE),
                         t_tile, None, True),
             "soup": (stree, ctx["s_orig"], ctx["s_dirs"], (SIZE, SIZE),
                      s_tile, None, True),
             "mirror wave": (tree, ctx["bo"], ctx["bd"], None, t_tile,
                             ctx["ba"], False)}

    # 18. the three queue calls through the entry point, counted; then the
    # kernel against its plain version on every 8th tile of each
    reset_counts()
    recs = {name: packet.traverse_packet(
                tr, o, d, shape, tile, engine="queue", active=act,
                shared_origin=so, grid_dirs=so)
            for name, (tr, o, d, shape, tile, act, so) in calls.items()}
    torch.cuda.synchronize()
    got = counts()
    check_counts("queue", got, {"packet_queue": len(calls)})
    launches["queue"] = got
    k5, err = {}, 0.0
    for name, (tr, o, d, shape, tile, act, so) in calls.items():
        # the queue's call: the AABB cull, never strips or the frustum
        args, kw, layout = packet.stream_kernel_args(
            tr, o, d, shape, tile, act, so, so, strips=False, frustum=False)
        q_out = packet.packet_queue(*args, **kw)
        torch.cuda.synchronize()
        hit = packet._to_wave_order(q_out[1], layout) >= 0
        if not torch.equal(hit, recs[name]["hit"]) or not bool(hit.any()):
            raise AssertionError(f"K5 {name}: traverse_packet's hits differ "
                                 "from the kernel call's, or none")
        tally = None if so else torch.zeros(3, dtype=torch.int64,
                                            device=device)
        e, plain_ms, ref_stats = compare_k3(
            f"K5 {name}", q_out, args, kw, tally=tally,
            plain=packet.packet_queue_reference)
        err = max(err, e)

        # 19. K5 beside K3 in its cull form on the same inputs
        s_out = packet.packet_stream(*args, **kw)
        torch.cuda.synchronize()
        same_hit = torch.equal(q_out[1] >= 0, s_out[1] >= 0)
        same_t = torch.equal(q_out[0], s_out[0])
        ties = int((q_out[1] != s_out[1]).sum())
        say(f"K5 vs K3 {name}", f"hits equal {same_hit}, best t equal "
            f"{same_t}, slots differing at exact-t ties {ties} of "
            f"{int((s_out[1] >= 0).sum())} hits")
        if not (same_hit and same_t):
            raise AssertionError(f"K5 {name}: hits or t differ from K3's")
        k3_ms, q_ms = turns_ms([lambda: packet.packet_stream(*args, **kw),
                                lambda: packet.packet_queue(*args, **kw)],
                               4 if name == "mirror wave" else 10)
        if so:
            tests = k3_tests(q_out[2], tile)
            bnd, by = bound(k3_tensors(args, kw, q_out), tests * K1_OPS)
        else:
            bnd, by, tests, _, _ = mt_bound(args, kw, q_out, ref_stats, tally)
        k5[name] = dict(ms=q_ms, k3_ms=k3_ms, plain_ms=plain_ms, bound=bnd,
                        by=by)
        say(f"K5 vs K3 {name}", f"K5 {q_ms:.4f} ms, K3 {k3_ms:.4f} ms (in "
            f"turns), bound {bnd:.4f} ms ({by}; {tests} "
            f"{'SO' if so else 'MT'} tests); K5 " + tile_stats_line(
                q_out[2], tile) + "; K3 " + tile_stats_line(s_out[2], tile))
    say("K5 vs K3", f"the terrain frame's K3 with strips (the route users get "
        f"today): {ctx['k3_ms']:.4f} ms")
    k = k5["terrain"]
    return {"name": "packet_queue", "route": "cuda",
            "source": "clpathtracer_tpu_torch/ops/csrc/packet_queue.cu",
            "replaces": "clpathtracer_tpu/ops/packet.py:1101",
            "also_replaces": "clpathtracer_tpu/ops/packet.py:1881",
            "launches": launches["queue"]["packet_queue"],
            "launches_by_path": {p: c["packet_queue"]
                                 for p, c in launches.items()},
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "plain_tiles": f"every {EVERY}th",
            "bound_ms": k["bound"], "bound_by": k["by"], "library_ms": None,
            "k3_ms": k["k3_ms"],
            "soup_ms": k5["soup"]["ms"], "soup_k3_ms": k5["soup"]["k3_ms"],
            "mirror_wave_ms": k5["mirror wave"]["ms"],
            "mirror_wave_k3_ms": k5["mirror wave"]["k3_ms"],
            "mirror_wave_bound_ms": k5["mirror wave"]["bound"]}


def chain_tables(depth, wide_depth, device):
    """Degenerate tables for the stack guard, for rays from z < -10 that
    travel along +z (the soup's primaries): a binary chain whose walk
    grows the stack one entry a level (split i on axis z pushes a far
    child behind the rays, popped last and culled, and the near child
    i + 1), a leaf at the end; a supernode chain that grows it 7 entries
    a level (7 live children that are an empty row, and the next row on
    top). Boxes that contain the origins are live."""
    t = np.zeros((depth + 2, 16), np.float32)
    t[:, 0:3], t[:, 3:6] = -1e3, 1e3
    t[:depth, 7] = 2.0
    t[:depth, 8] = np.arange(1, depth + 1)
    t[:depth, 9] = depth + 1
    t[depth, 7] = 4.0
    t[depth + 1, 2], t[depth + 1, 5] = -100.0, -90.0     # behind the rays
    w = np.zeros((wide_depth + 2, 8, 16), np.float32)
    w[:wide_depth, :, 0:3], w[:wide_depth, :, 3:6] = -1e3, 1e3
    w[:wide_depth, :, 6] = 1.0
    w[:wide_depth, :7, 7] = wide_depth + 1
    w[:wide_depth, 7, 7] = np.arange(1, wide_depth + 1)
    return (torch.as_tensor(t, device=device),
            torch.as_tensor(w.reshape(-1, 128), device=device))


def stack_guard(recs, orig_t, dir_t, tile):
    """Phase 20's first part: the v1 kernels' stack guard on the card."""
    ok = chain_tables(100, 10, recs.device)
    bad = chain_tables(200, 30, recs.device)
    for engine, pops in (("K6b", 201), ("K9", 81)):
        if engine == "K6b":
            def call(tabs):
                return packet.packet_legacy(tabs[0], recs, orig_t, dir_t,
                                            tile=tile, resident=False)
        else:
            def call(tabs):
                return packet.packet_wide(tabs[1], recs, orig_t, dir_t,
                                          tile=tile)
        st = call(ok)[2]
        if not (bool((st[:, 0] == pops).all())
                and bool((st[:, 1] == 0).all())):
            raise AssertionError(f"stack guard: {engine} pops "
                                 f"{st[:, 0].tolist()}, want {pops}")
        try:
            call(bad)
        except RuntimeError as e:
            if "overflowed" not in str(e):
                raise
            say("stack guard", f"{engine}: {pops} pops inside the stack; "
                f"the deeper chain raised: {e}")
        else:
            raise AssertionError(f"stack guard: {engine} did not raise")
        torch.cuda.synchronize()


def v1_bound(args, out, tile, tally, ref_stats, resident):
    """The bound of a v1 call: its MT pairs weighted by the early exits
    that the plain run counted on its tiles (tally: pairs tested, then
    those that pass det, u, v), applied to all pairs. K6b and K9: 128
    records per window streamed against every lane of the tile; K6a,
    whose stats count leaves and not records: the plain run's pairs
    scaled by the leaves of all tiles over those of its tiles. Returns
    (bound ms, bound_by, pairs, FP32 operations)."""
    st = out[2].to(torch.int64)
    sample = int(tally[0])
    if resident:
        tests = int(sample * int(st[:, 1].sum())
                    / max(int(ref_stats[:, 1].sum()), 1))
    else:
        tests = int(st[:, 1].sum()) * 128 * tile
    ops = int(mt_ops(sample, tally[1:]) * tests / max(sample, 1))
    return (*bound([*args, *out], ops), tests, ops)


def v1_line(stats, tile, lane1):
    st = stats.to(torch.float64)
    return (f"per tile: node pops {float(st[:, 0].mean()):.2f} (max "
            f"{int(st[:, 0].max())}), {lane1} {float(st[:, 1].mean()):.2f} "
            f"(max {int(st[:, 1].max())}); {stats.shape[0]} tiles of {tile}")


def v1_engines(ctx, launches):
    """Phases 20-23: the v1 walks K6a, K6b and K9, beside K3. Returns
    their kernels entries."""
    n = SIZE * SIZE
    t_tile, s_tile = TERRAIN_KD["tile"], SOUP_KD["tile"]
    tree, stree = ctx["tree"], ctx["stree"]
    device = ctx["orig"].device
    calls = {"terrain": (tree, ctx["orig"], ctx["dirs"], (SIZE, SIZE),
                         t_tile, None),
             "soup": (stree, ctx["s_orig"], ctx["s_dirs"], (SIZE, SIZE),
                      s_tile, None),
             "mirror wave": (tree, ctx["bo"], ctx["bd"], None, t_tile,
                             ctx["ba"])}
    kernels = {"K6a": ("vmem", "packet_legacy_resident", "leaves"),
               "K6b": ("tri_stream", "packet_legacy", "windows"),
               "K9": ("wide", "packet_wide", "windows")}

    def v1_call(name, kernel):
        tr, o, d, shape, tile, _ = calls[name]
        mode = kernels[kernel][0]
        args, layout = packet.v1_kernel_args(tr, o, d, shape, tile, mode)
        kw = {"tile": tile}
        if mode == "wide":
            return args, kw, layout, packet.packet_wide, \
                packet.packet_wide_reference
        kw["resident"] = mode == "vmem"
        return args, kw, layout, packet.packet_legacy, \
            packet.packet_legacy_reference

    # 20. the stack guard and the byte rule
    s_args = v1_call("soup", "K6b")[0]
    stack_guard(s_args[1], s_args[2][:, :s_tile].contiguous(),
                s_args[3][:, :s_tile].contiguous(), s_tile)
    for name, tr in (("terrain", tree), ("soup", stree)):
        mode = packet.packet_mode(tr, n, t_tile, "legacy")
        say("v1", f"{name}: engine='legacy' picks {mode}: node table "
            f"{tr.num_nodes * 64} B + records {tr.tri_indices.shape[0] * 64}"
            f" B > VMEM_BUDGET {packet.VMEM_BUDGET} B, the JAX package's "
            "rule; K6a is reached only through packet_legacy(resident=True)")
        if mode != "tri_stream":
            raise AssertionError(f"v1: legacy picks {mode} at 1M")

    # 21. the six calls through traverse_packet, counted; K6a's three
    # op-level calls, counted; oracles
    reset_counts()
    recs = {(name, e): packet.traverse_packet(
                tr, o, d, shape, tile, engine=e, active=act)
            for name, (tr, o, d, shape, tile, act) in calls.items()
            for e in ("legacy", "wide")}
    torch.cuda.synchronize()
    got = counts()
    check_counts("v1", got, {"packet_legacy": 3, "packet_wide": 3})
    launches["v1 traverse"] = got
    reset_counts()
    outs = {}
    for name in calls:
        args, kw, layout, fn, _ = v1_call(name, "K6a")
        outs[name, "K6a"] = fn(*args, **kw)
    torch.cuda.synchronize()
    got = counts()
    check_counts("v1 K6a", got, {"packet_legacy_resident": 3})
    launches["v1 K6a"] = got
    for name, (tr, o, d, shape, tile, act) in calls.items():
        for kernel in kernels:
            args, kw, layout, fn, _ = v1_call(name, kernel)
            if kernel != "K6a":
                outs[name, kernel] = fn(*args, **kw)
                e = "wide" if kernel == "K9" else "legacy"
                hit = packet._to_wave_order(outs[name, kernel][1], layout) >= 0
                if not torch.equal(hit, recs[name, e]["hit"]):
                    raise AssertionError(f"{kernel} {name}: traverse_packet's"
                                         " hits differ from the kernel's")
            if name == "soup":
                continue
            out = outs[name, kernel]
            rec = packet._resolve_stream_winners(
                tr, packet._to_wave_order(out[1], layout), o, d, out[2])
            if name == "terrain":
                pix = torch.as_tensor(np.random.default_rng(4).choice(
                    n, ORACLE_PIXELS, replace=False), device=device)
                check_oracle(f"{kernel} oracle", ctx["scene"], rec, o, d,
                             pix, 2e-3, 1e-4, 1e-5)
            else:
                live = torch.nonzero(act).squeeze(1)
                pick = live[torch.as_tensor(np.random.default_rng(5).choice(
                    live.numel(), min(ORACLE_PIXELS, live.numel()),
                    replace=False), device=device)]
                check_oracle(f"{kernel} bounce oracle", ctx["scene"], rec,
                             o, d, pick, 1e-3, 1e-5, 1e-6)
    del recs

    # 22. each kernel against its plain version; 23. beside K3, in turns
    res, err = {}, {k: 0.0 for k in kernels}
    for name, (tr, o, d, shape, tile, act) in calls.items():
        every = 16 if name == "mirror wave" else EVERY
        k3_args, k3_kw, _ = packet.stream_kernel_args(
            tr, o, d, shape, tile, act, strips=False, frustum=False)
        fns = [lambda: packet.packet_stream(*k3_args, **k3_kw)]
        for kernel in kernels:
            args, kw, _, fn, plain = v1_call(name, kernel)
            out = outs[name, kernel]
            tally = torch.zeros(4, dtype=torch.int64, device=device)
            e, plain_ms, ref_stats = compare_v1(
                f"{kernel} {name}", out, args, kw, plain, every, tally)
            err[kernel] = max(err[kernel], e)
            bnd, by, tests, ops = v1_bound(args, out, tile, tally, ref_stats,
                                           kernel == "K6a")
            res[name, kernel] = dict(plain_ms=plain_ms, bound=bnd, by=by,
                                     tests=tests, ops=ops)
            fns.append(lambda args=args, kw=kw, fn=fn: fn(*args, **kw))
        ms = turns_ms(fns, 2 if name == "mirror wave" else 5)
        k3_out = packet.packet_stream(*k3_args, **k3_kw)
        torch.cuda.synchronize()
        say(f"v1 vs K3 {name}", f"K3 (MT, AABB cull) {ms[0]:.4f} ms; "
            + tile_stats_line(k3_out[2], tile))
        for (kernel, (_, _, lane1)), kms in zip(kernels.items(), ms[1:]):
            r = res[name, kernel]
            r.update(ms=kms, k3_ms=ms[0])
            say(f"v1 vs K3 {name}", f"{kernel} {kms:.4f} ms ({kms / ms[0]:.3f}"
                f" x K3), plain {r['plain_ms']:.1f} ms on every {every}th "
                f"tile, bound {r['bound']:.4f} ms ({r['by']}; {r['tests']} MT "
                f"pairs, {r['ops'] / max(r['tests'], 1):.3f} FP32 operations "
                f"each by early exit); " + v1_line(outs[name, kernel][2],
                                                  tile, lane1))
    entries = []
    for kernel, (mode, cname, _) in kernels.items():
        t, s_, m = (res[c, kernel] for c in calls)
        entries.append({
            "name": cname, "route": "cuda",
            "source": "clpathtracer_tpu_torch/ops/csrc/packet_v1.cu",
            "replaces": {"K6a": "clpathtracer_tpu/ops/packet.py:744",
                         "K6b": "clpathtracer_tpu/ops/packet.py:808",
                         "K9": "clpathtracer_tpu/ops/packet.py:831"}[kernel],
            "launches": launches["v1 K6a" if kernel == "K6a"
                                 else "v1 traverse"][cname],
            "launches_by_path": {p: c.get(cname, 0)
                                 for p, c in launches.items()},
            "max_abs_err": err[kernel], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "plain_tiles": f"every {EVERY}th",
            "bound_ms": t["bound"], "bound_by": t["by"], "library_ms": None,
            "k3_ms": t["k3_ms"], "soup_ms": s_["ms"],
            "soup_k3_ms": s_["k3_ms"], "soup_bound_ms": s_["bound"],
            "mirror_wave_ms": m["ms"], "mirror_wave_k3_ms": m["k3_ms"],
            "mirror_wave_bound_ms": m["bound"]})
    return entries


def compare_v1(name, kernel_out, args, kw, plain, every, tally):
    """Run a v1 kernel's plain version on every `every`-th tile of the
    call (args, kw) and hold the kernel's outputs to it exactly. Returns
    (max |dt| over the plain hits, the plain run's ms, its stats)."""
    best_t, best_slot, stats = kernel_out
    table, recs, orig_t, dir_t = args
    tile = kw["tile"]
    device = orig_t.device
    n_tiles = orig_t.shape[1] // tile
    sel = torch.arange(0, n_tiles, every, device=device)
    lanes = (sel[:, None] * tile
             + torch.arange(tile, device=device)).reshape(-1)
    (ref_t, ref_slot, ref_stats), plain_ms = timed(lambda: plain(
        table, recs, orig_t[:, lanes].contiguous(),
        dir_t[:, lanes].contiguous(), tally=tally, **kw))
    bad_t = int((best_t[lanes] != ref_t).sum())
    bad_slot = int((best_slot[lanes] != ref_slot).sum())
    bad_stats = int((stats[sel] != ref_stats).sum())
    hit = ref_slot >= 0
    err = float((best_t[lanes] - ref_t)[hit].abs().max()) \
        if bool(hit.any()) else 0.0
    say(name, f"{sel.numel()} of {n_tiles} tiles of {tile} rays against the "
        f"plain version (tolerance: exact): t mismatches {bad_t}, slot "
        f"mismatches {bad_slot}, stats mismatches {bad_stats} (5 lanes), "
        f"max |dt| {err}, {int(hit.sum())} hits; plain {plain_ms:.1f} ms")
    if bad_t or bad_slot or bad_stats:
        raise AssertionError(f"{name}: the kernel disagrees with its plain "
                             "version")
    return err, plain_ms, ref_stats


if __name__ == "__main__":
    main()
