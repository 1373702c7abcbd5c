#!/usr/bin/env python3
"""W1's schedule on the card: the per-ray rope walk's numeric constants.

    python3 probes/probe_w1_schedule.py

Builds W1 (clpathtracer_tpu_torch/ops/csrc/ray_walk.cu) at 1, 2, 4 and 8
threads a ray (kGroup), then at the shipped schedule with 2 records a
load round (kUnroll), its registers held to 1, 6 or 10 blocks an SM
(kMinBlocks) and 4 or 16 records a thread a chunk (kPer): each constant
changed in a copy of the source, one nvcc each, all started together,
into the git-ignored clpathtracer_tpu_torch/_build/. Builds
chip_smoke.py's 1M emissive terrain, its packet tree (depth 11, leaf
3072), its shadow tree and phase 40's waves; holds the shipped W1
exactly to its plain version on every 64th lane of the primaries, the
shadow-tree bounce wave and the nearest shadow wave, and every variant
exactly to the shipped kernel on every lane (t, slot, steps); then times
every variant on each wave in turns. Prints the card line, each
variant's launch shape (threads, threads a ray, blocks an SM, registers,
shared memory, spill bytes), then one line per wave and variant. Needs
one CUDA card and nvcc; exits non-zero otherwise.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from clpathtracer_tpu_torch.accel import sah  # noqa: E402
from clpathtracer_tpu_torch.core.camera import (  # noqa: E402
    Camera, cam_matrix, generate_rays)
from clpathtracer_tpu_torch.ops import _cuda  # noqa: E402
from clpathtracer_tpu_torch.ops.traverse_fast import (  # noqa: E402
    ray_walk, ray_walk_reference)
from clpathtracer_tpu_torch.render.integrator import light_cdf  # noqa: E402
from clpathtracer_tpu_torch.scene.procedural import (  # noqa: E402
    terrain_mesh)

# W1's constants and, for each, the values tried with the others shipped
W1_NAMES = ("kGroup", "kUnroll", "kMinBlocks", "kPer")
W1_TRIES = {"kGroup": (1, 2, 4, 8), "kUnroll": (2,), "kMinBlocks": (1, 6, 10),
            "kPer": (4, 16)}
W1_WAVES = ("primary", "bounce, shadow tree", "shadow nearest")
CONST = r"(constexpr \w+ {} = )([^;]+);"


def constants(src, names):
    """The values of the integer `constexpr` constants `names` in a
    source."""
    out = []
    for name in names:
        m = re.search(CONST.format(name), src)
        if m is None:
            raise RuntimeError(f"constant {name} not found")
        out.append(int(m.group(2)))
    return tuple(out)


def w1_label(v):
    return (f"{v[0]} threads a ray, {v[1]} records a load round, {v[2]} "
            f"blocks an SM bound, {v[3]} records a thread a chunk")


def build(stem, variants, names, shipped):
    """One library per variant (a tuple of the constants `names`) but the
    shipped one: {variant: (launch, shape) ctypes functions}."""
    src = (_cuda.CSRC_DIR / f"{stem}.cu").read_text()
    out_dir = _cuda.BUILD_DIR / f"probe_{stem}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var in variants:
        if var == shipped:
            continue
        text = src
        for name, value in zip(names, var):
            text, k = re.subn(CONST.format(name),
                              rf"\g<1>{value};", text)
            assert k == 1, name
        cu = out_dir / f"{stem}_{'_'.join(map(str, var))}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
               f"-I{_cuda.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[var] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sig = _cuda.SIGNATURES[stem]
    libs = {}
    for var, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem} {var}:\n{text}")
        lib = ctypes.CDLL(str(so))
        fns = []
        for name in (f"{stem}_launch", f"{stem}_shape"):
            fn = getattr(lib, name)
            fn.argtypes = sig[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[var] = tuple(fns)
    return libs


def shape(fn, keys):
    out = (ctypes.c_int * len(keys))()
    if fn(out) != 0:
        raise RuntimeError("shape entry failed")
    return dict(zip(keys, out))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_w1_schedule.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = _cuda.load_kernels().fns
    w1_base = constants((_cuda.CSRC_DIR / "ray_walk.cu").read_text(),
                        W1_NAMES)
    w1_vars = [w1_base]
    for k, name in enumerate(W1_NAMES):
        for value in W1_TRIES[name]:
            var = (*w1_base[:k], value, *w1_base[k + 1:])
            if var not in w1_vars:
                w1_vars.append(var)
    w1_libs = build("ray_walk", w1_vars, W1_NAMES, w1_base)
    w1_libs[w1_base] = (fns["ray_walk_launch"], fns["ray_walk_shape"])
    for key in w1_vars:
        print(f"W1 {w1_label(key)}{' (shipped)' if key == w1_base else ''}: "
              f"{shape(w1_libs[key][1], _cuda.GRID_SHAPE_KEYS)}", flush=True)

    terrain = terrain_mesh(cs.N_TRIS, seed=0, extent=10.0,
                           emissive_frac=cs.EMISSIVE_FRAC,
                           device=device).bake_shading()
    kd = cs.TERRAIN_KD
    tree = sah.attach_so_tables(sah.build_kd_tree(
        terrain.tri_corners(), max_depth=kd["max_depth"],
        leaf_size=kd["leaf_size"], device=device))
    shadow = sah.build_shadow_tree(terrain.tri_corners(), device=device,
                                   **cs.SHADOW_KD)
    cam = Camera.create(cs.POS, cs.FWD, device=device)
    orig, dirs = generate_rays(cam_matrix(cam, cs.SIZE), cs.SIZE, cs.SIZE)
    waves = cs.walk_waves(terrain, tree, shadow, orig, dirs,
                          light_cdf(terrain), device)

    def swap(entry, fn, call):
        saved = fns[entry]
        fns[entry] = fn
        try:
            return call()
        finally:
            fns[entry] = saved

    n = orig.shape[0]
    lanes = torch.arange(0, n, cs.WALK_EVERY, device=device)
    for name in W1_WAVES:
        tr, w = waves[name]
        w = {k: v for k, v in w.items()}
        ref = ray_walk(tr, **w)
        plain = ray_walk_reference(tr, **cs.sub_wave(w, lanes))
        bad = [int((a[lanes] != b).sum()) for a, b in zip(ref, plain)]
        if any(bad):
            raise AssertionError(f"{name}: the shipped W1 differs from its "
                                 f"plain version {bad}")
        for key in w1_vars:
            out = swap("ray_walk_launch", w1_libs[key][0],
                       lambda: ray_walk(tr, **w))
            bad = [int((a != b).sum()) for a, b in zip(out, ref)]
            if any(bad):
                raise AssertionError(f"{name} {key}: differs from the "
                                     f"shipped W1 {bad}")
        live = ref[2] > 0
        steps = ref[2][live].to(torch.float64)
        ms = cs.turns_ms([lambda k=k: swap("ray_walk_launch", w1_libs[k][0],
                                           lambda: ray_walk(tr, **w))
                          for k in w1_vars], 6)
        print(f"W1 {name}: the shipped kernel equal to its plain version "
              f"on {lanes.numel()} lanes and every variant to it (exact); "
              f"{int(live.sum())} live lanes, steps mean "
              f"{float(steps.mean()):.3f}, max {int(steps.max())}",
              flush=True)
        for key, t in zip(w1_vars, ms):
            print(f"W1 {name}: {w1_label(key)}"
                  f"{' (shipped)' if key == w1_base else ''}: {t:.4f} ms",
                  flush=True)


if __name__ == "__main__":
    os.chdir(Path(__file__).resolve().parents[1])
    main()
