#!/usr/bin/env python3
"""G1's launch shape on the card: threads a ray and blocks an SM.

    python3 probes/probe_g1_schedule.py

Builds the grid DDA G1 (clpathtracer_tpu_torch/ops/csrc/grid_dda.cu) at
1, 2, 4 and 8 threads a ray and 1 to 4 blocks an SM (its constants
kRayThreads and kMinBlocks changed in a copy of the source, one nvcc each,
all started together, into the git-ignored clpathtracer_tpu_torch/_build/),
runs each on chip_smoke.py's phase-35 waves of the 1M emissive soup (the
bounce wave and the any-hit shadow wave), holds each variant's record
exactly equal to the shipped kernel's (hit, t, tri, u, v, steps), and
times every variant in turns on the full wave and on its tail (the top
1/64 of the lanes by steps, alone). Prints the card line, each variant's
registers, spill bytes and blocks an SM, then one line per wave and
variant. Needs one CUDA card and nvcc; exits non-zero otherwise.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from clpathtracer_tpu_torch.accel.grid import build_grid  # noqa: E402
from clpathtracer_tpu_torch.ops import _cuda  # noqa: E402
from clpathtracer_tpu_torch.ops.grid_walk import traverse_grid  # noqa: E402
from clpathtracer_tpu_torch.render.integrator import light_cdf  # noqa: E402
from clpathtracer_tpu_torch.scene.procedural import (  # noqa: E402
    random_tri_soup)

# (threads a ray, blocks an SM); the shipped kernel's among them
VARIANTS = ((1, 1), (2, 1), (4, 2), (4, 3), (8, 3), (8, 4))
RAY_LINE = "constexpr int kRayThreads = {};"
BLOCKS_LINE = "constexpr int kMinBlocks = {};"


def shipped():
    src = (_cuda.CSRC_DIR / "grid_dda.cu").read_text()
    for kt in (1, 2, 4, 8):
        for mb in range(1, 9):
            if RAY_LINE.format(kt) in src and BLOCKS_LINE.format(mb) in src:
                return kt, mb
    raise RuntimeError("grid_dda.cu: kRayThreads / kMinBlocks not found")


def build_variants(base):
    """One library per variant but the shipped one: {(kt, mb): (launch,
    shape) ctypes functions}."""
    src = (_cuda.CSRC_DIR / "grid_dda.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "probe_g1_schedule"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kt, mb in VARIANTS:
        if (kt, mb) == base:
            continue
        var = src.replace(RAY_LINE.format(base[0]), RAY_LINE.format(kt))
        var = var.replace(BLOCKS_LINE.format(base[1]), BLOCKS_LINE.format(mb))
        cu = out_dir / f"grid_dda_{kt}_{mb}.cu"
        cu.write_text(var)
        so = cu.with_suffix(".so")
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
               f"-I{_cuda.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[kt, mb] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sig = _cuda.SIGNATURES["grid_dda"]
    libs = {}
    for key, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(so))
        fns = []
        for name in ("grid_dda_launch", "grid_dda_shape"):
            fn = getattr(lib, name)
            fn.argtypes = sig[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[key] = tuple(fns)
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_g1_schedule.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fns = _cuda.load_kernels().fns
    base = shipped()
    libs = build_variants(base)
    libs[base] = (fns["grid_dda_launch"], fns["grid_dda_shape"])
    for key in VARIANTS:
        out = (ctypes.c_int * len(_cuda.GRID_SHAPE_KEYS))()
        if libs[key][1](out) != 0:
            raise RuntimeError(f"grid_dda_shape {key} failed")
        shape = dict(zip(_cuda.GRID_SHAPE_KEYS, out))
        print(f"{key[0]} threads a ray, {key[1]} blocks an SM"
              f"{' (shipped)' if key == base else ''}: {shape}", flush=True)

    soup = random_tri_soup(cs.N_TRIS, seed=0, extent=10.0, tri_size=0.01,
                           emissive_frac=cs.EMISSIVE_FRAC,
                           device=device).bake_shading()
    grid = build_grid(soup.tri_corners(), device=device)
    waves = cs.nee_waves(soup, light_cdf(soup), device).waves

    def call(key, wave):
        saved = fns["grid_dda_launch"]
        fns["grid_dda_launch"] = libs[key][0]
        try:
            return traverse_grid(grid, **wave)
        finally:
            fns["grid_dda_launch"] = saved

    for name in ("bounce", "shadow any-hit"):
        wave = waves[name]
        ref = call(base, wave)
        for key in VARIANTS:
            rec = call(key, wave)
            bad = {f: int((rec[f] != ref[f]).sum()) for f in cs.G1_FIELDS}
            if any(bad.values()):
                raise AssertionError(f"{name} {key}: differs from the "
                                     f"shipped kernel {bad}")
        steps = ref["steps"]
        lanes = torch.argsort(steps, descending=True,
                              stable=True)[:steps.numel() // cs.TAIL_FRAC]
        tail = {k: (v[lanes].contiguous() if isinstance(v, torch.Tensor)
                    else v) for k, v in wave.items()}
        fns_timed = [lambda k=k, w=w: call(k, w) for k in VARIANTS
                     for w in (wave, tail)]
        ms = cs.turns_ms(fns_timed, 10)
        print(f"{name}: every variant equal to the shipped kernel (exact); "
              f"steps mean {float(steps[wave['active']].float().mean()):.3f}"
              f", max {int(steps.max())}; tail {lanes.numel()} lanes",
              flush=True)
        for i, key in enumerate(VARIANTS):
            full, tl = ms[2 * i], ms[2 * i + 1]
            print(f"{name}: {key[0]} threads a ray, {key[1]} blocks an SM"
                  f"{' (shipped)' if key == base else ''}: {full:.4f} ms "
                  f"the wave, {tl:.4f} ms its tail", flush=True)


if __name__ == "__main__":
    os.chdir(Path(__file__).resolve().parents[1])
    main()
