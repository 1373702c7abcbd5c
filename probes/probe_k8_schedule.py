#!/usr/bin/env python3
"""K8's shape on a cluster: threads a lane against rays a thread.

    python3 probes/probe_k8_schedule.py

Builds the plane-form walk K8 (clpathtracer_tpu_torch/ops/csrc/
packet_mxu.cu) at other values of its constants kSplit (threads a lane:
each tests every kSplit-th triangle of a chunk) and kRays (rays a thread:
a triangle's coefficients, read once into registers, serve them), changed
in a copy of the source, one nvcc each, all started together, into the
git-ignored clpathtracer_tpu_torch/_build/. Runs each on chip_smoke.py's
three K8 inputs (the 1M terrain's primaries at tile 2048, the 1M soup's at
512, the terrain's mirror bounce wave at 2048 with its active mask; the
same trees, cameras and wave as phases 12-15 build), holds every variant's
outputs exactly equal to the shipped kernel's (t, slot, the five stats
lanes), and times all variants in turns on each input and on the mirror
wave's heaviest tile alone. Prints the card line, each variant's launch
shape at tiles 2048 and 512 (threads, registers, shared memory, clusters
resident), then one line per input and variant. Needs one CUDA card and
nvcc; exits non-zero otherwise.

kd_context(device) builds those inputs (also for a throwaway driver of
chip_smoke.py's K7 and K8 phases).
"""

import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from clpathtracer_tpu_torch.ops import _cuda, packet_mxu  # noqa: E402

# (threads a lane, rays a thread); the shipped kernel's among them
VARIANTS = ((2, 1), (1, 2), (2, 2), (1, 4))
SPLIT_LINE = "constexpr int kSplit = {};"
RAYS_LINE = "constexpr int kRays = {};"


def kd_context(device):
    """The 1M terrain and soup, their kd-trees (chip_smoke.TERRAIN_KD,
    SOUP_KD), cameras, primaries and the terrain's sorted mirror bounce
    wave, as chip_smoke.kd_route builds them: the keys of its ctx that
    the K7 and K8 phases read."""
    t = time.perf_counter()
    scene = cs.terrain_mesh(cs.N_TRIS, seed=0, extent=10.0,
                            device=device).bake_shading()
    soup = cs.random_tri_soup(cs.N_TRIS, seed=0, extent=10.0, tri_size=0.01,
                              device=device).bake_shading()

    def tree_of(sc, cfg):
        return cs.sah.attach_so_tables(cs.sah.build_kd_tree(
            sc.tri_corners(), max_depth=cfg["max_depth"],
            leaf_size=cfg["leaf_size"], device=device))
    tree, stree = tree_of(scene, cs.TERRAIN_KD), tree_of(soup, cs.SOUP_KD)
    cam = cs.Camera.create(cs.POS, cs.FWD, device=device)
    scam = cs.Camera.create(cs.SOUP_POS, cs.SOUP_FWD, device=device)
    size = cs.SIZE
    orig, dirs = cs.generate_rays(cs.cam_matrix(cam, size), size, size)
    s_orig, s_dirs = cs.generate_rays(cs.cam_matrix(scam, size), size, size)
    m_opts = cs.RenderOptions(width=size, height=size, mode="mirror",
                              bounces=2, intersector="packet",
                              packet_tile=cs.TERRAIN_KD["tile"])
    alive = torch.ones((size * size,), dtype=torch.bool, device=device)
    prim = cs.intersect_scene(scene, None, orig, dirs, m_opts, tree=tree)
    b_alive, b_orig, b_dirs, _ = cs.mirror_wave(scene, prim, orig, dirs,
                                                alive)
    _, bo, bd, ba = cs.sort_wave(b_orig, b_dirs, b_alive)
    torch.cuda.synchronize()
    print(f"inputs built in {time.perf_counter() - t:.1f} s", flush=True)
    return dict(scene=scene, soup=soup, tree=tree, stree=stree, cam=cam,
                scam=scam, orig=orig, dirs=dirs, s_orig=s_orig,
                s_dirs=s_dirs, bo=bo, bd=bd, ba=ba)


def shipped():
    src = (_cuda.CSRC_DIR / "packet_mxu.cu").read_text()
    for split, rays in VARIANTS:
        if SPLIT_LINE.format(split) in src and RAYS_LINE.format(rays) in src:
            return split, rays
    raise RuntimeError("packet_mxu.cu: kSplit / kRays not among VARIANTS")


def build_variants(base):
    """One library per variant but the shipped one: {(split, rays):
    (launch, shape) ctypes functions}."""
    src = (_cuda.CSRC_DIR / "packet_mxu.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "probe_k8_schedule"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for split, rays in VARIANTS:
        if (split, rays) == base:
            continue
        var = src.replace(SPLIT_LINE.format(base[0]), SPLIT_LINE.format(split))
        var = var.replace(RAYS_LINE.format(base[1]), RAYS_LINE.format(rays))
        cu = out_dir / f"packet_mxu_{split}_{rays}.cu"
        cu.write_text(var)
        so = cu.with_suffix(".so")
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
               f"-I{_cuda.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[split, rays] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sig = _cuda.SIGNATURES["packet_mxu"]
    libs = {}
    for key, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(so))
        fns = []
        for name in ("packet_mxu_launch", "packet_mxu_shape"):
            fn = getattr(lib, name)
            fn.argtypes = sig[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[key] = tuple(fns)
    return libs


def run(ctx):
    fns = _cuda.load_kernels().fns
    base = shipped()
    libs = build_variants(base)
    libs[base] = (fns["packet_mxu_launch"], fns["packet_mxu_shape"])
    for key in VARIANTS:
        for tile in (2048, 512):
            out = (ctypes.c_int * len(_cuda.SHAPE_KEYS))()
            err = libs[key][1](tile, out)
            if err != 0:
                raise RuntimeError(f"packet_mxu_shape {key} {tile}: {err}")
            shape = dict(zip(_cuda.SHAPE_KEYS, out))
            print(f"{key[0]} threads a lane, {key[1]} rays a thread"
                  f"{' (shipped)' if key == base else ''}, tile {tile}: "
                  f"{shape}", flush=True)

    def call(key, args, tile):
        saved = fns["packet_mxu_launch"]
        fns["packet_mxu_launch"] = libs[key][0]
        try:
            return packet_mxu.packet_mxu(*args, tile=tile)
        finally:
            fns["packet_mxu_launch"] = saved

    t_tile, s_tile = cs.TERRAIN_KD["tile"], cs.SOUP_KD["tile"]
    calls = {"terrain": (ctx["tree"], ctx["orig"], ctx["dirs"],
                         (cs.SIZE, cs.SIZE), t_tile, None),
             "soup": (ctx["stree"], ctx["s_orig"], ctx["s_dirs"],
                      (cs.SIZE, cs.SIZE), s_tile, None),
             "mirror wave": (ctx["tree"], ctx["bo"], ctx["bd"], None, t_tile,
                             ctx["ba"])}
    for name, (tr, o, d, shape, tile, act) in calls.items():
        args, _ = packet_mxu.mxu_kernel_args(tr, o, d, shape, tile, act)
        ref = call(base, args, tile)
        for key in VARIANTS:
            out = call(key, args, tile)
            bad = [int((x != y).sum()) for x, y in zip(out, ref)]
            if any(bad):
                raise AssertionError(f"{name} {key}: differs from the "
                                     f"shipped kernel (t/slot/stats {bad})")
        timed = [lambda k=k: call(k, args, tile) for k in VARIANTS]
        units = {name: timed}
        if name == "mirror wave":   # its heaviest tile alone
            ti = int(torch.argmax(ref[2][:, 1]))
            lanes = slice(ti * tile, (ti + 1) * tile)
            one = (*args[:3], *(a[..., lanes].contiguous()
                                for a in args[3:]))
            for key in VARIANTS:
                out = call(key, one, tile)
                if not all(torch.equal(x, y[lanes] if x.dim() == 1 else
                                       y[ti:ti + 1])
                           for x, y in zip(out, ref)):
                    raise AssertionError(f"tile {ti} {key}: differs from "
                                         "the full launch")
            units[f"mirror tile {ti} alone ({int(ref[2][ti, 1])} chunks)"] = [
                lambda k=k: call(k, one, tile) for k in VARIANTS]
        st = ref[2].to(torch.float64)
        print(f"{name}: every variant equal to the shipped kernel (exact); "
              f"chunks a tile {float(st[:, 1].mean()):.2f} (max "
              f"{int(st[:, 1].max())})", flush=True)
        for unit, fn_list in units.items():
            ms = cs.turns_ms(fn_list, 3 if "mirror" in unit else 5)
            print(f"{unit}: " + "; ".join(
                f"{k[0]} a lane x {k[1]} a thread"
                f"{' (shipped)' if k == base else ''} {m:.4f} ms"
                for k, m in zip(VARIANTS, ms)), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_k8_schedule.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(kd_context(device))


if __name__ == "__main__":
    os.chdir(Path(__file__).resolve().parents[1])
    main()
