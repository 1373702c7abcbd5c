#!/usr/bin/env python3
"""K11's two schedule choices: how a gate's stats row is reduced, and
which warps scan the list.

    python3 probes/probe_k11_schedule.py

The sub-gate kernel K11 (clpathtracer_tpu_torch/ops/csrc/plist_subgate.cu)
runs the four sub-gates of a gate as independent blocks that raise the
stats row with atomicMax on rows the launch zeroed, and every warp scans
the list for the sub-gate's next window. This probe builds the two
designs it was measured against, and both together, by the edits in
EDITS on a copy of that source: "cluster" (the four sub-gates as one
cluster that reduces the row through cluster.cuh and leaves together) and
"warp 0" (warp 0 scans, issues the window's copy with its 32 threads and
passes the index on through shared memory). One nvcc each, all started
together, into the git-ignored clpathtracer_tpu_torch/_build/. Runs each
on chip_smoke.py's K11 inputs (the 1M terrain at win_rows 16 and the 1M
soup at win_rows 8, 512x512 primaries in sub-gate order, phase 31's
lists), SO and MT, holds every variant's outputs exactly equal to the
shipped kernel's (t, slot, the five stats lanes), and times all variants
in turns on each call and on the heaviest sub-gate alone
(chip_smoke.subgate_tail). Prints the card line, each variant's launch
shape, then one line per call and variant. Needs one CUDA card and nvcc;
exits non-zero otherwise.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from clpathtracer_tpu_torch.ops import _cuda, plist  # noqa: E402

# Each design as edits of the shipped source: (text, its replacement, the
# times the text occurs).
EDITS = {
    "cluster": (
        ("""  if (threadIdx.x == 0) {  // the JAX tile_stats[::8, :5] columns; the
    int* st = stats + 5 * g;  // launch entry zeroed the row
    atomicMax(st + 1, kSub * ns);
    st[2] = kGate;
    atomicMax(st + 4, kSub * ns);
  }
""", """  __shared__ clpt::ClusterSlots<1> slots;
  float most = (float)ns;  // exact: a count of windows
  int cpar = 0;
  clpt::cluster_reduce<1>(&most, slots, cpar, clpt::MaxOp(), -INFINITY);
  if (s == 0 && threadIdx.x == 0) {
    int* st = stats + 5 * g;
    st[0] = 0;
    st[1] = kSub * (int)most;
    st[2] = kGate;
    st[3] = 0;
    st[4] = kSub * (int)most;
  }
  clpt::cluster_end();
""", 1),
        ("""  const cudaError_t err = cudaMemsetAsync(
      stats, 0, (size_t)n_gates * 5 * sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
""", "", 1),
        ("plist_subgate_kernel<kMT, kSplit<kMT>>, 1,",
         "plist_subgate_kernel<kMT, kSplit<kMT>>, kSub,", 1),
        ("  1, kLanes * kSplit<", "  kSub, kLanes * kSplit<", 2),
    ),
    "warp 0": (
        ("template <bool kMT, int kS>\n__global__", """// Warp 0 scans and leaves the index in *box, read by every warp after
// the caller's next barrier; the other warps get list_len.
__device__ __forceinline__ int scan0(const float* key, const int* pay,
                                     int list_len, int j, float tup,
                                     int sbit, int* box) {
  if (threadIdx.x >= 32) return list_len;
  const int f = next_entry(key, pay, list_len, j, tup, sbit);
  if (threadIdx.x == 0) *box = f;
  return f;
}

// copy_recs by warp 0's 32 threads.
__device__ __forceinline__ void copy_recs32(float4* dst,
                                            const float4* __restrict__ rows,
                                            long long rec0, int n_recs) {
  for (int i = threadIdx.x; i < n_recs * kUsedF4; i += 32)
    clpt::cp_async16(dst + i, rows + (rec0 + i / kUsedF4) * clpt::kRecF4 +
                                  i % kUsedF4);
  clpt::cp_async_commit();
}

template <bool kMT, int kS>
__global__""", 1),
        ("  int j = next_entry(gkey, gpay, list_len, 0, tup, sbit);",
         """  __shared__ int box[2];  // two slots: a write of the next round
  int par = 0;            // never meets a read of this one
  int j = scan0(gkey, gpay, list_len, 0, tup, sbit, box);""", 1),
        ("    copy_recs(", "    copy_recs32(", 2),
        ("  __syncthreads();  // window j has landed\n",
         "  __syncthreads();  // window j has landed\n  j = box[0];\n", 1),
        ("    const int jn = next_entry(gkey, gpay, list_len, j + 1, tup, "
         "sbit);",
         """    par ^= 1;
    const int jn = scan0(gkey, gpay, list_len, j + 1, tup, sbit, box + par);""",
         1),
        ("    j = jn;\n    cur ^= 1;", "    j = box[par];\n    cur ^= 1;", 1),
    ),
}
# the shipped design first, then each other one
VARIANTS = ((), ("cluster",), ("warp 0",), ("cluster", "warp 0"))
ENTRIES = ("plist_subgate_launch", "plist_subgate_mt_launch",
           "plist_subgate_shape")


def variant_source(src, key):
    """The shipped source with the edits of each design in key."""
    for design in key:
        for old, new, count in EDITS[design]:
            if src.count(old) != count:
                raise RuntimeError(f"plist_subgate.cu: {old!r} occurs "
                                   f"{src.count(old)} times, not {count}: "
                                   f"EDITS[{design!r}] is out of date")
            src = src.replace(old, new)
    return src


def build_variants():
    """One library per variant but the shipped one: {variant: {entry:
    ctypes function}}."""
    src = (_cuda.CSRC_DIR / "plist_subgate.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "probe_k11_schedule"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key in VARIANTS[1:]:
        cu = out_dir / f"plist_subgate_{'_'.join(key).replace(' ', '')}.cu"
        cu.write_text(variant_source(src, key))
        so = cu.with_suffix(".so")
        cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS,
               f"-I{_cuda.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[key] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sig = _cuda.SIGNATURES["plist_subgate"]
    libs = {}
    for key, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        lib = ctypes.CDLL(str(so))
        fns = {}
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = sig[name]
            fn.restype = ctypes.c_int
            fns[name] = fn
        libs[key] = fns
    return libs


def label(key):
    return " + ".join(key) if key else "shipped"


def run(device):
    t = time.perf_counter()
    scene = cs.terrain_mesh(cs.N_TRIS, seed=0, extent=10.0,
                            device=device).bake_shading()
    soup = cs.random_tri_soup(cs.N_TRIS, seed=0, extent=10.0, tri_size=0.01,
                              device=device).bake_shading()
    cam = cs.Camera.create(cs.POS, cs.FWD, device=device)
    scam = cs.Camera.create(cs.SOUP_POS, cs.SOUP_FWD, device=device)
    inputs = cs.schedule_inputs(device, scene, soup, cam, scam)
    torch.cuda.synchronize()
    print(f"inputs built in {time.perf_counter() - t:.1f} s", flush=True)
    fns = _cuda.load_kernels().fns
    base = VARIANTS[0]
    libs = build_variants()
    libs[base] = {name: fns[name] for name in ENTRIES}
    for key in VARIANTS:
        for mt in (0, 1):
            out = (ctypes.c_int * len(_cuda.SHAPE_KEYS))()
            err = libs[key]["plist_subgate_shape"](mt, cs.WIN_ROWS, out)
            if err != 0:
                raise RuntimeError(f"plist_subgate_shape {key}: {err}")
            print(f"{label(key)}, {'MT' if mt else 'SO'}: "
                  f"{dict(zip(_cuda.SHAPE_KEYS, out))}", flush=True)

    def call(key, args, kw):
        saved = {n: fns[n] for n in ENTRIES}
        fns.update(libs[key])
        try:
            return plist.plist_subgate(*args, **kw)
        finally:
            fns.update(saved)

    n_gates = cs.SIZE * cs.SIZE // plist.GATE
    lanes = plist.GATE // plist.SUB
    for name, x in inputs.items():
        key4, pay4 = plist.gate_lists4(x.mwin.win_bnd, x.dir_bs, x.o)
        forms = {"SO": ((key4, pay4, x.rows, x.dir_s), dict(win_rows=x.wr)),
                 "MT": ((key4, pay4, x.mwin.tris, x.dir_s),
                        dict(win_rows=x.wr, orig_t=x.orig_s))}
        for form, (args, kw) in forms.items():
            ref = call(base, args, kw)
            for key in VARIANTS:
                out = call(key, args, kw)
                bad = [int((a != b).sum()) for a, b in zip(out, ref)]
                if any(bad):
                    raise AssertionError(f"{name} {form} {key}: differs from "
                                         f"the shipped kernel {bad}")
            units = {f"{name} {form}": (args, kw)}
            if form == "SO":   # the heaviest sub-gate alone
                sub_key, sub_wid = plist._subgate_lists(key4, pay4)
                _, _, sub_ns = plist._window_stream(
                    sub_key, sub_wid, plist._records(x.rows, x.wr * 8),
                    plist._group_test(None, x.dir_s, lanes),
                    torch.full((n_gates * plist.SUB, lanes), cs.BIG,
                               device=device), x.wr * 8)
                r = cs.SimpleNamespace(args=args, kw=kw, out=ref)
                tail = cs.subgate_tail(r, x.wr, sub_ns, {"ms": None})
                for key in VARIANTS:
                    out = call(key, tail.args, kw)
                    bad = [int((a != b).sum()) for a, b in zip(out,
                                                               tail.full)]
                    if any(bad):
                        raise AssertionError(f"{name} {tail.unit} {key}: "
                                             f"differs from the full launch "
                                             f"{bad}")
                units[f"{name} {tail.unit} alone ({int(sub_ns.max())} "
                      "windows)"] = (tail.args, kw)
            for unit, (a, k) in units.items():
                ms = cs.turns_ms([lambda key=key, a=a, k=k: call(key, a, k)
                                  for key in VARIANTS], 20)
                print(f"{unit}: every variant equal to the shipped kernel "
                      "(exact); " + "; ".join(
                          f"{label(key)} {m:.4f} ms"
                          for key, m in zip(VARIANTS, ms)), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_k11_schedule.py needs a CUDA device")
    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(device)


if __name__ == "__main__":
    main()
