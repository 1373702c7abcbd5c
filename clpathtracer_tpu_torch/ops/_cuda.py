"""Build and load the port's CUDA kernels at first use.

Every ops/csrc/*.cu is compiled by its own nvcc process for sm_90a
(Hopper), all of them started together, into one shared library per
source with a plain C interface, bound with ctypes. A library goes to
clpathtracer_tpu_torch/_build/<hash>/, keyed by a hash of its source, the
shared headers and the flags, so a changed source is rebuilt and an
unchanged one is loaded as it is. Nothing is downloaded: the build uses
the repository's sources and the installed CUDA toolkit only.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum as the plain torch versions do and match them exactly.
# -Xptxas -v: the build log reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points by source: every launch returns cudaGetLastError() after
# the launch; a *_shape entry writes a launch's shape (cluster_shape,
# grid_shape)
SIGNATURES = {
    "plist_super": {
        # key, sid, bits, rows, dir_t, t0, best_t, best_slot, stats,
        # n_gates, list_len, win_rows, jcap, stream
        "plist_super_launch": [_P] * 9 + [_I] * 4 + [_P],
        # key, sid, bits, rows, orig_t, dir_t, t0, best_t, best_slot, stats,
        # n_gates, list_len, win_rows, jcap, stream
        "plist_super_mt_launch": [_P] * 10 + [_I] * 4 + [_P],
        # key, wid, rows, dir_t, t0, best_t, best_slot, stats, n_gates,
        # list_len, win_rows, stream
        "plist_window_launch": [_P] * 8 + [_I] * 3 + [_P],
        # key, wid, rows, orig_t, dir_t, t0, best_t, best_slot, stats,
        # n_gates, list_len, win_rows, stream
        "plist_window_mt_launch": [_P] * 9 + [_I] * 3 + [_P],
        # ten, ids, table, dir_t, t0, best_t, best_slot, stats, n_gates,
        # kmax, cwin, win_rows, stream
        "plist_gathered_launch": [_P] * 8 + [_I] * 4 + [_P],
        # mt, win_rows, out [6] i32
        "plist_super_shape": [_I, _I, _P],
        # mt, win_rows, out [6] i32
        "plist_window_shape": [_I, _I, _P],
    },
    "plist_subgate": {
        # key, pay, rows, dir_t, best_t, best_slot, stats, n_gates,
        # list_len, win_rows, stream
        "plist_subgate_launch": [_P] * 7 + [_I] * 3 + [_P],
        # key, pay, rows, orig_t, dir_t, best_t, best_slot, stats, n_gates,
        # list_len, win_rows, stream
        "plist_subgate_mt_launch": [_P] * 8 + [_I] * 3 + [_P],
    },
    "packet_stream": {
        # nodes_i, nodes_f, rows, orig_t, dir_t, act, cbnd, frustum, masks,
        # ten, best_t, best_slot, stats, overflow, n_rays, tile, n_rows,
        # n_windows, mode, n_strips, so, bf16, stream
        "packet_stream_launch": [_P] * 14 + [_I] * 8 + [_P],
        # tile, so, bf16, out [6] i32
        "packet_stream_shape": [_I, _I, _I, _P],
    },
    "packet_queue": {
        # nodes_i, nodes_f, rows, orig_t, dir_t, act, cbnd, best_t,
        # best_slot, stats, overflow, n_rays, tile, n_rows, so, stream
        "packet_queue_launch": [_P] * 11 + [_I] * 4 + [_P],
        # tile, so, out [6] i32
        "packet_queue_shape": [_I, _I, _P],
    },
    "packet_stream2": {
        # nodes_i, nodes_f, rows, orig_t, dir_t, act, best_t, best_slot,
        # stats, overflow, n_rays, tile, n_rows, stream
        "packet_stream2_launch": [_P] * 10 + [_I] * 3 + [_P],
        # tile, out [6] i32
        "packet_stream2_shape": [_I, _P],
    },
    "packet_mxu": {
        # nodes_i, nodes_f, chunks, orig_t, dir_t, act, best_t, best_slot,
        # stats, overflow, n_rays, tile, n_chunks, stream
        "packet_mxu_launch": [_P] * 10 + [_I] * 3 + [_P],
        # tile, out [6] i32
        "packet_mxu_shape": [_I, _P],
    },
    "grid_dda": {
        # table, geom, orig, dir, t_max, active, out_t, out_tri, out_u,
        # out_v, out_steps, next_ray, n, rx, ry, rz, nrows, max_iters,
        # any_hit, stream
        "grid_dda_launch": [_P] * 12 + [_I] * 7 + [_P],
        # out [6] i32
        "grid_dda_shape": [_P],
    },
    "ray_walk": {
        # table, leaf_first, recs, orig, dir, t_max, active, out_t, out_slot,
        # out_steps, next_ray, n, n_recs, block, max_iters, any_hit, stream
        "ray_walk_launch": [_P] * 11 + [_I] * 5 + [_P],
        # out [6] i32
        "ray_walk_shape": [_P],
    },
    "brute_force": {
        # recs, orig, dir, key, out_t, out_prim, out_u, out_v, n, f,
        # eps_bits, stream
        "brute_force_launch": [_P] * 8 + [_I] * 3 + [_P],
        # out [6] i32
        "brute_force_shape": [_P],
    },
    "packet_v1": {
        # table, recs, orig_t, dir_t, best_t, best_slot, stats, overflow,
        # n_rays, tile, n_recs, engine, stream
        "packet_v1_launch": [_P] * 8 + [_I] * 4 + [_P],
        # tile, engine, out [6] i32
        "packet_v1_shape": [_I, _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it failed on the sources."""


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    fns: dict              # C entry name -> bound ctypes function
    paths: tuple           # the shared libraries, one per source
    build_seconds: float   # wall time of the parallel build (0.0: none)
    build_log: str         # nvcc's output ("" when nothing was built)


def find_nvcc():
    """Path of nvcc: on PATH, else under $CUDA_HOME/bin or
    /usr/local/cuda/bin. None when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _lib_path(src: Path, headers) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *headers):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{src.stem}.so"


@functools.lru_cache(maxsize=None)
def load_kernels() -> KernelLibrary:
    """Build what is missing (one nvcc per source, in parallel) and load
    the libraries. Raises KernelBuildError with the compiler's stderr when
    a build fails."""
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    outs = {stem: _lib_path(CSRC_DIR / f"{stem}.cu", headers)
            for stem in SIGNATURES}
    missing = {s: p for s, p in outs.items() if not p.is_file()}
    seconds, log = 0.0, ""
    if missing:
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                " the CUDA kernels of clpathtracer_tpu_torch are compiled "
                f"from {CSRC_DIR} at first use and need the CUDA toolkit")
        start = time.perf_counter()
        procs = {}
        for stem, out in missing.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{stem}.cu")]
            procs[stem] = (cmd, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for stem, (cmd, tmp, proc) in procs.items():
            text, _ = proc.communicate()
            log += text
            if proc.returncode != 0:
                failed.append(f"nvcc exited with {proc.returncode}:\n"
                              f"{' '.join(cmd)}\n{text}")
            else:
                os.replace(tmp, missing[stem])
        seconds = time.perf_counter() - start
        if failed:
            raise KernelBuildError("\n".join(failed))
    fns = {}
    for stem, entries in SIGNATURES.items():
        lib = ctypes.CDLL(str(outs[stem]))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return KernelLibrary(fns=fns, paths=tuple(outs.values()),
                         build_seconds=seconds, build_log=log)


SHAPE_KEYS = ("cluster", "threads", "max_active_clusters", "registers",
              "static_smem", "dynamic_smem")
GRID_SHAPE_KEYS = ("threads", "ray_threads", "blocks_per_sm", "registers",
                   "static_smem", "local_bytes")
BF_SHAPE_KEYS = ("threads", "thread_rays", "blocks_per_sm", "registers",
                 "static_smem", "local_bytes")


def _shape(entry, keys, ints) -> dict:
    out = (ctypes.c_int * len(keys))()
    err = load_kernels().fns[entry](*ints, out)
    if err != 0:
        raise RuntimeError(f"{entry}{tuple(ints)} failed: cudaError {err}")
    return dict(zip(keys, out))


def cluster_shape(entry, *ints) -> dict:
    """The launch shape that the *_shape C entry `entry` reports for its
    kernel at `ints` (ops/csrc/cluster.cuh::cluster_shape): blocks per
    cluster, threads per block, the clusters resident on the card at once,
    registers per thread, static and dynamic shared memory bytes per
    block. Needs the card; raises on a CUDA error."""
    return _shape(entry, SHAPE_KEYS, ints)


def grid_shape(entry: str = "grid_dda_shape") -> dict:
    """The launch shape of a per-ray walk: G1 (ops/csrc/grid_dda.cu::
    grid_dda_shape) or, with entry "ray_walk_shape", W1: threads per
    block, threads per ray, blocks resident on one SM, registers per
    thread, static shared memory bytes per block and local (spill) bytes
    per thread. Needs the card; raises on a CUDA error."""
    return _shape(entry, GRID_SHAPE_KEYS, ())


def brute_force_shape() -> dict:
    """W2's scan launch shape (ops/csrc/brute_force.cu::brute_force_shape):
    threads per block, rays per thread, blocks resident on one SM,
    registers per thread, static shared memory bytes per block and local
    (spill) bytes per thread. Needs the card; raises on a CUDA error."""
    return _shape("brute_force_shape", BF_SHAPE_KEYS, ())


def ptxas_report(log: str, kernel: str) -> str:
    """What `nvcc -Xptxas -v` said of the kernel whose mangled name holds
    `kernel`, in a build log (KernelLibrary.build_log): its stack frame and
    spill line and its "Used ... registers" line, joined; "" when the log
    does not have it (a library loaded from the build directory)."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("spill" in line or "Used" in line):
            out.append(line.split(":", 1)[-1].strip() if "ptxas" in line
                       else line.strip())
    return "; ".join(out)
