"""Native (C++) SAH kd-tree builder, built with g++ at first use and
loaded with ctypes (the port's counterpart of
clpathtracer_tpu/accel/native/__init__.py).

The library goes to clpathtracer_tpu_torch/_build/<hash>/, keyed by a
hash of the source and the flags: a changed source is rebuilt, an
unchanged one is loaded as it is. Concurrent builders (test workers)
each compile into a temporary file and move it into place with
os.replace. A missing or failing g++ raises NativeBuildError; there is
no numpy fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("sah_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
LIB_NAME = "libclpt_sah_native.so"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


class NativeBuildError(RuntimeError):
    """g++ is missing, or it failed on the source."""


def build_library(src: Path, lib_name: str, build_dir: Path,
                  what: str) -> Path:
    """Compile `src` with g++ and CXX_FLAGS into build_dir/<hash>/lib_name
    (the hash of the flags and the source) unless it is there already;
    return the library's path. `what` names the library in the error."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    out = build_dir / h.hexdigest()[:16] / lib_name
    if not out.is_file():
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeBuildError(
                f"g++ not found on PATH: the port's {what} is compiled from "
                f"{src} at first use")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{lib_name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(src), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"g++ exited with {proc.returncode}:\n{' '.join(cmd)}\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the builder library."""
    lib = ctypes.CDLL(str(build_library(SRC, LIB_NAME, BUILD_DIR,
                                        "kd-tree builder")))
    lib.kd_build.restype = ctypes.c_void_p
    lib.kd_build.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                             ctypes.c_int32, ctypes.c_int32]
    lib.kd_num_nodes.restype = ctypes.c_int64
    lib.kd_num_nodes.argtypes = [ctypes.c_void_p]
    lib.kd_num_tri_indices.restype = ctypes.c_int64
    lib.kd_num_tri_indices.argtypes = [ctypes.c_void_p]
    lib.kd_export.restype = None
    lib.kd_export.argtypes = [ctypes.c_void_p] * 3
    lib.kd_free.restype = None
    lib.kd_free.argtypes = [ctypes.c_void_p]
    return lib


def build_kd_native(tri_verts: np.ndarray, max_depth: int, leaf_size: int,
                    tri_block: int = 4):
    """Build with the C++ builder. tri_verts: [F, 3, 3] corners. Returns
    (node_table [M, 24] f32, tri_indices [T] i32), the quad-row
    (tri_block=4) layout; other tri_block values raise ValueError."""
    if tri_block != 4:
        raise ValueError(f"the native builder emits tri_block=4 trees, "
                         f"got tri_block={tri_block}")
    tv = np.ascontiguousarray(tri_verts, np.float32)
    if tv.ndim != 3 or tv.shape[1:] != (3, 3):
        raise ValueError(f"tri_verts must be [F, 3, 3], got {tv.shape}")
    lib = load()
    n = tv.shape[0]
    handle = lib.kd_build(tv.ctypes.data, n, max_depth, leaf_size,
                          tri_block)
    try:
        m = lib.kd_num_nodes(handle)
        t = lib.kd_num_tri_indices(handle)
        table = np.empty((m, 24), np.float32)
        tri_indices = np.empty((t,), np.int32)
        lib.kd_export(handle, table.ctypes.data, tri_indices.ctypes.data)
    finally:
        lib.kd_free(handle)
    # node and triangle ids ride the f32 node table; beyond 2^24 they
    # would round
    if max(m, n, t) >= 1 << 24:
        raise ValueError(f"{m} nodes / {n} triangles / {t} slots overflow "
                         "the f32-exact id range of the node table")
    return table, tri_indices
