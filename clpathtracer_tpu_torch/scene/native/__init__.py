"""Native (C++) Wavefront OBJ scanner, built with g++ at first use and
loaded with ctypes (the port's counterpart of
clpathtracer_tpu/scene/native/__init__.py).

The scanner reads the geometry records, the hot path of a large OBJ, and
hands the numbers back as SoA numpy arrays. Material resolution (mtllib
file IO, Kd/Ke lookup) stays in Python: it touches the filesystem and
runs once per material, not per line.

The library is built as accel/native builds the kd-tree builder
(accel/native/__init__.py::build_library): into
clpathtracer_tpu_torch/_build/<hash>/, keyed by a hash of the source and
the flags, a temporary file moved into place with os.replace; never into
this source directory. A missing or failing g++ raises NativeBuildError.
Malformed input raises NativeObjError, whose message names the error kind
of the Python parser (scene/objparser.py), the arbiter of such input.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from clpathtracer_tpu_torch.accel.native import NativeBuildError, build_library

SRC = Path(__file__).resolve().with_name("obj_native.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
LIB_NAME = "libclpt_obj_native.so"

__all__ = ["NativeBuildError", "NativeObjError", "load", "parse_obj_native"]


class NativeObjError(ValueError):
    """The scanner rejected its input."""


def load() -> ctypes.CDLL:
    """Build (if needed) and load the scanner library from BUILD_DIR."""
    return _load(BUILD_DIR)


@functools.lru_cache(maxsize=None)
def _load(build_dir: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library(SRC, LIB_NAME, build_dir,
                                        "OBJ scanner")))
    lib.obj_parse.restype = ctypes.c_void_p
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [ctypes.c_void_p]
    lib.obj_counts.restype = None
    lib.obj_counts.argtypes = [ctypes.c_void_p,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.obj_export.restype = None
    lib.obj_export.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_char_p] * 2
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_obj_native(text: str):
    """Parse OBJ text with the native scanner.

    Returns (geometry dict like objparser.parse_obj's without albedo and
    emission, tri_mat [F] i32 material ids (-1: none), the material names
    in first-use order, the mtllib names in order). Raises NativeObjError
    on malformed input."""
    lib = load()
    data = text.encode("utf-8", errors="replace")
    h = lib.obj_parse(data, len(data))
    try:
        err = lib.obj_error(h)
        if err:
            raise NativeObjError(err.decode())
        counts = (ctypes.c_int64 * 6)()
        lib.obj_counts(h, counts)
        nv, nn, nt, nf, mat_len, lib_len = (int(c) for c in counts)
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nn, 3), np.float32)
        vt = np.empty((nt, 2), np.float32)
        faces = np.empty((nf, 3, 3), np.int32)
        tri_mat = np.empty((nf,), np.int32)
        matbuf = ctypes.create_string_buffer(max(mat_len, 1))
        libbuf = ctypes.create_string_buffer(max(lib_len, 1))
        lib.obj_export(h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data,
                       faces.ctypes.data, tri_mat.ctypes.data, matbuf, libbuf)
        mats = (matbuf.raw[:mat_len].decode("utf-8", errors="replace")
                .split("\n")[:-1] if mat_len else [])
        libs = (libbuf.raw[:lib_len].decode("utf-8", errors="replace")
                .split("\n")[:-1] if lib_len else [])
    finally:
        lib.obj_free(h)

    # the Python parser's out-of-range checks
    if faces.size and (np.any(faces[..., 0] < 0)
                       or np.any(faces[..., 0] >= nv)):
        raise NativeObjError("face references out-of-range vertex index")
    if faces.size and np.any(faces[..., 1] >= nn):
        raise NativeObjError("face references out-of-range normal index")
    geo = {"verts": v, "normals": vn, "texcoords": vt, "faces": faces}
    return geo, tri_mat, mats, libs
