"""Build and load the port's CUDA kernels at first use.

Every ops/csrc/*.cu is compiled by nvcc for sm_90a (Hopper) into one
shared library with a plain C interface, which is bound with ctypes.
The library goes to clpathtracer_tpu_torch/_build/<hash>/, keyed by a
hash of the sources and the flags, so a changed source is rebuilt and an
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
LIB_NAME = "libclpt_kernels.so"

# --fmad=false: no multiply-add contraction, so the kernels round every
# product and sum as the plain torch versions do and match them exactly.
# -Xptxas -v: the build log reports registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every one returns cudaGetLastError() after its launch
SIGNATURES = {
    # key, sid, bits, rows, dir_t, t0, best_t, best_slot, stats,
    # n_gates, list_len, win_rows, stream
    "plist_super_launch": [_P] * 9 + [_I] * 3 + [_P],
    # key, sid, bits, rows, orig_t, dir_t, t0, best_t, best_slot, stats,
    # n_gates, list_len, win_rows, stream
    "plist_super_mt_launch": [_P] * 10 + [_I] * 3 + [_P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it failed on the sources."""


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an existing build was loaded
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


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_kernels() -> KernelLibrary:
    """Build (if needed) and load the kernel library. Raises
    KernelBuildError with the compiler's stderr when the build fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    out = BUILD_DIR / _source_hash(sources + headers) / LIB_NAME
    seconds, log = 0.0, ""
    if not out.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                " the CUDA kernels of clpathtracer_tpu_torch are compiled "
                f"from {CSRC_DIR} at first use and need the CUDA toolkit")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc exited with {proc.returncode}:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds,
                         build_log=log)
