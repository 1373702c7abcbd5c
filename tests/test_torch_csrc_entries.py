"""The ctypes bindings of the port's CUDA entry points (ops/_cuda.py) agree
with the C declarations in ops/csrc/*.cu, and the launch-shape helpers
read what a *_shape entry writes. No JAX, no card: the sources are parsed
and the library is a stand-in."""

import ctypes
import re

import pytest

from clpathtracer_tpu_torch.ops import _cuda

_ENTRIES = [(stem, name) for stem, entries in _cuda.SIGNATURES.items()
            for name in entries]
_DECL = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _declared(stem):
    """{entry: [ctypes type per parameter]} of the extern "C" functions of
    ops/csrc/<stem>.cu: a pointer is c_void_p, an int c_int."""
    src = (_cuda.CSRC_DIR / f"{stem}.cu").read_text()
    out = {}
    for name, params in _DECL.findall(src):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            if "*" in p:
                kinds.append(ctypes.c_void_p)
            elif p.startswith("int "):
                kinds.append(ctypes.c_int)
            else:
                raise AssertionError(f"{stem}.cu {name}: parameter {p!r}")
        out[name] = kinds
    return out


@pytest.mark.parametrize("stem,name", _ENTRIES,
                         ids=[n for _, n in _ENTRIES])
def test_signature_matches_source(stem, name):
    declared = _declared(stem)
    assert name in declared, f"{name} is not extern \"C\" in {stem}.cu"
    assert _cuda.SIGNATURES[stem][name] == declared[name]


@pytest.mark.parametrize("stem", sorted(_cuda.SIGNATURES))
def test_every_entry_is_bound(stem):
    # an entry the source exports but the table misses could not be called
    assert set(_declared(stem)) == set(_cuda.SIGNATURES[stem])


def _fake_library(monkeypatch, err=0):
    """load_kernels() returns a library whose *_shape entries write
    10 + i into out[i] and return `err`; records the arguments."""
    calls = []

    def shape(*args):
        calls.append(args[:-1])
        out = args[-1]
        for i in range(len(out)):
            out[i] = 10 + i
        return err
    fns = {name: shape for stem in _cuda.SIGNATURES
           for name in _cuda.SIGNATURES[stem] if name.endswith("_shape")}
    lib = _cuda.KernelLibrary(fns=fns, paths=(), build_seconds=0.0,
                              build_log="")
    monkeypatch.setattr(_cuda, "load_kernels", lambda: lib)
    return calls


def test_grid_shape_reads_the_entry(monkeypatch):
    calls = _fake_library(monkeypatch)
    assert _cuda.grid_shape() == {
        "threads": 10, "ray_threads": 11, "blocks_per_sm": 12,
        "registers": 13, "static_smem": 14, "local_bytes": 15}
    assert calls == [()]


def test_walk_shapes_read_their_entries(monkeypatch):
    calls = _fake_library(monkeypatch)
    assert _cuda.grid_shape("ray_walk_shape") == dict(
        zip(_cuda.GRID_SHAPE_KEYS, range(10, 16)))
    assert _cuda.brute_force_shape() == {
        "threads": 10, "thread_rays": 11, "blocks_per_sm": 12,
        "registers": 13, "static_smem": 14, "local_bytes": 15}
    assert calls == [(), ()]


def test_ptxas_report_picks_the_kernel():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
        "ray_walk_kernelEPK6float4' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115"
        "ray_walk_kernelEPK6float4",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, 12288 bytes smem",
        "ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'",
        "ptxas info    : Used 8 registers"])
    assert _cuda.ptxas_report(log, "ray_walk_kernel") == (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 96 registers, 12288 bytes smem")
    assert _cuda.ptxas_report(log, "brute_force_scan") == ""


# the arguments before `out` of the shape entries that take other than
# (1, 16): K7's and K8's take the tile alone
SHAPE_ARGS = {"packet_stream2_shape": (2048,), "packet_mxu_shape": (512,)}


@pytest.mark.parametrize("entry", ["plist_super_shape", "plist_window_shape",
                                   "plist_gathered_shape",
                                   "plist_subgate_shape",
                                   "packet_queue_shape", "packet_v1_shape",
                                   "packet_stream2_shape",
                                   "packet_mxu_shape"])
def test_cluster_shape_reads_the_entry(monkeypatch, entry):
    calls = _fake_library(monkeypatch)
    ints = SHAPE_ARGS.get(entry, (1, 16))
    sig = next(e[entry] for e in _cuda.SIGNATURES.values() if entry in e)
    assert len(sig) == len(ints) + 1
    assert _cuda.cluster_shape(entry, *ints) == dict(
        zip(_cuda.SHAPE_KEYS, range(10, 16)))
    assert calls == [ints]


def test_shape_error_raises(monkeypatch):
    _fake_library(monkeypatch, err=9)
    with pytest.raises(RuntimeError, match="plist_window_shape.*cudaError 9"):
        _cuda.cluster_shape("plist_window_shape", 0, 16)
    with pytest.raises(RuntimeError, match="grid_dda_shape.*cudaError 9"):
        _cuda.grid_shape()
