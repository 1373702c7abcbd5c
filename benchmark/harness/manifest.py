"""BENCHMARK.json and the files it names, found by name: a cell's
configuration file, its traffic file (traffic/<traffic>.json), its
limits (limits/<cell>.json), and each metric's reader
(metrics/<metric>.py, a module with read(record) -> float or None). A
metric named <base>.<part> is <base>'s quantity in other cells, under a
bound or an end-to-end metric of its own: without a file of its own it is
read by metrics/<base>.py."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    limits: dict          # the limits file's contents
    end_to_end: list      # BENCHMARK.json entries of the cell's e2e metrics
    per_layer: list       # ... and of its per-layer metrics
    bench_dir: Path


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    """A metric with "workloads" is the listed cells'; an end-to-end metric
    without it every cell's, a per-layer one every cell's that reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    bench = root / "benchmark"
    e2e = [m for m in manifest["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((root / cfg["file"]).read_text()),
                traffic=json.loads(
                    (bench / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads(
                    (bench / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench)


def reader_path(bench_dir: Path, metric: str) -> Path:
    """metrics/<metric>.py, or metrics/<base>.py for <base>.<part>."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    return path


def reader(bench_dir: Path, metric: str):
    """The reader module of a metric, loaded from its file."""
    path = reader_path(bench_dir, metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
