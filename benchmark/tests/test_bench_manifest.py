"""BENCHMARK.json against the benchmark's contract, and a cell and a
metric added by files alone."""

import json
import re
import shutil
import time

import torch

from benchmark.harness import manifest, run_cell
from conftest import ROOT, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert all(_line(w) for w in b["command"])
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
        assert manifest.reader_path(ROOT / "benchmark", m["name"]).is_file()
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for name in cells:   # every cell reports setup_s, another e2e and a layer
        cell = manifest.load_cell(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer


def test_a_cell_and_a_metric_are_added_by_files(tmp_path):
    """A copy of the benchmark with one more traffic mix, cell and metric,
    each a new file and a new entry: no file that was there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    (bench / "traffic" / "mirror-64.json").write_text(json.dumps(
        {"why": "a small mirror frame", "mode": "mirror", "width": 64,
         "height": 32, "spp": 1, "bounces": 3, "nee": False,
         "background": 0.5, "draw_sets": 1, "warmup_frames": 1}))
    (bench / "limits" / "soup-1m.mirror-64.json").write_text(json.dumps(
        {"frames": 2, "pixels": 64, "atol": 1e-4, "rtol": 1e-3,
         "numbers": {"bad_px": {"limit": 0.02}}}))
    (bench / "metrics" / "frames_per_s.py").write_text(
        "def read(r):\n    return r.frames / r.window_s\n")
    b["workloads"].append({"name": "soup-1m.mirror-64", "config": "soup-1m",
                           "traffic": "mirror-64", "chips": 1,
                           "why": "a small mirror frame of the fog"})
    b["end_to_end"].append({"name": "frames_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["soup-1m.mirror-64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = manifest.load_cell("soup-1m.mirror-64", root=tmp_path)
    assert cell.bench_dir == bench
    assert "frames_per_s" in {m["name"] for m in cell.end_to_end}
    res, _ = run_cell.run(tiny(cell), 77, 0.3, False, torch.device("cpu"),
                          time.time())
    assert res["correct"] and res["metrics"]["frames_per_s"]["value"] > 0
    # the cells that were there do not report the new metric
    old = manifest.load_cell("terrain-1m.preview-1440p", root=tmp_path)
    assert "frames_per_s" not in {m["name"] for m in old.end_to_end}


def test_a_split_metric_is_read_by_its_base():
    """<base>.<part>, without a file of its own, is read by <base>'s
    reader; a cell reports only the parts that list it."""
    bench = ROOT / "benchmark"
    assert manifest.reader_path(bench, "k1_ms.preview") == \
        bench / "metrics" / "k1_ms.py"
    assert manifest.reader_path(bench, "frame_ms") == \
        bench / "metrics" / "frame_ms.py"
    preview = manifest.load_cell("terrain-1m.preview-1440p")
    mirror = manifest.load_cell("terrain-1m.mirror-720p")
    soup = manifest.load_cell("soup-1m.path-nee-720p")
    for cell, part in ((preview, "frame_ms.preview"),
                       (mirror, "frame_ms.mirror")):
        e2e = {m["name"] for m in cell.end_to_end}
        assert part in e2e and "frame_ms" not in e2e
        assert {m["moves"] for m in cell.per_layer} <= e2e
    assert "k1_ms.preview" in {m["name"] for m in preview.per_layer}
    assert "k1_ms.mirror" in {m["name"] for m in mirror.per_layer}
    assert "k1_ms.preview" not in {m["name"] for m in mirror.per_layer}
    assert "frame_ms" in {m["name"] for m in soup.end_to_end}
    assert {m["moves"] for m in soup.per_layer} <= {
        m["name"] for m in soup.end_to_end}
