"""The benchmark's own tests (python -m pytest benchmark/tests -q, from
the repository's root): the reference held to the port at tiny sizes on
the CPU, the faults and the control that the check must catch, the
import rules, and that a cell or a metric is added by files alone. Tests
marked `card` need a CUDA device and skip without one."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ("terrain-1m.preview-1440p", "soup-1m.path-nee-720p",
         "terrain-1m.mirror-720p", "terrain-1m.path-nee-720p")


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


def tiny(cell, num_tris=1500, width=64, height=32, frames=2, pixels=64):
    """A copy of a cell at a size the CPU runs in seconds: the same kinds
    of scene, camera path, traffic and check, smaller."""
    cell = copy.deepcopy(cell)
    scene = cell.config["scene"]
    if "tri_size" in scene:   # as much of the view covered as at full size
        scene["tri_size"] = min(0.2, scene["tri_size"]
                                * (scene["num_tris"] / num_tris) ** 0.5)
    scene["num_tris"] = num_tris
    cell.traffic.update(width=width, height=height, warmup_frames=1)
    cell.limits.update(frames=frames, pixels=pixels)
    return cell


@pytest.fixture(scope="session")
def cells():
    from benchmark.harness import manifest
    return {name: manifest.load_cell(name) for name in CELLS}
