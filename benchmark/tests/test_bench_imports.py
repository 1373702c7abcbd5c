"""What the benchmark's processes load: no JAX and no JAX package (top-
level module names compared whole, so clpathtracer_tpu_torch is not
clpathtracer_tpu), and a reference that loads nothing of the port."""

import json
import subprocess
import sys

from conftest import ROOT

HARNESS = ("benchmark.harness.run_cell", "benchmark.harness.check",
           "benchmark.harness.system", "benchmark.harness.trace",
           "benchmark.harness.manifest")
REFERENCE = ("benchmark.reference.inputs", "benchmark.reference.camera",
             "benchmark.reference.brute", "benchmark.reference.render",
             "benchmark.reference.scenes.terrain",
             "benchmark.reference.scenes.soup")


def _loaded(modules, extra=""):
    """Top-level names of the modules a fresh process holds after
    importing `modules` (and running `extra`)."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in modules) + extra
            + "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
    top = _loaded(HARNESS + REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "clpathtracer_tpu"}, top


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, the port and its kernels' plain
    versions included."""
    run = (
        "import time, torch\n"
        "from benchmark.harness import manifest, run_cell\n"
        "c = manifest.load_cell('terrain-1m.path-nee-720p')\n"
        "c.config['scene']['num_tris'] = 800\n"
        "c.traffic.update(width=32, height=16, warmup_frames=1)\n"
        "c.limits.update(frames=1, pixels=16)\n"
        "run_cell.run(c, 5, 0.1, False, torch.device('cpu'), time.time())\n")
    top = _loaded((), run)
    assert "clpathtracer_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "clpathtracer_tpu"}, top


def test_reference_loads_nothing_of_the_port():
    top = _loaded(REFERENCE)
    assert not top & {"clpathtracer_tpu_torch", "clpathtracer_tpu", "jax"}
