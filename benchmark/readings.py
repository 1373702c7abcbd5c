"""The readings that a cell's limits are set from (not run by run.py):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 3] [--control-seeds 1,2,3]

For each seed, in one process: the cell's set-up, a short window at its
own load and sizes, and the check, printing one JSON line with the
program's numbers (its lower readings); for each control seed also the
control's, the reference with its ray-triangle test in bfloat16 put in
the program's place (its upper readings), and how many of the program's
bad pixels a rounding's nudge of the reference's inputs reproduces."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    import torch

    from benchmark.harness import manifest, run_cell
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args()
    run_cell.cache_dirs(ROOT)
    if not torch.cuda.is_available():
        sys.exit("readings need a CUDA device")
    device = torch.device("cuda", 0)
    cell = manifest.load_cell(a.workload)
    controls = {int(s) for s in a.control_seeds.split(",") if s}
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.time()
        res, _ = run_cell.run(cell, seed, a.seconds, False, device, t0,
                              control=seed in controls)
        line = {"workload": a.workload, "seed": seed,
                "correct": res["correct"], "frames": res["attempted"],
                "bad_px": res["check"]["bad_px"]["value"],
                "seconds": time.time() - t0}
        for k in ("control_bad_px", "bad", "explained_bad"):
            if k in res:
                line[k] = res[k]
        print(json.dumps(line), flush=True)
