"""Run one cell of BENCHMARK.json once and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(from the root of a checkout; see harness/run_cell.py)."""

import time

T_START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from benchmark.harness import run_cell
    run_cell.cache_dirs(ROOT)
    sys.exit(run_cell.main(sys.argv[1:], T_START))
