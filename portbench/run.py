#!/usr/bin/env python3
"""Run one benchmark cell once, on the CUDA card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number compared beside its limit.
Exits non-zero, printing no result, without a card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process with few threads: no OpenMP or BLAS pool beside the
# program's own threads (its zstd pool), set before torch and numpy load
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

from portbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T_START))
