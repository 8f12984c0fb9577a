#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card and the ``channeld_tpu_torch`` package beside this folder;
exits non-zero and prints no result without either.
"""

import sys
import time

_T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.core import harness

    sys.exit(harness.main(sys.argv[1:], t_start=_T0))
