#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output (`bench.harness`). Exits
non-zero, printing no result, when the cell's CUDA devices are missing,
when the port (``src/repro_torch``) is not beside this directory, or when
JAX or the JAX package was loaded.

The process keeps to one CPU core, the last it may use: the cells'
host-paced loops spread 5–13 % from run to run across cores and 4–5 % on
one (Chicago CP-ALS, six runs a set, H100 host).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if hasattr(os, "sched_setaffinity"):
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# This directory's modules are imported as ``bench.*`` only.
sys.path = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
