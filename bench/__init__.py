"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

One command, ``python bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``, runs one cell on the card and prints one JSON line.
Everything that belongs to one configuration, cell, traffic mix or
per-layer metric is a file of its own that the harness finds by name:

* ``configs/<config>.json``: a deployment's published shape;
* ``workloads/<cell>.json``: the cell's configuration, traffic, chips,
  why, and the limits of its correctness check;
* ``traffic/<traffic>.json``: the solve parameters one solve loop reads;
* ``solvers/<algorithm>.py``: one solve loop per algorithm;
* ``metrics/<metric>.py``: one reader per per-layer metric.

The yardstick lives here too and imports nothing of the port: the frozen
generators (`generators`), the roofline count (`roofline`), the trace
reduction (`tracing`) and the plain reference with its comparison
(`reference`).
"""
