#!/usr/bin/env python3
"""Readings that a cell's limits are set from, at the cell's own size.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--out readings.jsonl]

For each seed, in one process: the cell's tensor and the port's state as a
run builds them, one solve through the port as the window runs it (the
window's first start), and the plain reference in float64 from the same
start; the numbers the cell compares are the program's readings (the
lower ends of the limits). For each control seed, the reference computed
in the nearest precision below the configuration's (the solve loop's
``CONTROL``: TF32 matrix products for CP-ALS, bfloat16 for CP-APR) is
compared with the float64 reference by the same numbers (the upper
ends). One JSON line per reading, on standard output and in ``--out``.
Needs the card unless ``--device cpu``.

The benchmark's runs do not run this; `test_bench_control.py` runs it at
a small size on the CPU and, marked ``card``, at the cell's size.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

if __name__ == "__main__":
    _here = pathlib.Path(__file__).resolve().parent
    sys.path = [p for p in sys.path
                if pathlib.Path(p or ".").resolve() != _here]
    sys.path[:0] = [str(_here.parent / "src"), str(_here.parent)]

import torch  # noqa: E402

from bench import harness  # noqa: E402


def worst_entries(got, ref, top: int = 3) -> list:
    """The look behind a factor gap: per mode, the ``top`` entries where
    the two sides differ most, ``[row, column, got, ref]``, the count of
    entries that differ by more than 1e-3 of the mode's largest reference
    entry, and the mode's relative Frobenius gap."""
    out = []
    for g, r in zip(got, ref):
        g, r = g.double().to(r.device), r.double()
        d = (g - r).abs()
        _, idx = torch.topk(d.reshape(-1), top)
        cols = r.shape[1]
        out.append({"entries": [[int(i) // cols, int(i) % cols,
                                 float(g.reshape(-1)[i]),
                                 float(r.reshape(-1)[i])] for i in idx],
                    "over_1e-3": int((d > 1e-3 * r.abs().max()).sum()),
                    "frobenius": float(torch.linalg.norm(g - r)
                                       / torch.linalg.norm(r))})
    return out


def readings(cell: harness.Cell, seeds, control_seeds, device):
    """Yield one dict per reading: ``{"seed", "side", numbers...}``."""
    from repro_torch.core import views as views_mod

    dev = torch.device(device)
    solver, traffic = cell.solver, cell.traffic
    rank = int(cell.config["rank"])
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        coo, _, port, _ = harness._setup(cell, seed, dev)
        init = solver.initial(coo, rank, seed, 0)
        if seed in seeds:
            ans = solver.answer(solver.solve(port, traffic, init))
        del port
        views_mod.cache_clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = solver.reference(coo, traffic, init, "float64")
        if seed in seeds:
            yield {"seed": seed, "side": "program",
                   **solver.compare(coo, ans, ref),
                   "seconds": time.perf_counter() - t,
                   "look": worst_entries(ans.factors, ref.factors)}
            del ans
        if seed in control_seeds:
            ctl = solver.reference(coo, traffic, init, solver.CONTROL)
            yield {"seed": seed, "side": "control:" + solver.CONTROL,
                   **solver.compare(coo, ctl, ref),
                   "seconds": time.perf_counter() - t,
                   "look": worst_entries(ctl.factors, ref.factors)}
            del ctl
        del coo, ref, init
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for r in readings(cell, args.seeds, args.control_seeds, args.device):
        line = json.dumps({"workload": cell.name, **r})
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
