#!/usr/bin/env python3
"""The host syncs of whole solves at a benchmark cell's size, by call site.

    python3 tools/torch_sync_audit.py [--cells <cell> ...] [--seed <n>]

For each cell (default: all four of ``bench/workloads/``) it makes the
cell's tensor, plan and views and one warm-up solve as the benchmark does
(`bench.harness`), then one solve under
``torch.cuda.set_sync_debug_mode("warn")``. Each synchronising CUDA call
that torch reports is put down to its innermost frame in the port
(``src/repro_torch/``) and to the innermost library frame below it, and
counted. Prints a table per cell, with each site's count a (outer)
iteration, and writes it to ``chiprun_out/sync_audit.json``. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness  # noqa: E402

PORT = str(ROOT / "src" / "repro_torch")
CELLS = ["darpa1998.cp_als", "chicago-crime-comm.cp_apr",
         "darpa1998.cp_apr", "chicago-crime-comm.cp_als"]


def _site(stack) -> str:
    """The innermost port frame and the frame it called, as text."""
    for i in range(len(stack) - 1, -1, -1):
        f = stack[i]
        if f.filename.startswith(PORT):
            where = (f"{pathlib.Path(f.filename).relative_to(ROOT)}:"
                     f"{f.lineno} {f.name}: {f.line}")
            if i + 1 < len(stack):
                callee = stack[i + 1]
                where += f"  [-> {callee.name} in " \
                         f"{pathlib.Path(callee.filename).name}]"
            return where
    f = stack[-1]
    return f"(outside the port) {f.filename}:{f.lineno} {f.name}: {f.line}"


def audit(name: str, seed: int, dev: torch.device) -> dict:
    cell = harness.load_cell(name)
    solver = cell.solver
    coo, _, port, _ = harness._setup(cell, seed, dev)
    solver.solve(port, cell.traffic, solver.initial(coo, port.rank, seed, -1))
    torch.cuda.synchronize(dev)
    init = solver.initial(coo, port.rank, seed, 0)
    torch.cuda.synchronize(dev)
    sites = collections.Counter()
    solving = False

    def record(message, category, filename, lineno, file=None, line=None):
        # Switching the mode itself reports a sync: only the solve counts.
        if solving and "synchronizing" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            sites[_site(stack)] += 1

    with warnings.catch_warnings():
        warnings.showwarning = record
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solving = True
            result = solver.solve(port, cell.traffic, init)
        finally:
            solving = False
            torch.cuda.set_sync_debug_mode("default")
    iters = solver.iterations(result)
    return {"iterations": iters,
            "sites": [{"site": s, "count": n, "per_iteration": n / iters}
                      for s, n in sites.most_common()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=CELLS)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sync_audit: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(dev),
           "torch": torch.__version__, "cells": {}}
    for name in args.cells:
        res = audit(name, args.seed, dev)
        out["cells"][name] = res
        print(f"{name}: {res['iterations']} iterations")
        for s in res["sites"]:
            print(f"  {s['count']:6d}  {s['per_iteration']:8.3f}/it  "
                  f"{s['site']}")
    dest = ROOT / "chiprun_out" / "sync_audit.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
