#!/usr/bin/env python3
"""Time one batched CP-ALS sweep of `chip_smoke.py`'s class A with mode 0
routed recursive, cold and warm, on one CUDA card.

    python3 tools/torch_bucket_recursive.py [--root DIR] [--label NAME]

Builds the port's kernels of ``--root`` (default: this checkout), makes
the 64 network-traffic tenants of class A (``uniform_tensor`` count data,
dims drawn from (2,049–4,096, 2,049–4,096, 32,769–65,536) and nnz from
131,073–262,144 with seed 101, as `chip_smoke.BUCKET_CLASSES`), pads and
canonicalizes them into the class (4096, 4096, 65536) at rank 16, and
times `batched.batched_cp_als` for one sweep at capacity 64 with the
host clock around synchronized calls: under the static class plan with
mode 0 routed recursive, first on a cold pull-order cache (the call that
sorts the 64 members' pull orders, as `chip_smoke.py`'s
``class_a_recursive`` does), then five more calls (median), then the
static all-carry plan (median of five). Uses only entry points every
version of the port with recursive buckets has, so one script times a
parent commit and its change alike: run ``--root`` parent, change,
change, parent in one call. Prints the card and one JSON line. Without
CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

R = 16
SPEC = dict(tenants=64, dims=((2049, 4096), (2049, 4096), (32769, 65536)),
            nnz=(131073, 262144), seed=101)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path.cwd()),
                    help="checkout whose src/ is timed")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bucket_recursive: CUDA is not available",
              file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import alto, batched, heuristics
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import shapeclass
    from repro_torch.kernels import _build
    from repro_torch.sparse import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    rng = np.random.default_rng(SPEC["seed"])
    xs = []
    for i in range(SPEC["tenants"]):
        dims = tuple(int(rng.integers(lo, hi + 1)) for lo, hi in SPEC["dims"])
        nnz = int(rng.integers(SPEC["nnz"][0], SPEC["nnz"][1] + 1))
        xs.append(synthetic.uniform_tensor(dims, nnz,
                                           seed=SPEC["seed"] * 1000 + i,
                                           count_data=True))
    sc = shapeclass.classify(xs[0], R)
    static = plan_mod.make_class_plan(sc, backend="cuda")
    forced = dataclasses.replace(static, modes=tuple(
        dataclasses.replace(mp, traversal=heuristics.Traversal.RECURSIVE)
        if mp.mode == 0 else mp for mp in static.modes))
    ats = [shapeclass.canonicalize_tensor(alto.build_device(
        shapeclass.pad_to_class(x, sc), n_partitions=sc.n_partitions,
        compute_reuse=False), sc) for x in xs]
    K = len(ats)
    dims = [x.dims for x in xs]

    def sweep(p, views) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batched.batched_cp_als(ats, views, dims, R, plan=p, n_iters=1,
                               tol=0.0, seeds=list(range(K)), capacity=K)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def median(p, views, n=5) -> list[float]:
        return sorted(sweep(p, views) for _ in range(n))

    views_f = [plan_mod.build_views(at, forced) for at in ats]
    views_s = [plan_mod.build_views(at, static) for at in ats]
    cold = sweep(forced, views_f)
    warm = median(forced, views_f)
    carry = median(static, views_s)
    out = {"card": card, "root": str(root), "label": args.label,
           "class": list(sc.dims), "tenants": K,
           "forced": [mp.traversal.value for mp in forced.modes],
           "static": [mp.traversal.value for mp in static.modes],
           "cold_sweep_ms": cold, "warm_sweep_ms": warm[len(warm) // 2],
           "warm_sweeps_ms": warm, "static_sweep_ms": carry[len(carry) // 2],
           "static_sweeps_ms": carry,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
