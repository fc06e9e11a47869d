#!/usr/bin/env python3
"""Serve `chip_smoke.py`'s class A through `launch.serve_cpd.CpdService`
twice, on a cold plan store and then on the warm one, on one CUDA card.

    python3 tools/torch_serve_class_a.py [--root DIR] [--label NAME]

Builds the port's kernels of ``--root`` (default: this checkout), makes
the 64 network-traffic tenants of class A (``uniform_tensor`` count data,
dims drawn from (2,049–4,096, 2,049–4,096, 32,769–65,536) and nnz from
131,073–262,144 with seed 101, as `chip_smoke.BUCKET_CLASSES`), and serves
them at rank 16 as `chip_smoke.py`'s service phase does: capacity 16, 5
CP-ALS sweeps, ``tune="auto"``, four submitter threads. The first service
tunes the class plan on a cold store under ``DIR/build``; the second
reads it from that store. For each it reports the wall time, tenants/s,
the latency p50 and p99, the tuner's timing runs (`ops.timing_runs`) and
the seconds spent choosing the class plan (`plan.make_class_plan`, timed
around the service's call), and the plan. One untimed warm-up request on
another store first loads the kernels and the CUDA context. Uses only
entry points every version of the port since the service has, so one
script measures a parent commit and its change alike: run ``--root``
parent, change, change, parent in one call. Prints the card and one JSON
line. Without CUDA it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

R = 16
CAPACITY = 16
THREADS = 4
TIMEOUT_S = 600.0
SPEC = dict(tenants=64, dims=((2049, 4096), (2049, 4096), (32769, 65536)),
            nnz=(131073, 262144), seed=101)


def tenants(synthetic) -> list:
    rng = np.random.default_rng(SPEC["seed"])
    xs = []
    for i in range(SPEC["tenants"]):
        dims = tuple(int(rng.integers(lo, hi + 1)) for lo, hi in SPEC["dims"])
        nnz = int(rng.integers(SPEC["nnz"][0], SPEC["nnz"][1] + 1))
        xs.append(synthetic.uniform_tensor(dims, nnz,
                                           seed=SPEC["seed"] * 1000 + i,
                                           count_data=True))
    return xs


def serve(svc, xs) -> float:
    """``xs`` from `THREADS` submitter threads with the worker running;
    returns the wall seconds. Every response must be ok."""
    out, errors = {}, []
    lock = threading.Lock()

    def client(k):
        try:
            mine = [(i, svc.submit(xs[i], seed=i))
                    for i in range(k, len(xs), THREADS)]
            for i, rid in mine:
                r = svc.wait(rid, timeout=TIMEOUT_S)
                with lock:
                    out[i] = r
        except Exception as exc:  # noqa: BLE001 — raised below
            with lock:
                errors.append(exc)

    svc.serve(poll_s=0.002)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(TIMEOUT_S)
    wall = time.perf_counter() - t0
    svc.shutdown(timeout=TIMEOUT_S)
    if errors:
        raise errors[0]
    bad = {i: r.error for i, r in out.items() if not r.ok}
    if len(out) != len(xs) or bad:
        raise RuntimeError(f"{len(out)} of {len(xs)} responses, errors {bad}")
    return wall


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path.cwd()),
                    help="checkout whose src/ is measured")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_class_a: CUDA is not available", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import autotune
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve_cpd
    from repro_torch.sparse import synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per_source = _build.build_all()
    build_s = time.perf_counter() - t0
    xs = tenants(synthetic)

    plan_s = []
    make_class_plan = plan_mod.make_class_plan

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return make_class_plan(*a, **kw)
        finally:
            plan_s.append(time.perf_counter() - t)
    plan_mod.make_class_plan = timed

    store_dir = root / "build" / "serve_class_a"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    env = autotune.PLAN_CACHE_ENV
    out = {"card": card, "root": str(root), "label": args.label,
           "build_s": build_s, "build_per_source_s": per_source}
    try:
        os.environ[env] = str(store_dir / "warmup.json")
        warm = serve_cpd.CpdService(R, "cp_als", capacity=1, n_iters=1,
                                    tol=0.0, tune="off", max_wait_s=0.0)
        serve(warm, xs[:1])
        os.environ[env] = str(store_dir / "plans.json")
        for run in ("cold", "warm"):
            del plan_s[:]
            svc = serve_cpd.CpdService(R, "cp_als", capacity=CAPACITY,
                                       n_iters=5, tol=0.0, guard=True,
                                       tune="auto", max_wait_s=0.05)
            r0 = ops.timing_runs()
            wall = serve(svc, xs)
            s = svc.stats()
            p = next(iter(svc._plans.values()))
            out[run] = {
                "wall_s": wall, "wall_tenants_per_s": len(xs) / wall,
                **{k: s[k] for k in ("buckets_run", "tenants_per_s",
                                     "latency_p50_s", "latency_p99_s")},
                "timing_runs": ops.timing_runs() - r0,
                "class_plan_s": sum(plan_s),
                "plan": [(mp.traversal.value, mp.r_block, mp.block_m)
                         for mp in p.modes]}
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
