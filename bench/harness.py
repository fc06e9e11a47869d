"""One run of one cell: set-up, the measured window, the check of its
answers against the plain reference, and the result line.

`run_cell` is the whole run without the look for a card; `main` is the
command line, which refuses to run without enough CUDA devices. A cell,
its configuration, its traffic, its solve loop and the per-layer metric
readers are found by name under the benchmark's root (`load_cell`,
`metric_readers`), so adding one adds files and edits none.

Set-up (`setup_s`, from process start): the tensor drawn on the device
from the seed, the port's ALTO build (`alto.build_device`), its static
plan and views (`plan.plan_for`, `plan.build_views`), and one whole solve
as warm-up, which loads or builds every kernel the window runs. The window
then runs whole solves back to back, starting a new one until
``seconds`` have passed; the rate is the window, from its start to the end
of its last solve, over every iteration completed in it. A traced run
(``trace``) wraps the solve loop's entries in spans for the solves that
start in its first `TRACE_SECONDS`, under `torch.profiler`, and reports
the per-layer metrics instead of the end-to-end ones.

The check: a sample of the window's solves, drawn from the seed, is solved
again by the plain reference in float64 from the same starting point once
the window has closed, the memory peak has been read and the port's state
is freed. Each number the solve loop compares is held under the cell's
limit of the same name.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import random
import sys
import tempfile
import time

import torch

from bench import generators
from bench import tracing as trace_mod

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 3.0


class RunError(RuntimeError):
    """The cell cannot be run as asked."""


def _load_json(root: pathlib.Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise RunError(f"no {kind} file named {name!r} ({path})")
    return json.loads(path.read_text())


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict        # workloads/<name>.json
    config: dict      # configs/<spec["config"]>.json
    traffic: dict     # traffic/<spec["traffic"]>.json
    solver: object    # solvers/<traffic["algorithm"]>.py


def load_cell(name: str, root: pathlib.Path = BENCH) -> Cell:
    spec = _load_json(root, "workloads", name)
    traffic = _load_json(root, "traffic", spec["traffic"])
    algo = traffic["algorithm"]
    path = root / "solvers" / f"{algo}.py"
    if not path.is_file():
        raise RunError(f"no solve loop for algorithm {algo!r} ({path})")
    return Cell(name=name, spec=spec,
                config=_load_json(root, "configs", spec["config"]),
                traffic=traffic,
                solver=_load_module(path, f"bench_solver_{algo}"))


def metric_readers(root: pathlib.Path = BENCH) -> dict:
    """{metric name: reader module} for every ``metrics/<name>.py`` whose
    name does not start with ``_``."""
    return {p.stem: _load_module(p, "bench_metric_" + p.stem.replace(".", "_"))
            for p in sorted((root / "metrics").glob("*.py"))
            if not p.stem.startswith("_")}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Port:
    """The port's state that every solve of the window shares."""
    at: object
    plan: object
    views: dict
    rank: int


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reader reads (`bench/metrics/`)."""
    metric: str                     # the cell's end-to-end rate metric
    setup: dict                     # set-up seconds by step
    trace: trace_mod.TraceSummary   # the traced window
    iterations: int                 # iterations completed in it
    bound_s: float                  # roofline seconds of one iteration


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Tracing:
    """The profiler, the spans and the window span of a traced run."""

    def __init__(self, dev: torch.device, entries: dict):
        self.dev = dev
        self.spans = trace_mod.Spans(entries)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window = torch.profiler.record_function(trace_mod.WINDOW)
        self.active = False
        self.iterations = 0

    def start(self) -> None:
        self.spans.install()
        self.prof.__enter__()
        _sync(self.dev)
        self.window.__enter__()
        self.active = True

    def stop(self) -> trace_mod.TraceSummary:
        _sync(self.dev)
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.uninstall()
        self.active = False
        self.spans.check_called()
        fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return trace_mod.reduce_chrome_trace(path,
                                                 list(self.spans.entries))
        finally:
            os.unlink(path)


def _setup(cell: Cell, seed: int, dev: torch.device):
    from repro_torch.core import alto
    from repro_torch.core import plan as plan_mod
    from repro_torch.sparse.tensor import SparseTensor

    cfg = cell.config
    rank = int(cfg["rank"])
    t = time.perf_counter()
    coo = generators.make_tensor(cfg, seed, dev)
    distinct = [int(torch.unique(coo.coords[:, m]).numel())
                for m in range(len(coo.dims))]
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    # The port's entry takes a host COO tensor.
    x = SparseTensor(coo.dims, coo.coords.to(torch.int32).cpu().numpy(),
                     coo.values.cpu().numpy())
    host_s = time.perf_counter() - t
    t = time.perf_counter()
    at = alto.build_device(x, n_partitions=int(cfg["n_partitions"]),
                           device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t
    del x
    t = time.perf_counter()
    plan = plan_mod.plan_for(at, rank)
    views = plan_mod.build_views(at, plan)
    _sync(dev)
    views_s = time.perf_counter() - t
    port = Port(at=at, plan=plan, views=views, rank=rank)
    return coo, distinct, port, {"draw_s": draw_s, "host_coo_s": host_s,
                                 "build_s": build_s, "views_s": views_s}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t0: float) -> dict:
    """One run of ``cell`` on ``device`` (no look for a card); ``t0`` is
    the process's start on the host clock. Returns the result line's
    object."""
    from repro_torch.core import views as views_mod

    dev = torch.device(device)
    solver, traffic = cell.solver, cell.traffic
    limits = dict(cell.spec["limits"])
    setup = {"start_s": time.perf_counter() - t0}
    coo, distinct, port, steps = _setup(cell, seed, dev)
    rank = port.rank
    setup.update(steps)
    t = time.perf_counter()
    solver.solve(port, traffic, solver.initial(coo, rank, seed, -1))
    _sync(dev)
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    keep = int(cell.spec["check_solves"])
    rng = random.Random(generators.stream_seed(seed, "check sample"))
    kept: list[tuple[int, object]] = []
    tracing = _Tracing(dev, solver.SPANS) if trace else None
    summary = None
    iters = solves = 0
    ends = []              # seconds into the window at each solve's end
    if tracing:
        tracing.start()
    _sync(dev)
    start = time.perf_counter()
    while solves == 0 or time.perf_counter() - start < seconds:
        init = solver.initial(coo, rank, seed, solves)
        span = (torch.profiler.record_function(trace_mod.SOLVE)
                if tracing and tracing.active else contextlib.nullcontext())
        with span:
            result = solver.solve(port, traffic, init)
        _sync(dev)
        ends.append(time.perf_counter() - start)
        n = solver.iterations(result)
        iters += n
        # A uniform sample of the window's solves (reservoir sampling).
        if len(kept) < keep:
            kept.append((solves, solver.answer(result)))
        else:
            j = rng.randrange(solves + 1)
            if j < keep:
                kept[j] = (solves, solver.answer(result))
        del result, init
        solves += 1
        if tracing and tracing.active:
            tracing.iterations += n
            if time.perf_counter() - start >= min(TRACE_SECONDS, seconds):
                summary = tracing.stop()
    window_s = ends[-1]
    if tracing and tracing.active:
        summary = tracing.stop()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # The port's state goes before the reference runs.
    del port
    views_mod.cache_clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    worst = {}
    failed = 0
    for index, ans in kept:
        ref = solver.reference(coo, traffic,
                               solver.initial(coo, rank, seed, index),
                               "float64")
        numbers = solver.compare(coo, ans, ref)
        missing = set(numbers) - set(limits)
        if missing:
            raise RunError(f"cell {cell.name} has no limit for "
                           f"{sorted(missing)}")
        if not all(numbers[k] <= limits[k] for k in numbers):
            failed += 1
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, -math.inf), v)

    if trace:
        reading = Reading(metric=solver.METRIC, setup=setup, trace=summary,
                          iterations=tracing.iterations,
                          bound_s=solver.bound_s(coo.dims, coo.nnz, distinct,
                                                 rank, traffic))
        metrics = {}
        for name, mod in metric_readers().items():
            value = mod.read(reading)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {solver.METRIC: {"value": window_s * 1e3 / iters,
                                   "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(kept) and failed == 0, "attempted": solves,
           "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["setup"] = setup
    out["window"] = {"seconds": window_s, "solves": solves,
                     "solve_ends_s": [round(e, 4) for e in ends],
                     "iterations": iters, "checked": [i for i, _ in kept]}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in worst.items()}
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(out: dict) -> int:
    """Print the checks as the last lines of standard error and the result
    as the last line of standard output; refuse (exit 1, no result) when a
    module of JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        print(f"bench: refusing to report: loaded {found}", file=sys.stderr)
        return 1
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    cell = load_cell(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: cell {cell.name} needs {chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    return report(out)
