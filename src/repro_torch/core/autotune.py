"""Measured plan autotuner with a persistent on-disk plan store.

The static plan (`core.plan.static_mode_plan`) picks traversals and tiles
from a model of the kernels; this module replaces the model's answer by
measurement over the same space:

* **candidate space** — `core.plan.candidate_mode_plans`: per mode, the
  traversals × ``r_block`` × ``block_m`` the oriented kernels take at run
  time, and ``r_block`` × CTA size for the recursive kernels whose whole
  Temp fits one shared-memory window. The static choice is candidate 0,
  so the measured winner is never slower than the static plan under the
  measurement.
* **capped lists** — a mode's list is deduped (`dedupe`), then capped
  at `DEFAULT_MAX_CANDIDATES` by `plan.cap_candidates`: the static gene,
  then the traversal families in turn, so every family is timed.
* **timing protocol** — each candidate is a full `ExecutionPlan` (the
  static plan with that one mode swapped) timed through
  `plan.execute_mttkrp` / `plan.execute_phi` by `kernels.ops.
  timing_stats` on the tensor's device (median and IQR of `ITERS` runs
  after `WARMUP`): CUDA events on the card, the host clock on the CPU,
  where a ``"cuda"`` backend runs the kernels' plain versions and the
  ranking is a proxy only. The kernels are prebuilt, so the warm-up run
  absorbs only allocator warm-up.
* **the winner** — the fastest candidate replaces the static gene only
  when it `beats` it: by more than `MIN_GAIN` of the static median and
  by more than either IQR. A pick inside the noise would be stored and
  handed to every later process as if it had been measured faster.
* **plan store** — winners persist in a versioned JSON file of the port's
  own (``$REPRO_TORCH_PLAN_CACHE`` or ``~/.cache/repro_torch/plans.json``),
  keyed on a sha256 of everything a measurement depends on: the meta
  fingerprint (the JAX package's string for the same tensor), rank,
  backend, device kind, torch and CUDA versions, dtype and shared-memory
  sizes, the Π-policy budget, the objective and, for streaming plans, the
  device byte budget. A store hit (``make_plan(..., tune="auto"|"force")``
  in any later process) costs zero timing runs (`ops.timing_runs`).
  Missing, corrupt, other-version or malformed stores and entries are a
  miss, never fatal, and a store is only ever replaced by a new write.
* **sharded plans** (`plan.make_plan(shards=)`) — the key also names the
  shard count, so a sharded plan of one rank never shares a record with a
  single-device plan (whose recursive modes a sharded plan cannot run;
  a sharded lookup reads a record with a recursive mode as a miss). Every
  rank of the group times the same candidates through the sharded
  executables (each timed call is collective); rank 0's winner is
  broadcast and only rank 0 writes the store, so every rank runs one
  plan. A store hit is rank 0's too.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults, heuristics
from repro_torch.core import plan as plan_mod
from repro_torch.core.alto import AltoMeta, AltoTensor
from repro_torch.device import resolve_device
from repro_torch.kernels import common, ops

PLAN_STORE_VERSION = 1
PLAN_CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"
DEFAULT_STORE = "~/.cache/repro_torch/plans.json"
OBJECTIVES = ("mttkrp", "phi")

WARMUP = 1
ITERS = 3
DEFAULT_MAX_CANDIDATES = 24
MIN_GAIN = 0.05      # the least relative gain that displaces the static gene
DTYPE_BYTES = 4      # the kernels take float32 only


# ---------------------------------------------------------------------------
# Store keys
# ---------------------------------------------------------------------------

def meta_fingerprint(meta: AltoMeta) -> str:
    """Canonical string of every `AltoMeta` field a plan decision reads
    (the JAX package's format, so one tensor has one fingerprint in
    both)."""
    enc = meta.enc
    return ";".join([
        "dims=" + ",".join(map(str, enc.dims)),
        "bitmode=" + ",".join(map(str, enc.bit_mode)),
        f"nnz={meta.nnz}",
        f"L={meta.n_partitions}",
        "temp=" + ",".join(map(str, meta.temp_rows)),
        "reuse=" + ",".join(repr(float(r)) for r in meta.fiber_reuse),
    ])


def device_kind(device=None) -> str:
    """What a measurement on ``device`` (default ``cuda``) ran on: the
    card's name, or ``cpu``."""
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def plan_key(meta: AltoMeta, rank: int, backend: str, *, device=None,
             objective: str = "mttkrp",
             device_bytes: int | None = None,
             shards: int | None = None) -> str:
    """Stable store key: sha256 over everything a measurement depends on,
    `plan.SMEM_BYTES` and the Π-policy budget `heuristics.
    DEFAULT_FAST_MEM_BYTES` included. ``device_bytes`` is the budget a
    streaming plan was sized against (None for in-core plans, which never
    share a record with it); ``shards`` a sharded plan's shard count (None
    for a single-device plan, whose key it leaves as it was)."""
    fields = [] if shards is None else [f"shards={shards}"]
    blob = "|".join([
        f"store_v{PLAN_STORE_VERSION}",
        meta_fingerprint(meta),
        f"rank={rank}",
        f"backend={backend}",
        f"device={device_kind(device)}",
        f"torch={torch.__version__}",
        f"cuda={torch.version.cuda}",
        f"dtype_bytes={DTYPE_BYTES}",
        f"smem={plan_mod.SMEM_BYTES}",
        f"fast_mem={heuristics.DEFAULT_FAST_MEM_BYTES}",
        f"objective={objective}",
        f"dev={device_bytes}",
        *fields,
    ])
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def class_plan_key(sc, backend: str, **kwargs) -> str:
    """The store key of a shape class (`core.shapeclass.ShapeClass`):
    `plan_key` over its canonical meta, a function of the class alone, so
    every tenant it admits finds the one entry: a second tenant of a tuned
    class costs zero timing runs."""
    from repro_torch.core import shapeclass
    return plan_key(shapeclass.canonical_meta(sc), sc.rank, backend,
                    **kwargs)


# ---------------------------------------------------------------------------
# The on-disk store
# ---------------------------------------------------------------------------

def store_path(override=None) -> pathlib.Path:
    """The store file: ``override`` > ``$REPRO_TORCH_PLAN_CACHE`` >
    `DEFAULT_STORE`."""
    if override is not None:
        return pathlib.Path(override).expanduser()
    env = os.environ.get(PLAN_CACHE_ENV)
    return pathlib.Path(env or DEFAULT_STORE).expanduser()


def load_store(path=None) -> dict:
    """The store's ``plans`` mapping; a missing, unreadable, corrupt or
    other-version file loads as empty (and is left as it is); so does a
    read the ``autotune.store`` fault site corrupts."""
    try:
        faults.inject("autotune.store")
        raw = json.loads(store_path(path).read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("version") != PLAN_STORE_VERSION:
        return {}
    plans = raw.get("plans")
    return plans if isinstance(plans, dict) else {}


def save_store(plans: dict, path=None) -> pathlib.Path:
    """Write the store atomically: a temporary file in the same directory,
    then a rename, so a crash leaves the old file or the new one."""
    target = store_path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    payload = {"version": PLAN_STORE_VERSION, "torch": torch.__version__,
               "plans": plans}
    fd, tmp = tempfile.mkstemp(dir=str(target.parent),
                               prefix=target.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return target


def evict(key: str, path=None) -> bool:
    """Drop one stored plan; True iff it was there."""
    plans = load_store(path)
    if key not in plans:
        return False
    del plans[key]
    save_store(plans, path)
    return True


def serialize_plan(plan: plan_mod.ExecutionPlan) -> dict:
    """JSON record of a plan. The meta is not stored (the key pins it);
    dims and nnz ride along for the search's neighbour ranking."""
    return {
        "rank": plan.rank,
        "backend": plan.backend,
        "pi_policy": plan.pi_policy.value,
        "modes": [{
            "mode": m.mode,
            "traversal": m.traversal.value,
            "r_block": m.r_block,
            "block_m": m.block_m,
            "temp_rows": m.temp_rows,
            "threads": m.threads,
        } for m in plan.modes],
        "streaming": None if plan.streaming is None else {
            "chunk_m": plan.streaming.chunk_m,
            "n_chunks": plan.streaming.n_chunks,
            "device_bytes": plan.streaming.device_bytes,
            "stream_bytes": plan.streaming.stream_bytes,
        },
        "dims": list(plan.meta.dims),
        "nnz": plan.meta.nnz,
        "shards": plan.shards,
    }


def deserialize_plan(record: dict, meta: AltoMeta,
                     shards: int | None = None) -> plan_mod.ExecutionPlan:
    """An `ExecutionPlan` from a store record and the caller's meta, for
    ``shards`` (None: one device). Raises KeyError / ValueError /
    TypeError on a malformed record, on one made for another shard count,
    and, for a sharded plan, on one with a mode that is not oriented."""
    if record.get("shards") != shards:
        raise ValueError(f"record for shards={record.get('shards')}, "
                         f"wanted shards={shards}")
    modes = tuple(plan_mod.ModePlan(
        mode=int(m["mode"]),
        traversal=heuristics.Traversal(m["traversal"]),
        r_block=int(m["r_block"]),
        block_m=int(m["block_m"]),
        temp_rows=int(m["temp_rows"]),
        threads=int(m["threads"]),
    ) for m in record["modes"])
    if [m.mode for m in modes] != list(range(meta.enc.ndim)):
        raise ValueError("record modes do not match meta")
    rank = int(record["rank"])
    for m in modes:
        if (m.r_block <= 0 or rank % m.r_block
                or m.r_block > plan_mod.MAX_R_BLOCK):
            raise ValueError(f"stored r_block {m.r_block} is not a rank "
                             f"tile of rank {rank}")
        if not (plan_mod.MIN_BLOCK_M <= m.block_m <= plan_mod.MAX_BLOCK_M
                and m.block_m & (m.block_m - 1) == 0):
            raise ValueError(f"stored block_m {m.block_m}")
        # The CTA sizes of the candidate space: the oriented kernels' rule,
        # or one of the recursive kernels' tuned sizes.
        sizes = {plan_mod.cta_threads(m.r_block)}
        if m.traversal is heuristics.Traversal.RECURSIVE:
            sizes |= set(plan_mod.RECURSIVE_THREADS)
        if m.threads not in sizes:
            raise ValueError(f"stored threads {m.threads} for r_block "
                             f"{m.r_block} ({m.traversal.value})")
        if shards is not None and not heuristics.is_oriented(m.traversal):
            raise ValueError(f"stored {m.traversal.value} mode {m.mode} in "
                             f"a sharded plan")
    backend = str(record["backend"])
    if backend not in plan_mod.BACKENDS:
        raise ValueError(f"stored backend {backend!r}")
    streaming = None
    s = record.get("streaming")
    if s is not None:
        chunk_m = int(s["chunk_m"])
        align = max(m.block_m for m in modes)
        if chunk_m <= 0 or chunk_m % align:
            raise ValueError(f"stored chunk_m {chunk_m} is not a multiple "
                             f"of the plan's largest block_m {align}")
        # n_chunks follows from (meta, chunk_m): recomputed, not trusted.
        streaming = plan_mod.StreamPlan(
            chunk_m=chunk_m, n_chunks=plan_mod.chunk_count(meta, chunk_m),
            device_bytes=int(s["device_bytes"]),
            stream_bytes=int(s["stream_bytes"]))
    return plan_mod.ExecutionPlan(
        meta=meta, rank=rank, backend=backend, modes=modes,
        pi_policy=heuristics.PiPolicy(record["pi_policy"]),
        streaming=streaming, shards=shards)


def lookup(meta: AltoMeta, rank: int, *, backend: str, device=None,
           objective: str = "mttkrp", device_bytes: int | None = None,
           path=None,
           shards: int | None = None) -> plan_mod.ExecutionPlan | None:
    """The stored measured plan for this configuration, or None; zero
    timing runs either way. ``device_bytes`` selects a streaming record
    (None: the in-core one), ``shards`` a sharded one."""
    key = plan_key(meta, rank, backend, device=device, objective=objective,
                   device_bytes=device_bytes, shards=shards)
    record = load_store(path).get(key)
    if record is None:
        return None
    try:
        return deserialize_plan(record, meta, shards)
    except (KeyError, ValueError, TypeError, AttributeError):
        return None       # a malformed entry is a miss; tuning overwrites it


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def beats(median_s: float, iqr_s: float, ref_median_s: float,
          ref_iqr_s: float) -> bool:
    """True iff a measurement is faster than the reference one by more
    than `MIN_GAIN` of the reference and by more than either IQR."""
    return ref_median_s - median_s > max(MIN_GAIN * ref_median_s, iqr_s,
                                         ref_iqr_s)


@dataclasses.dataclass(frozen=True)
class CandidateTiming:
    """One measured candidate of one mode."""
    mode: int
    traversal: str
    r_block: int
    block_m: int
    threads: int
    median_s: float
    iqr_s: float
    is_static: bool      # the static plan's choice


@dataclasses.dataclass(frozen=True)
class ModeReport:
    mode: int
    candidates: tuple[CandidateTiming, ...]
    seconds: float       # host seconds the mode's timing took

    @property
    def fastest(self) -> CandidateTiming:
        return min(self.candidates, key=lambda c: c.median_s)

    @property
    def static(self) -> CandidateTiming:
        return next(c for c in self.candidates if c.is_static)

    @property
    def best(self) -> CandidateTiming:
        """The winner: the fastest candidate where it `beats` the static
        one, else the static one."""
        f, s = self.fastest, self.static
        return f if beats(f.median_s, f.iqr_s, s.median_s, s.iqr_s) else s


@dataclasses.dataclass(frozen=True)
class TuneReport:
    """Per-mode candidate timings and where the winner was stored."""
    modes: tuple[ModeReport, ...]
    key: str
    store: str          # the path written ("" if not persisted)
    objective: str


def seeded_factors(meta: AltoMeta, rank: int, seed: int, device):
    """The tuner's factors: standard normal from ``np.random.
    default_rng(seed)``, float32, on ``device``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((I, rank))
                             .astype(np.float32)).to(device)
            for I in meta.dims]


def _time_mttkrp(cand_plan, at, views, factors, mode, group=None):
    """(median, IQR) seconds of one MTTKRP under ``cand_plan`` (over the
    ranks of ``group`` for a sharded plan)."""
    return ops.timing_stats(
        lambda: plan_mod.execute_mttkrp(cand_plan, at, views, factors, mode,
                                        group=group),
        warmup=WARMUP, iters=ITERS, device=at.device)


def _time_phi(cand_plan, at, view, B, factors, pi, mode, eps=1e-10,
              group=None):
    """(median, IQR) seconds of one Φ under ``cand_plan``: with ``pi``
    (ALTO-PRE in core) or the factors (ALTO-OTF, and every streaming
    plan, which builds its chunks' Π itself)."""
    operands = (dict(factors=factors) if pi is None or cand_plan.streaming
                else dict(pi=pi))
    return ops.timing_stats(
        lambda: plan_mod.execute_phi(cand_plan, at, view, B, mode, eps=eps,
                                     group=group, **operands),
        warmup=WARMUP, iters=ITERS, device=at.device)


def _from_rank0(obj, group):
    """``obj`` as rank 0 of ``group`` holds it, on every rank."""
    box = [obj]
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def dedupe(cands, backend: str, objective: str, streaming: bool = False):
    """Drop candidates that run the same work as an earlier one: the
    reference backend has no tiles (one per traversal family, one in all
    when streaming); the Φ kernels run the whole rank (``r_block`` is
    dead), so they differ in (traversal, ``block_m``, CTA size)."""
    if backend == "reference":
        def key(c):
            if streaming:
                return ()
            return ("oriented" if heuristics.is_oriented(c.traversal)
                    else c.traversal,)
    elif objective == "phi":
        def key(c):
            return (c.traversal, c.block_m, common.cta_threads(c.threads))
    else:
        return tuple(cands)
    seen, out = set(), []
    for c in cands:
        k = key(c)
        if k not in seen:
            seen.add(k)
            out.append(c)
    return tuple(out)


def tune_plan(at: AltoTensor, rank: int, *, backend: str | None = None,
              objective: str = "mttkrp", max_candidates: int | None = None,
              persist: bool = True, store_path=None,
              shards: int | None = None,
              group=None) -> tuple[plan_mod.ExecutionPlan, TuneReport]:
    """Time every candidate of every mode and return the winning plan.

    ``objective`` picks what is timed: ``"mttkrp"`` (CP-ALS) or ``"phi"``
    (CP-APR). Each mode's list is deduped (`dedupe`), then capped at
    ``max_candidates`` (default `DEFAULT_MAX_CANDIDATES`) by `plan.
    cap_candidates`. Factors are seeded (seed 0), so the timings depend
    only on what the store key fingerprints. Returns ``(plan, report)``;
    each mode's winner is its report's `ModeReport.best`: the static
    candidate unless another `beats` it.

    ``shards`` tunes a sharded plan on the ranks of ``group`` (every rank
    calls it with the same tensor): the candidates are the sharded plan's
    (`plan.candidate_mode_plans`), each timed through its collective
    executable, rank 0's winner of each mode is every rank's, and only
    rank 0 writes the store."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if max_candidates is None:
        max_candidates = DEFAULT_MAX_CANDIDATES   # read late: patchable
    from repro_torch.core import search as search_mod
    from repro_torch.core import views as views_mod
    meta = at.meta
    backend = backend or plan_mod.default_backend(at.device)
    pi_policy = heuristics.choose_pi_policy(meta, rank)
    pre_pi = pi_policy is heuristics.PiPolicy.PRE
    factors = seeded_factors(meta, rank, 0, at.device)
    base = tuple(plan_mod.static_mode_plan(meta, n, rank, shards=shards)
                 for n in range(meta.enc.ndim))

    collective = {} if shards is None else {"group": group}
    winners, reports = [], []
    for n in range(meta.enc.ndim):
        t_mode = time.perf_counter()
        cands = plan_mod.candidate_mode_plans(meta, n, rank,
                                              objective=objective,
                                              shards=shards)
        cands = plan_mod.cap_candidates(dedupe(cands, backend, objective),
                                        max_candidates)
        oriented = any(heuristics.is_oriented(c.traversal) for c in cands)
        view = views_mod.get_view(at, n) if oriented else None
        views = {n: view} if view is not None else {}
        if objective == "phi":
            B = factors[n].abs() + 0.1
            pi_alto = pi_view = None
            if pre_pi:       # Π in the order each traversal consumes
                pi_alto = ops.pi_rows(at.meta.enc, at.words, factors, n)
                if view is not None:
                    pi_view = ops.pi_rows(at.meta.enc, view.words, factors,
                                          n)
        timings = []
        for i, mp in enumerate(cands):
            modes = list(base)
            modes[n] = mp
            cand = plan_mod.ExecutionPlan(meta=meta, rank=rank,
                                          backend=backend,
                                          modes=tuple(modes),
                                          pi_policy=pi_policy, shards=shards)
            if objective == "phi":
                pi = ((pi_view if heuristics.is_oriented(mp.traversal)
                       else pi_alto) if pre_pi else None)
                t, iqr = _time_phi(cand, at, view, B, factors, pi, n,
                                   **collective)
            else:
                t, iqr = _time_mttkrp(cand, at, views, factors, n,
                                      **collective)
            timings.append(CandidateTiming(
                mode=n, traversal=mp.traversal.value, r_block=mp.r_block,
                block_m=mp.block_m, threads=mp.threads, median_s=float(t),
                iqr_s=float(iqr), is_static=i == 0))
        report = ModeReport(mode=n, candidates=tuple(timings),
                            seconds=time.perf_counter() - t_mode)
        best = timings.index(report.best)
        if shards is not None:
            # Each rank timed its own run; one plan must hold on all.
            best = _from_rank0(best, group)
        winners.append(cands[best])
        reports.append(report)

    plan = plan_mod.ExecutionPlan(meta=meta, rank=rank, backend=backend,
                                  modes=tuple(winners), pi_policy=pi_policy,
                                  shards=shards)
    key = plan_key(meta, rank, backend, device=at.device,
                   objective=objective, shards=shards)
    stored = ""
    if persist and (shards is None or dist.get_rank(group) == 0):
        record = serialize_plan(plan)
        record["tuned"] = {
            "mode": "exhaustive", "device": device_kind(at.device),
            "objective": objective, "warmup": WARMUP, "iters": ITERS,
            "modes": [{"mode": r.mode, "best_us": r.best.median_s * 1e6,
                       "static_us": r.static.median_s * 1e6,
                       "n_candidates": len(r.candidates),
                       "seconds": round(r.seconds, 6)}
                      for r in reports]}
        # Every measurement is a training sample of the search's cost
        # model (`core.search`).
        record["samples"] = [
            {"f": [round(f, 6) for f in search_mod.gene_features(
                meta, rank, r.mode, heuristics.Traversal(c.traversal),
                c.r_block, c.block_m, c.threads, objective=objective)],
             "s": c.median_s}
            for r in reports for c in r.candidates
        ][:search_mod.MAX_RECORD_SAMPLES]
        plans = load_store(store_path)
        plans[key] = record
        stored = str(save_store(plans, store_path))
    return plan, TuneReport(modes=tuple(reports), key=key, store=stored,
                            objective=objective)


# ---------------------------------------------------------------------------
# make_plan's entry point
# ---------------------------------------------------------------------------

def tuned_plan(meta: AltoMeta, rank: int, *, backend: str, device,
               at: AltoTensor | None, require: bool,
               objective: str = "mttkrp", search: bool = False,
               device_bytes: int | None = None,
               search_budget_runs: int | None = None,
               search_budget_s: float | None = None, search_seed: int = 0,
               store_path=None, shards: int | None = None,
               group=None) -> plan_mod.ExecutionPlan | None:
    """A store hit, else a measurement on ``at``; None tells `make_plan`
    to fall back to the static plan (no data, ``require`` False).

    ``search`` routes the measurement through the budgeted search
    (`core.search`) instead of the exhaustive tuner. ``device_bytes``
    marks a streaming plan: those always go through the search
    (``chunk_m`` is one of its genes) and are stored under a key of that
    budget.

    ``shards`` (a sharded plan) looks up and tunes on the ranks of
    ``group``, rank 0's store hit or winner holding on every rank, and
    always through the exhaustive tuner, whose timing is collective."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    hit = lookup(meta, rank, backend=backend, device=device,
                 objective=objective, device_bytes=device_bytes,
                 path=store_path, shards=shards)
    if shards is not None:
        record = _from_rank0(None if hit is None else serialize_plan(hit),
                             group)
        hit = None if record is None else deserialize_plan(record, meta,
                                                           shards)
    if hit is not None:
        return hit
    if at is not None:
        if at.meta != meta:
            raise ValueError("tune: at.meta does not match the meta the "
                             "plan is being built for")
        if (search or device_bytes is not None) and shards is None:
            from repro_torch.core import search as search_mod
            plan, _ = search_mod.search_plan(
                at, rank, backend=backend, objective=objective,
                device_bytes=device_bytes, budget_runs=search_budget_runs,
                budget_s=search_budget_s, seed=search_seed,
                store_path=store_path)
            return plan
        plan, _ = tune_plan(at, rank, backend=backend, objective=objective,
                            store_path=store_path, shards=shards,
                            group=group)
        return plan
    if require:
        raise ValueError(
            "tune='force': no stored measured plan for this tensor and no "
            "tensor to measure: pass at= (or use plan_for / the drivers' "
            "tune=), or fill the plan store "
            f"({store_path or os.environ.get(PLAN_CACHE_ENV) or DEFAULT_STORE})")
    return None
