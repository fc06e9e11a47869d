"""Budgeted plan search: a seeded genetic search over the tiling space with
a learned cost model, in place of timing every candidate.

The exhaustive tuner (`core.autotune.tune_plan`) times every candidate of
every mode; streaming plans add ``chunk_m`` to the space, so this module
spends a *measurement budget* (timing runs and/or seconds) instead:

* **genome** — per mode a gene is a pool member: ``(traversal, r_block,
  block_m, threads)`` from `plan.candidate_mode_plans` (feasible by
  construction: rank tiles, powers of two, the recursive kernels' Temp
  in one shared-memory window). Streaming pools pin the carry traversal
  (K8 / K9 are the carry scan) and add a genome-level ``chunk_m`` gene, a
  block-aligned halving ladder under the byte model's largest chunk
  (`chunk_ladder`). Crossover and mutation act on the raw fields; a
  **repair** step snaps the child to the nearest pool gene, so nothing
  infeasible is ever timed.
* **fitness** — the exhaustive tuner's protocol (`ops.timing_stats` on
  the tensor's device through `plan.execute_mttkrp` / `execute_phi`),
  memoized per (mode, gene, chunk). A plan's time is separable across
  modes, so one budget is shared by a GA per mode.
* **cost model** — ridge regression on log-seconds over analytic
  features of (tensor, gene), fit in closed form from the samples
  persisted in the plan store (exhaustive and search runs both add them)
  of the same device kind, so the model transfers across tensors: with a
  warm store, ``budget_runs=0`` returns a model-picked plan with no
  measurement. The model only chooses what to measure; the store stays
  the ground truth.
* **seeding** — the static gene (measured first, so the winner is never
  slower than the static choice whenever the budget allows a run per
  mode) and the winners of the nearest store records by meta distance.
* **the winner** — as in the exhaustive tuner: the fastest measured gene
  displaces the static one only where it `autotune.beats` it, and a
  ``chunk_m`` the ladder's first (the byte model's) likewise.

The features (`gene_features`, `N_FEATURES` of them, no measurement
needed), re-derived for the H100 kernels:

 0. bias;
 1. log nnz; 2. log stream length M; 3. log I_n; 4. log Σ dims;
 5. log density (log nnz − Σ log dims);
 6. the mode's fiber reuse; 7. the mean fiber reuse;
 8. log rank; 9. log ``r_block``; 10. log ``block_m``;
11. log oriented slices ⌈M / block_m⌉;
12. recursive; 13. carry (one-hot partials when both are 0);
14. log bytes the gene's kernels move — the bound bytes of the kernel
    table in PERF.md: the stream once per rank tile, the other factors
    (or Π under ALTO-PRE), B for Φ, the output, and K2/K6's slots written
    and read back by the split, or K3/K7's Temp written and pulled;
15. log (1 + shared memory per CTA): K3/K7 at their window
    (`common.smem_bytes`), 0 for the oriented kernels;
16. log waves: the CTAs the gene launches over `plan.SMS` × the CTAs an
    SM holds at its CTA size (slices for the oriented kernels, a
    sub-warp each; partitions × rank tiles for the recursive ones);
17. log CTA size;
18. log chunks (streaming; 0 in core);
19. Φ objective.

Every measurement is appended as a JSONL record under
``$REPRO_TORCH_TUNE_LOG`` (generation, candidate, predicted and measured
time, budget spent).

On the CPU a ``"cuda"`` backend runs the kernels' plain versions, so its
measurements, and a model trained on them, rank proxies; the model only
learns from samples of the device kind it ranks for.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import threading
import time

import numpy as np

from repro_torch.core import autotune
from repro_torch.core import heuristics
from repro_torch.core import plan as plan_mod
from repro_torch.core.alto import AltoMeta, AltoTensor
from repro_torch.kernels import common, ops
from repro_torch.kernels.mttkrp_oriented import lane_map

TUNE_LOG_ENV = "REPRO_TORCH_TUNE_LOG"

GENERATIONS = 4
POPULATION = 8
TOP_K = 2                    # measured candidates per mode per generation
MUTATE_P = 0.35
MODEL_MIN_SAMPLES = 8        # below this the model stays unfit
RIDGE_LAMBDA = 1e-2
MAX_RECORD_SAMPLES = 48      # samples persisted per store record
MAX_CHUNK_CANDIDATES = 4     # halving ladder below the byte model's chunk
N_FEATURES = 20
SM_SHARED_BYTES = 228 * 1024  # shared memory of one H100 SM
MAX_CTAS_PER_SM = 32

# One timing protocol with the exhaustive tuner; module names of their
# own, so a test can replace the search's timer alone.
_time_mttkrp = autotune._time_mttkrp
_time_phi = autotune._time_phi


# ---------------------------------------------------------------------------
# JSONL experiment log ($REPRO_TORCH_TUNE_LOG)
# ---------------------------------------------------------------------------

class TuneLogger:
    """Append-only JSONL log at ``$REPRO_TORCH_TUNE_LOG``, one flat line
    per event with sorted keys; disabled when the variable is unset."""

    def __init__(self):
        p = os.environ.get(TUNE_LOG_ENV)
        self.path = pathlib.Path(p).expanduser() if p else None
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.path is not None

    def write(self, event: str, **fields) -> None:
        if self.path is None:
            return
        fields["event"] = event
        fields["ts"] = time.time()
        line = json.dumps(fields, sort_keys=True)
        with self._lock:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line + "\n")


# ---------------------------------------------------------------------------
# Measurement budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchBudget:
    """Timing runs and/or seconds; None is unlimited on that axis.
    ``max_runs=0`` measures nothing (the cost model picks the plan)."""
    max_runs: int | None = None
    max_seconds: float | None = None
    runs_used: int = 0
    seconds_used: float = 0.0

    def allows(self) -> bool:
        if self.max_runs is not None and self.runs_used >= self.max_runs:
            return False
        if (self.max_seconds is not None
                and self.seconds_used >= self.max_seconds):
            return False
        return True

    def charge(self, seconds: float) -> None:
        self.runs_used += 1
        self.seconds_used += seconds


# ---------------------------------------------------------------------------
# Analytic features and the ridge cost model
# ---------------------------------------------------------------------------

def gene_bytes(meta: AltoMeta, rank: int, mode: int,
               traversal: heuristics.Traversal, r_block: int, block_m: int,
               *, objective: str = "mttkrp") -> int:
    """Bytes the gene's kernels move, each read or write once (the bound
    bytes of the kernel table in PERF.md)."""
    dtype_bytes = autotune.DTYPE_BYTES
    M = heuristics.stream_len(meta)
    W, N = meta.enc.n_words, meta.enc.ndim
    I_n = meta.dims[mode]
    phi = objective == "phi"
    pre = phi and (heuristics.choose_pi_policy(meta, rank)
                   is heuristics.PiPolicy.PRE)
    others = sum(I for m, I in enumerate(meta.dims) if m != mode)
    out = I_n * rank * dtype_bytes
    if traversal is heuristics.Traversal.RECURSIVE:
        L, T = meta.n_partitions, meta.temp_rows[mode]
        stream = M * (4 * W + dtype_bytes) + L * N * 4
        temp = L * T * rank * dtype_bytes
        tiles = 1 if phi else rank // r_block
        operands = (M * rank * dtype_bytes if pre
                    else others * rank * dtype_bytes)
        b = out if phi else 0
        return stream * tiles + operands + b + 2 * temp + out
    Mp = -(-M // block_m) * block_m
    if pre:
        stream = Mp * (4 + dtype_bytes)            # rows, values; no words
        operands = Mp * rank * dtype_bytes         # Π
    else:
        stream = Mp * (4 + 4 * W + dtype_bytes)
        operands = others * rank * dtype_bytes
    tiles = 1 if phi else rank // r_block
    carries = (Mp // block_m) * 2 * (4 + rank * dtype_bytes)
    total = stream * tiles + operands + out + carries + (out if phi else 0)
    if traversal is heuristics.Traversal.OUTPUT_ORIENTED:
        total += 2 * Mp * rank * dtype_bytes + Mp * 4   # slots, split rows
    return total


def gene_smem_bytes(meta: AltoMeta, rank: int, mode: int,
                    traversal: heuristics.Traversal, r_block: int, *,
                    objective: str = "mttkrp") -> int:
    """Shared memory of one CTA: K3 / K7 at their window under
    `plan.SMEM_BYTES`, 0 for the oriented kernels."""
    if traversal is not heuristics.Traversal.RECURSIVE:
        return 0
    smem_limit = plan_mod.SMEM_BYTES
    phi = objective == "phi"
    cols = rank if phi else r_block
    try:
        window = common.window_rows(meta.temp_rows[mode], cols, smem_limit,
                                    phi)
    except ValueError:
        return smem_limit
    return common.smem_bytes(window, cols, common.tile_nnz(cols), phi)


def gene_waves(meta: AltoMeta, rank: int, mode: int,
               traversal: heuristics.Traversal, r_block: int, block_m: int,
               threads: int, *, objective: str = "mttkrp",
               chunk_m: int = 0) -> float:
    """CTAs the gene launches over what the card holds at once
    (`plan.SMS` SMs, each as many CTAs as threads, shared memory and
    `MAX_CTAS_PER_SM` allow); a streaming gene counts one chunk."""
    phi = objective == "phi"
    cta = common.cta_threads(threads)
    tiles = 1 if phi else rank // r_block
    per_sm = min(MAX_CTAS_PER_SM, plan_mod.MAX_THREADS_PER_SM // cta)
    if traversal is heuristics.Traversal.RECURSIVE:
        smem = gene_smem_bytes(meta, rank, mode, traversal, r_block,
                               objective=objective)
        per_sm = max(1, min(per_sm, SM_SHARED_BYTES // max(smem, 1)))
        ctas = meta.n_partitions * tiles
    else:
        M = chunk_m or heuristics.stream_len(meta)
        lanes = lane_map(min(rank if phi else r_block,
                             plan_mod.MAX_R_BLOCK))[0]
        slices = -(-M // block_m) * tiles
        ctas = -(-slices // max(1, cta // lanes))
    return ctas / (plan_mod.SMS * max(per_sm, 1))


def gene_features(meta: AltoMeta, rank: int, mode: int,
                  traversal: heuristics.Traversal, r_block: int,
                  block_m: int, threads: int, *, chunk_m: int = 0,
                  objective: str = "mttkrp") -> list[float]:
    """The `N_FEATURES` analytic features of one (tensor, mode, gene); see
    the module docstring for the list."""
    log = math.log
    M = heuristics.stream_len(meta)
    dims = meta.dims
    log_vol = sum(log(d) for d in dims)
    n_chunks = plan_mod.chunk_count(meta, chunk_m) if chunk_m else 1
    nbytes = gene_bytes(meta, rank, mode, traversal, r_block, block_m,
                        objective=objective)
    smem = gene_smem_bytes(meta, rank, mode, traversal, r_block,
                           objective=objective)
    waves = gene_waves(meta, rank, mode, traversal, r_block, block_m,
                       threads, objective=objective, chunk_m=chunk_m)
    return [
        1.0,
        log(max(meta.nnz, 1)),
        log(max(M, 1)),
        log(dims[mode]),
        log(sum(dims)),
        log(max(meta.nnz, 1)) - log_vol,
        float(meta.fiber_reuse[mode]),
        float(np.mean(meta.fiber_reuse)),
        log(rank),
        log(r_block),
        log(block_m),
        log(max(1, -(-M // block_m))),
        1.0 if traversal is heuristics.Traversal.RECURSIVE else 0.0,
        1.0 if traversal is heuristics.Traversal.ORIENTED_CARRY else 0.0,
        log(max(nbytes, 1)),
        log(1 + smem),
        log(waves),
        log(common.cta_threads(threads)),
        log(max(n_chunks, 1)),
        1.0 if objective == "phi" else 0.0,
    ]


class CostModel:
    """Ridge regression on log-seconds over `gene_features` vectors,
    closed form on standardized features (numpy). Unfit below
    `MODEL_MIN_SAMPLES` samples: `predict` returns None then."""

    def __init__(self):
        self._X: list[list[float]] = []
        self._y: list[float] = []
        self._w = None
        self._mu = None
        self._sd = None

    @property
    def n_samples(self) -> int:
        return len(self._y)

    @property
    def ready(self) -> bool:
        return self._w is not None

    def add_sample(self, features, seconds: float) -> None:
        if len(features) != N_FEATURES or not (seconds > 0):
            return                      # a malformed sample: skipped
        self._X.append([float(f) for f in features])
        self._y.append(math.log(seconds))
        self._w = None

    def fit(self) -> bool:
        if len(self._y) < MODEL_MIN_SAMPLES:
            return False
        X = np.asarray(self._X, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        mu = X.mean(axis=0)
        sd = X.std(axis=0)
        sd[sd < 1e-12] = 1.0
        mu[0], sd[0] = 0.0, 1.0         # the bias column as it is
        Z = (X - mu) / sd
        A = Z.T @ Z + RIDGE_LAMBDA * len(y) * np.eye(N_FEATURES)
        try:
            self._w = np.linalg.solve(A, Z.T @ y)
        except np.linalg.LinAlgError:
            return False
        self._mu, self._sd = mu, sd
        return True

    def predict(self, features) -> float | None:
        """Predicted seconds, or None while unfit."""
        if self._w is None:
            return None
        z = (np.asarray(features, dtype=np.float64) - self._mu) / self._sd
        return float(math.exp(float(z @ self._w)))


def model_from_store(plans: dict, device_kind: str) -> CostModel:
    """A cost model fit on every sample in the store measured on
    ``device_kind`` (a CPU proxy sample never ranks card candidates)."""
    model = CostModel()
    for record in plans.values():
        if not isinstance(record, dict):
            continue
        kind = (record.get("tuned") or {}).get("device")
        if kind != device_kind:
            continue
        for sample in record.get("samples") or []:
            try:
                model.add_sample(sample["f"], float(sample["s"]))
            except (KeyError, TypeError, ValueError):
                continue
    model.fit()
    return model


def store_neighbors(plans: dict, meta: AltoMeta, rank: int, *,
                    objective: str = "mttkrp",
                    limit: int = 3) -> list[dict]:
    """The nearest store records of the same number of modes and
    objective, by Σ|Δ log dims| + |Δ log nnz| + |Δ log rank|; their
    winners seed the population."""
    scored = []
    for record in plans.values():
        if not isinstance(record, dict):
            continue
        dims = record.get("dims")
        if (not isinstance(dims, list) or len(dims) != len(meta.dims)
                or not record.get("modes")):
            continue
        obj = (record.get("tuned") or {}).get("objective")
        if obj is not None and obj != objective:
            continue
        try:
            d = sum(abs(math.log(int(a)) - math.log(b))
                    for a, b in zip(dims, meta.dims))
            d += abs(math.log(max(int(record.get("nnz", 1)), 1))
                     - math.log(max(meta.nnz, 1)))
            d += abs(math.log(max(int(record.get("rank", rank)), 1))
                     - math.log(rank))
        except (TypeError, ValueError):
            continue
        scored.append((d, record))
    scored.sort(key=lambda t: t[0])
    return [r for _, r in scored[:limit]]


# ---------------------------------------------------------------------------
# The gene pools
# ---------------------------------------------------------------------------

def mode_pool(meta: AltoMeta, mode: int, rank: int, *, backend: str,
              objective: str = "mttkrp", streaming: bool = False
              ) -> tuple[plan_mod.ModePlan, ...]:
    """The feasible genes of one mode, the static gene FIRST: the repair
    domain. In core `plan.candidate_mode_plans` (uncapped); streaming, the
    carry traversal at every rank tile and ``block_m``, its static gene
    first. Deduped as the exhaustive tuner does (`autotune.dedupe`)."""
    if not streaming:
        pool = plan_mod.candidate_mode_plans(meta, mode, rank,
                                             objective=objective)
        return autotune.dedupe(pool, backend, objective)
    static = plan_mod.static_mode_plan(meta, mode, rank, force_carry=True)
    pool = [static]
    seen = {(static.r_block, static.block_m)}
    for rb in plan_mod.divisors_desc(rank):
        if rb > plan_mod.MAX_R_BLOCK:
            continue
        bm = plan_mod.MAX_BLOCK_M
        while bm >= plan_mod.MIN_BLOCK_M:
            if (rb, bm) not in seen:
                seen.add((rb, bm))
                pool.append(plan_mod.ModePlan(
                    mode=mode, traversal=heuristics.Traversal.ORIENTED_CARRY,
                    r_block=rb, block_m=bm, temp_rows=meta.temp_rows[mode],
                    threads=plan_mod.cta_threads(rb)))
            bm //= 2
    return autotune.dedupe(pool, backend, objective, streaming=True)


def gene_distance(g: plan_mod.ModePlan, traversal, r_block: int,
                  block_m: int, threads: int | None = None) -> float:
    d = 0.0 if g.traversal is traversal else 4.0
    d += abs(math.log2(g.block_m) - math.log2(max(block_m, 1)))
    d += abs(math.log2(g.r_block) - math.log2(max(r_block, 1)))
    if threads is not None:
        d += abs(math.log2(g.threads) - math.log2(max(threads, 1)))
    return d


def repair(pool, traversal, r_block: int, block_m: int,
           threads: int | None = None) -> int:
    """The index of the pool gene nearest to an arbitrary (traversal,
    r_block, block_m[, threads]); ties go to the earlier entry."""
    return min(range(len(pool)),
               key=lambda i: (gene_distance(pool[i], traversal, r_block,
                                            block_m, threads), i))


def chunk_ladder(meta: AltoMeta, rank: int, device_bytes: int,
                 align: int) -> list[int]:
    """``chunk_m`` candidates: the byte model's largest (the static
    choice, first), then halvings down to one ``align`` block, each a
    multiple of ``align`` (the largest ``block_m``, so chunk bounds are
    block bounds of every mode) and within the budget by construction."""
    top = plan_mod.choose_chunk_m(meta, rank, device_bytes, align)
    ladder, cm = [], top
    while cm >= align and len(ladder) < MAX_CHUNK_CANDIDATES:
        ladder.append(cm)
        nxt = ((cm // 2) // align) * align
        if nxt == cm:
            break
        cm = nxt
    return ladder


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModeWinner:
    mode: int
    traversal: str
    r_block: int
    block_m: int
    threads: int
    measured_s: float | None      # None on a zero-measurement warm start
    predicted_s: float | None
    is_static: bool


@dataclasses.dataclass(frozen=True)
class SearchReport:
    key: str
    store: str                    # the path written ("" if not)
    objective: str
    backend: str
    budget_runs: int | None
    budget_s: float | None
    runs_used: int
    seconds_used: float
    generations: int
    pool_sizes: tuple[int, ...]
    model_samples: int            # training samples available at start
    model_used: bool              # the model ranked candidates
    warm_start: bool              # nothing measured, the model chose
    neighbors: int                # store records that seeded the search
    winners: tuple[ModeWinner, ...]
    chunk_m: int | None           # streaming plans only
    chunk_candidates: int
    chunk_times: dict             # chunk_m -> measured seconds

    @property
    def best_time_s(self) -> float | None:
        ts = [w.measured_s for w in self.winners]
        return None if any(t is None for t in ts) else float(sum(ts))


# ---------------------------------------------------------------------------
# The GA
# ---------------------------------------------------------------------------

class _ModeSearch:
    """GA state of one mode: a population of pool indices (so every
    genome is feasible) and its memoized measurements."""

    def __init__(self, mode, pool, rng, population, seeds):
        self.mode = mode
        self.pool = pool
        self.rng = rng
        self.size = max(2, min(population, max(2, len(pool))))
        pop = [0]                       # the static gene, always
        for s in seeds:
            if s not in pop:
                pop.append(s)
        while len(pop) < self.size:
            c = int(rng.integers(len(pool)))
            if c not in pop or len(pop) >= len(pool):
                pop.append(c)
        self.population = pop[:self.size]
        self.measured: dict[int, float] = {}
        self.iqr: dict[int, float] = {}
        self.predicted: dict[int, float | None] = {}

    def fitness(self, i: int) -> float:
        if i in self.measured:
            return self.measured[i]
        p = self.predicted.get(i)
        if p is not None:
            return p
        # Unfit model: the pool's prior order (static first, larger tiles
        # first), as pseudo-times far above any real one.
        return 1e6 * (1.0 + i)

    def to_measure(self, top_k: int, first_generation: bool) -> list[int]:
        ranked = sorted(set(self.population),
                        key=lambda i: (self.fitness(i), i))
        picks = [i for i in ranked if i not in self.measured][:top_k]
        if first_generation and 0 not in self.measured and 0 not in picks:
            picks = [0] + picks[:max(0, top_k - 1)]
        return picks

    def _tournament(self) -> int:
        a, b = (int(self.rng.integers(len(self.population)))
                for _ in range(2))
        ia, ib = self.population[a], self.population[b]
        return ia if self.fitness(ia) <= self.fitness(ib) else ib

    def evolve(self, mutate_p: float) -> None:
        if len(self.pool) <= 2:
            return
        elite = sorted(set(self.population),
                       key=lambda i: (self.fitness(i), i))[:2]
        nxt = list(elite)
        while len(nxt) < self.size:
            p1 = self.pool[self._tournament()]
            p2 = self.pool[self._tournament()]
            pick = [p1 if self.rng.random() < 0.5 else p2 for _ in range(4)]
            trav, rb = pick[0].traversal, pick[1].r_block
            bm, th = pick[2].block_m, pick[3].threads
            if self.rng.random() < mutate_p:
                field = int(self.rng.integers(4))
                up = self.rng.random() < 0.5
                if field == 0:
                    trav = self.pool[int(self.rng.integers(
                        len(self.pool)))].traversal
                elif field == 1:
                    rb = max(1, rb * 2 if up else rb // 2)
                elif field == 2:
                    bm = min(plan_mod.MAX_BLOCK_M, max(
                        plan_mod.MIN_BLOCK_M, bm * 2 if up else bm // 2))
                else:
                    th = min(1024, max(32, th * 2 if up else th // 2))
            nxt.append(repair(self.pool, trav, rb, bm, th))
        self.population = nxt[:self.size]

    def winner(self) -> tuple[int, float | None, float | None]:
        """(pool index, measured s, predicted s): the fastest measured
        gene (the static one unless it `autotune.beats` it), else the
        model's pick, else the static gene."""
        if self.measured:
            i = min(self.measured, key=lambda i: (self.measured[i], i))
            if 0 in self.measured and i != 0 and not autotune.beats(
                    self.measured[i], self.iqr[i], self.measured[0],
                    self.iqr[0]):
                i = 0
            return i, self.measured[i], self.predicted.get(i)
        preds = {i: p for i, p in self.predicted.items() if p is not None}
        if preds:
            i = min(preds, key=lambda i: (preds[i], i))
            return i, None, preds[i]
        return 0, None, None


def search_plan(at: AltoTensor, rank: int, *, backend: str | None = None,
                objective: str = "mttkrp",
                device_bytes: int | None = None,
                budget_runs: int | None = None,
                budget_s: float | None = None, seed: int = 0,
                persist: bool = True, store_path=None
                ) -> tuple[plan_mod.ExecutionPlan, SearchReport]:
    """Budgeted GA + cost-model search; returns ``(plan, report)``.

    ``device_bytes`` that the in-core working set overflows makes the
    genome streaming: the pools pin the carry traversal and ``chunk_m``
    is searched over `chunk_ladder` on the slowest mode once the tiling
    genes are chosen. Without a budget the search takes a quarter of the
    pool sizes, at least two runs per mode.

    The same (seed, store, tensor, budget) measures the same candidates
    in the same order; only which candidate times fastest can differ.
    The winner is stored, so a later ``make_plan(..., tune="search")`` is
    a store hit with zero timing runs."""
    from repro_torch.core import views as views_mod
    if objective not in autotune.OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    meta = at.meta
    backend = backend or plan_mod.default_backend(at.device)
    streaming = (device_bytes is not None
                 and plan_mod.needs_streaming(meta, rank, device_bytes))
    if not streaming:
        device_bytes = None
    pi_policy = heuristics.choose_pi_policy(meta, rank)
    pre_pi = pi_policy is heuristics.PiPolicy.PRE
    ndim = meta.enc.ndim
    kind = autotune.device_kind(at.device)

    pools = [mode_pool(meta, n, rank, backend=backend, objective=objective,
                       streaming=streaming)
             for n in range(ndim)]
    if budget_runs is None and budget_s is None:
        budget_runs = max(2 * ndim, -(-sum(len(p) for p in pools) // 4))
    budget = SearchBudget(max_runs=budget_runs, max_seconds=budget_s)

    plans = autotune.load_store(store_path)
    model = model_from_store(plans, kind)
    model_samples = model.n_samples
    neighbors = store_neighbors(plans, meta, rank, objective=objective)

    rng = np.random.default_rng(seed)
    searches = []
    for n in range(ndim):
        seeds = []
        for record in neighbors:
            try:
                g = record["modes"][n]
                seeds.append(repair(pools[n],
                                    heuristics.Traversal(g["traversal"]),
                                    int(g["r_block"]), int(g["block_m"]),
                                    int(g.get("threads", 128))))
            except (KeyError, IndexError, ValueError, TypeError):
                continue
        searches.append(_ModeSearch(n, pools[n], rng, POPULATION, seeds))

    factors = autotune.seeded_factors(meta, rank, seed, at.device)
    analytic_chunk = None
    if streaming:
        align0 = max(max(g.block_m for g in p) for p in pools)
        analytic_chunk = plan_mod.choose_chunk_m(meta, rank, device_bytes,
                                                 align0)
    stream_bytes = plan_mod.incore_working_set_bytes(meta, rank)

    def candidate_plan(mode, gene, chunk_m):
        modes = [searches[m].pool[0] for m in range(ndim)]
        modes[mode] = gene
        stream = None
        if streaming:
            cm = chunk_m if chunk_m is not None else analytic_chunk
            # Align the chunk to the measured mode's block only: the other
            # modes do not run under this candidate.
            cm = -(-cm // gene.block_m) * gene.block_m
            stream = plan_mod.StreamPlan(
                chunk_m=cm, n_chunks=plan_mod.chunk_count(meta, cm),
                device_bytes=device_bytes, stream_bytes=stream_bytes)
        return plan_mod.ExecutionPlan(meta=meta, rank=rank, backend=backend,
                                      modes=tuple(modes),
                                      pi_policy=pi_policy, streaming=stream)

    mode_operands: dict[int, tuple] = {}

    def operands(mode):
        """(views, view, B, pi_alto, pi_view) of one mode, built once."""
        if mode in mode_operands:
            return mode_operands[mode]
        if streaming:
            view = views_mod.get_stream(at, mode)
        else:
            oriented = any(heuristics.is_oriented(g.traversal)
                           for g in pools[mode])
            view = views_mod.get_view(at, mode) if oriented else None
        views = {mode: view} if view is not None else {}
        B = pi_alto = pi_view = None
        if objective == "phi":
            B = factors[mode].abs() + 0.1
            if pre_pi and not streaming:
                pi_alto = ops.pi_rows(at.meta.enc, at.words, factors, mode)
                if view is not None:
                    pi_view = ops.pi_rows(at.meta.enc, view.words, factors,
                                          mode)
        out = (views, view, B, pi_alto, pi_view)
        mode_operands[mode] = out
        return out

    logger = TuneLogger()
    key = autotune.plan_key(meta, rank, backend, device=at.device,
                            objective=objective, device_bytes=device_bytes)
    logger.write("search_start", key=key, objective=objective,
                 backend=backend, streaming=streaming,
                 budget_runs=budget_runs, budget_s=budget_s,
                 pool_sizes=[len(p) for p in pools],
                 model_samples=model_samples, neighbors=len(neighbors),
                 seed=seed, dims=list(meta.dims), nnz=meta.nnz, rank=rank,
                 device=kind)

    memo: dict[tuple, tuple[float, float]] = {}
    new_samples: list[dict] = []

    def features(mode, gene, cm):
        return gene_features(meta, rank, mode, gene.traversal, gene.r_block,
                             gene.block_m, gene.threads, chunk_m=cm,
                             objective=objective)

    def measure(mode, pool_i, chunk_m, generation):
        """(median, IQR) seconds of one gene (memoized), or None once the
        budget is spent."""
        gene = searches[mode].pool[pool_i]
        cm = ((chunk_m if chunk_m is not None else analytic_chunk)
              if streaming else 0)
        mkey = (mode, gene.traversal, gene.r_block, gene.block_m,
                gene.threads, cm)
        if mkey in memo:
            return memo[mkey]
        if not budget.allows():
            return None
        views, view, B, pi_alto, pi_view = operands(mode)
        cand = candidate_plan(mode, gene, chunk_m)
        feats = features(mode, gene, cm)
        predicted = model.predict(feats)
        t0 = time.perf_counter()
        if objective == "phi":
            pi = (((pi_view if heuristics.is_oriented(gene.traversal)
                    else pi_alto)) if pre_pi and not streaming else None)
            median, iqr = _time_phi(cand, at, view, B, factors, pi, mode)
        else:
            median, iqr = _time_mttkrp(cand, at, views, factors, mode)
        budget.charge(time.perf_counter() - t0)
        median, iqr = float(median), float(iqr)
        memo[mkey] = (median, iqr)
        model.add_sample(feats, median)
        new_samples.append({"f": [round(f, 6) for f in feats],
                            "s": median})
        logger.write("measure", key=key, generation=generation, mode=mode,
                     traversal=gene.traversal.value, r_block=gene.r_block,
                     block_m=gene.block_m, threads=gene.threads,
                     chunk_m=cm or None,
                     predicted_us=(None if predicted is None
                                   else predicted * 1e6),
                     measured_us=median * 1e6, iqr_us=iqr * 1e6,
                     budget_runs_used=budget.runs_used,
                     budget_seconds_used=round(budget.seconds_used, 6))
        return median, iqr

    def refresh_predictions(ms):
        for i in set(ms.population):
            ms.predicted[i] = model.predict(
                features(ms.mode, ms.pool[i], analytic_chunk or 0))

    model_used = model.ready
    gens_run = 0
    for gen in range(GENERATIONS):
        if not budget.allows() and gen > 0:
            break
        gens_run = gen + 1
        for ms in searches:
            refresh_predictions(ms)
            for i in ms.to_measure(TOP_K, first_generation=gen == 0):
                t = measure(ms.mode, i, None, generation=gen)
                if t is None:
                    break
                ms.measured[i], ms.iqr[i] = t
            ms.evolve(MUTATE_P)
        model.fit()

    # Streaming: the chunk_m gene, on the slowest mode.
    chunk_winner = analytic_chunk
    chunk_times: dict[int, float] = {}
    chunk_iqrs: dict[int, float] = {}
    n_chunk_cands = 0
    if streaming:
        win_genes = [ms.pool[ms.winner()[0]] for ms in searches]
        align = max(g.block_m for g in win_genes)
        ladder = chunk_ladder(meta, rank, device_bytes, align)
        n_chunk_cands = len(ladder)
        measured = [ms for ms in searches if ms.measured]
        bottleneck = (max(measured, key=lambda ms: ms.winner()[1]).mode
                      if measured else int(np.argmax(meta.dims)))
        for cm in ladder:
            t = measure(bottleneck, searches[bottleneck].winner()[0], cm,
                        generation="chunk")
            if t is None:
                break
            chunk_times[cm], chunk_iqrs[cm] = t
        chunk_winner = ladder[0] if ladder else analytic_chunk
        if chunk_times:
            fast = min(chunk_times, key=lambda c: (chunk_times[c], -c))
            first = ladder[0]
            if first not in chunk_times or autotune.beats(
                    chunk_times[fast], chunk_iqrs[fast], chunk_times[first],
                    chunk_iqrs[first]):
                chunk_winner = fast
        # Keep the chunk a multiple of the winning tiling's largest block.
        chunk_winner = max(align, -(-chunk_winner // align) * align)

    winners, win_modes = [], []
    warm = budget.runs_used == 0 and model.ready
    for ms in searches:
        refresh_predictions(ms)
        i, measured_s, predicted_s = ms.winner()
        g = ms.pool[i]
        win_modes.append(g)
        winners.append(ModeWinner(
            mode=ms.mode, traversal=g.traversal.value, r_block=g.r_block,
            block_m=g.block_m, threads=g.threads, measured_s=measured_s,
            predicted_s=(predicted_s if predicted_s is not None
                         else ms.predicted.get(i)),
            is_static=i == 0))
    stream = None
    if streaming:
        stream = plan_mod.StreamPlan(
            chunk_m=chunk_winner,
            n_chunks=plan_mod.chunk_count(meta, chunk_winner),
            device_bytes=device_bytes, stream_bytes=stream_bytes)
    plan = plan_mod.ExecutionPlan(meta=meta, rank=rank, backend=backend,
                                  modes=tuple(win_modes),
                                  pi_policy=pi_policy, streaming=stream)

    stored = ""
    if persist:
        record = autotune.serialize_plan(plan)
        record["tuned"] = {
            "mode": "search", "device": kind, "objective": objective,
            "seed": seed, "generations": gens_run,
            "budget_runs": budget_runs, "budget_s": budget_s,
            "runs_used": budget.runs_used,
            "seconds_used": round(budget.seconds_used, 6),
            "warm_start": warm}
        old = plans.get(key) or {}
        keep = (old.get("samples") or [])[:MAX_RECORD_SAMPLES]
        record["samples"] = (new_samples + keep)[:MAX_RECORD_SAMPLES]
        # Re-read before writing: another process may have stored since.
        plans = autotune.load_store(store_path)
        plans[key] = record
        stored = str(autotune.save_store(plans, store_path))

    report = SearchReport(
        key=key, store=stored, objective=objective, backend=backend,
        budget_runs=budget_runs, budget_s=budget_s,
        runs_used=budget.runs_used, seconds_used=budget.seconds_used,
        generations=gens_run, pool_sizes=tuple(len(p) for p in pools),
        model_samples=model_samples, model_used=model_used,
        warm_start=warm, neighbors=len(neighbors), winners=tuple(winners),
        chunk_m=chunk_winner if streaming else None,
        chunk_candidates=n_chunk_cands, chunk_times=chunk_times)
    logger.write("search_end", key=key, runs_used=budget.runs_used,
                 seconds_used=round(budget.seconds_used, 6),
                 generations=gens_run, warm_start=warm,
                 chunk_m=report.chunk_m,
                 winners=[{"mode": w.mode, "traversal": w.traversal,
                           "r_block": w.r_block, "block_m": w.block_m,
                           "threads": w.threads,
                           "measured_us": (None if w.measured_s is None
                                           else w.measured_s * 1e6)}
                          for w in winners],
                 store=stored)
    return plan, report
