"""Execution plans: resolve the paper's adaptive heuristics into kernels.

Paper §4.2 (Table 1). Plans are frozen and hashable, and every decision
is made from the static `AltoMeta`, never from tensor data.

A plan answers, per mode:

  * **traversal** — the paper's fiber-reuse rule picks recursive vs
    output-oriented (`heuristics.choose_traversal`); an output-oriented
    mode then picks the one-hot partials or the carry variant by modelled
    device-memory traffic (`heuristics.choose_oriented_variant`);
  * **tiling** — ``r_block``, ``block_m`` and threads per CTA, from the
    Hopper model below of the kernels in ``kernels/csrc``;
  * **backend** — ``"cuda"`` (the hand-written kernels; on CPU tensors
    their plain versions) or ``"reference"`` (the plain traversals of
    `core.mttkrp`). The default follows the tensor's device;
  * **Π policy** (CP-APR, per tensor) — ALTO-PRE or ALTO-OTF
    (`heuristics.choose_pi_policy`, paper §4.3);
  * **streaming** — given a device byte budget (``device_bytes=`` or
    ``$REPRO_DEVICE_BYTES``) that the in-core working set overflows, the
    plan goes out of core: every mode runs the carry traversal over a
    host-resident stream in chunks of `StreamPlan.chunk_m` elements
    (`kernels.ops.mttkrp_oriented_chunked`). The byte models below are
    the JAX package's, term for term, so both packages pick the same
    chunks at equal ``block_m``;
  * **shards** — ``make_plan(shards=D)`` makes a plan for D ranks of a
    `torch.distributed` process group, each running the oriented kernels
    on a contiguous row-range slice of the row-sorted stream
    (`repro_torch.dist.cpd`): every mode oriented, ``block_m`` sized for a
    slice. The group itself is passed at call time (``group=``, default
    the world group); a sharded plan never streams.

The Hopper model. Every kernel walks each slice of the stream (a
``block_m`` slice, or an ALTO partition for the recursive kernels) in
stream order, because a run's terms are summed in that order: a thread
per rank column in K2, a sub-warp of lanes holding a few columns each in
K1, K5, K6 and K8/K9 (`kernels.mttkrp_oriented.lane_map`), a CTA per
partition in K3 and K7. Factor rows are gathered from device memory and
the output lives in device memory, so only K3 and K7 keep a tile (their
Temp window) resident, and the carry variant — whose whole output stayed in the TPU's VMEM — has
no resident-output gate here: on hyper-sparse long modes the port picks
carry where the JAX package's VMEM gate forces the one-hot variant.

  * ``r_block``: the largest divisor of the rank up to `MAX_R_BLOCK`
    (larger ranks split into rank tiles);
  * threads per CTA: ``r_block`` times the slices a thread-per-column
    CTA holds, about `THREADS_PER_CTA` (the sub-warp kernels take it as
    their CTA size);
  * ``block_m``: the largest power of two in [`MIN_BLOCK_M`,
    `MAX_BLOCK_M`] that still leaves `TARGET_WAVES` waves of
    thread-per-column slices on the card's `SMS` multiprocessors — each
    slice is one serial walk, so the card needs many of them in flight.
    The sub-warp kernels run the same slices (every bitwise contract
    depends on equal ``block_m``).

Measured plans. ``make_plan(..., tune="auto"|"force"|"search")`` swaps
the static answer for a measured one (`core.autotune`, `core.search`):
`candidate_mode_plans` is the tiling space the kernels take at run time
— traversal × ``r_block`` × ``block_m`` for the oriented kernels,
traversal × ``r_block`` × CTA size for the recursive ones, whose Temp
must fit one shared-memory window of `SMEM_BYTES` — with the static
choice first. Winners persist in a plan store of their own, so a later
process gets the measured plan back with zero timing runs.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.core import faults, heuristics
from repro_torch.core import mttkrp as core_mttkrp
from repro_torch.core.alto import AltoMeta, AltoTensor, OrientedView
from repro_torch.kernels import common, ops

SMS = 132                    # H100 SXM multiprocessors
MAX_THREADS_PER_SM = 2048
THREADS_PER_CTA = 128
MAX_R_BLOCK = common.MAX_RANK_TILE
MIN_BLOCK_M = 8
MAX_BLOCK_M = 1024
TARGET_WAVES = 4
BACKENDS = ("cuda", "reference")
TUNE_MODES = ("off", "auto", "force", "search")
# Shared memory one CTA may opt in to on the H100 (`common.smem_limit` on
# the card). A constant, so that plans stay a function of static meta and
# can be made on a CPU; it sizes the recursive kernels' candidate windows.
SMEM_BYTES = 227 * 1024
# CTA sizes the recursive kernels (K3, K7) are tuned over, the static
# size first.
RECURSIVE_THREADS = (128, 64, 256)


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """Resolved execution choices for one target mode."""
    mode: int
    traversal: heuristics.Traversal
    r_block: int        # rank tile (divides the plan rank)
    block_m: int        # oriented-kernel slice length (power of two)
    temp_rows: int      # recursive Temp height
    threads: int        # threads per CTA


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Out-of-core chunking decision, present on a plan iff the in-core
    working set overflows the device byte budget."""
    chunk_m: int          # elements per chunk (a multiple of every block_m)
    n_chunks: int         # ceil(stream_len / chunk_m): the chunks executed
    device_bytes: int     # the budget the choice was made against
    stream_bytes: int     # the in-core working set that overflowed it


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static per-(tensor, rank) kernel routing, hashable."""
    meta: AltoMeta
    rank: int
    backend: str                       # "cuda" | "reference"
    modes: tuple[ModePlan, ...]
    pi_policy: heuristics.PiPolicy = heuristics.PiPolicy.OTF   # CP-APR
    # Non-None routes every oriented mode through the chunked executors
    # (the plan forces the carry traversal then).
    streaming: StreamPlan | None = None
    # Non-None: the number of ranks the row-sorted stream is cut into
    # (`repro_torch.dist.cpd`); 1 is a sharded plan of one rank, which
    # still goes through the collectives. None: one device.
    shards: int | None = None

    def mode_plan(self, mode: int) -> ModePlan:
        return self.modes[mode]

    def traversals(self) -> tuple[str, ...]:
        return tuple(m.traversal.value for m in self.modes)


# ---------------------------------------------------------------------------
# Hopper model
# ---------------------------------------------------------------------------

def divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def choose_rank_block(rank: int) -> int:
    """Largest divisor of ``rank`` up to `MAX_R_BLOCK`
    (`common.rank_tile`)."""
    return common.rank_tile(rank)


def cta_threads(r_block: int) -> int:
    """Threads per CTA: whole slices of ``r_block`` threads, about
    `THREADS_PER_CTA` in all."""
    return r_block * max(1, THREADS_PER_CTA // r_block)


def choose_block_m(meta: AltoMeta, r_block: int, shards: int = 1) -> int:
    """Largest power-of-two slice that leaves `TARGET_WAVES` waves of
    slices on the card (`MIN_BLOCK_M` for short streams). Under ``shards``
    ranks each rank's card runs its own share of the stream, so the waves
    are counted on ``stream_len / shards`` elements."""
    resident = SMS * (MAX_THREADS_PER_SM // r_block)
    share = -(-heuristics.stream_len(meta) // shards)
    bm = MAX_BLOCK_M
    while bm > MIN_BLOCK_M and share < TARGET_WAVES * resident * bm:
        bm //= 2
    return bm


# ---------------------------------------------------------------------------
# Out-of-core byte models and chunk-size selection (the JAX package's)
# ---------------------------------------------------------------------------
#
# What the DEVICE as a whole must hold. In core: the whole padded oriented
# stream plus the chunk-independent residency (factors, output, Φ's B, the
# carry). When that overflows the budget the plan streams, with two
# chunks (double buffer) of the stream on the device at a time. The models
# count no per-chunk Π or coordinates under ALTO-PRE (chunk_m·(R+N)·4
# bytes); they are kept as the JAX package has them so that the plans of
# both packages agree.

def stream_elem_bytes(meta: AltoMeta, dtype_bytes: int = 4) -> int:
    """Device bytes per streamed element: words + row + value."""
    return meta.enc.n_words * 4 + 4 + dtype_bytes


def streaming_resident_bytes(meta: AltoMeta, rank: int,
                             dtype_bytes: int = 4) -> int:
    """Chunk-independent residency of the chunked executors: all factors,
    the worst-mode (I_max, R) output, Φ's (I_max, R) B, and the (1,) +
    (1, R) carry."""
    factors = sum(meta.dims) * rank * dtype_bytes
    i_max = max(meta.dims)
    out_accum = i_max * rank * dtype_bytes
    b_operand = i_max * rank * dtype_bytes
    carry = 4 + rank * dtype_bytes
    return factors + out_accum + b_operand + carry


def incore_working_set_bytes(meta: AltoMeta, rank: int,
                             dtype_bytes: int = 4) -> int:
    """Device bytes of the in-core oriented path: the whole padded stream
    plus the chunk-independent residency."""
    return (heuristics.stream_len(meta) * stream_elem_bytes(meta,
                                                            dtype_bytes)
            + streaming_resident_bytes(meta, rank, dtype_bytes))


def chunk_hbm_bytes(meta: AltoMeta, chunk_m: int, rank: int,
                    dtype_bytes: int = 4) -> int:
    """Device bytes of the chunked executors at ``chunk_m``: two chunks in
    flight plus the chunk-independent residency."""
    return (2 * chunk_m * stream_elem_bytes(meta, dtype_bytes)
            + streaming_resident_bytes(meta, rank, dtype_bytes))


def needs_streaming(meta: AltoMeta, rank: int, device_bytes: int,
                    dtype_bytes: int = 4) -> bool:
    """True iff the in-core working set overflows ``device_bytes``."""
    return incore_working_set_bytes(meta, rank, dtype_bytes) > device_bytes


def chunk_count(meta: AltoMeta, chunk_m: int) -> int:
    """Chunks the executors run: ceil over the partition-padded stream
    (the block padding never adds one: chunk_m is a multiple of every
    block_m)."""
    return -(-heuristics.stream_len(meta) // chunk_m)


def choose_chunk_m(meta: AltoMeta, rank: int, device_bytes: int,
                   align: int, dtype_bytes: int = 4) -> int:
    """Largest ``align``-multiple chunk whose double-buffered footprint
    fits ``device_bytes``, capped at the aligned stream length; one
    ``align`` chunk when not even that fits (the budget is then
    advisory). ``align`` is the largest block_m of the plan's modes, so
    chunk boundaries are block boundaries of every mode."""
    elem = stream_elem_bytes(meta, dtype_bytes)
    resident = streaming_resident_bytes(meta, rank, dtype_bytes)
    avail = device_bytes - resident
    per_chunk = max(0, avail) // (2 * elem)
    chunk = max(align, (per_chunk // align) * align)
    padded = -(-heuristics.stream_len(meta) // align) * align
    return min(chunk, padded)


def default_device_bytes() -> int | None:
    """Process-wide device byte budget: ``$REPRO_DEVICE_BYTES`` or None
    (None: never stream)."""
    v = os.environ.get("REPRO_DEVICE_BYTES", "")
    return int(v) if v else None


def static_mode_plan(meta: AltoMeta, mode: int, rank: int, *,
                     force_carry: bool = False,
                     shards: int | None = None) -> ModePlan:
    """The analytic-model choice for one mode (float32 traffic: the
    kernels take float32 only). ``force_carry`` pins the carry traversal:
    streaming plans need it, the chunked executors being the carry
    scan. ``shards`` (a sharded plan) forces the oriented family, carry
    or one-hot still by `heuristics.choose_oriented_variant`, and sizes
    ``block_m`` for one rank's slice."""
    if force_carry:
        traversal = heuristics.Traversal.ORIENTED_CARRY
    elif shards is not None:
        traversal = heuristics.Traversal.OUTPUT_ORIENTED
    else:
        traversal = heuristics.choose_traversal(meta, mode)
    if not force_carry and heuristics.is_oriented(traversal):
        traversal = heuristics.choose_oriented_variant(meta, mode, rank,
                                                       dtype_bytes=4)
    rb = choose_rank_block(rank)
    return ModePlan(mode=mode, traversal=traversal, r_block=rb,
                    block_m=choose_block_m(meta, rb, shards or 1),
                    temp_rows=meta.temp_rows[mode], threads=cta_threads(rb))


def recursive_fits(meta: AltoMeta, mode: int, rank: int, r_block: int,
                   objective: str = "mttkrp") -> bool:
    """True iff the recursive kernel holds the mode's whole Temp in one
    shared-memory window of `SMEM_BYTES`: K3 (``"mttkrp"``) ``r_block``
    columns, K7 (``"phi"``) the whole rank and the window's B rows
    (`common.window_rows`)."""
    phi = objective == "phi"
    T = meta.temp_rows[mode]
    try:
        return common.window_rows(T, rank if phi else r_block, SMEM_BYTES,
                                  phi) == T
    except ValueError:
        return False


def candidate_mode_plans(meta: AltoMeta, mode: int, rank: int, *,
                         objective: str = "mttkrp",
                         max_candidates: int | None = None,
                         shards: int | None = None
                         ) -> tuple[ModePlan, ...]:
    """The tiling space of one mode, the static choice FIRST (kept even
    where it is not feasible), then by traversal in
    `heuristics.candidate_traversals` order, ``r_block`` descending (the
    divisors of the rank up to `MAX_R_BLOCK`), then ``block_m``
    descending over the powers of two in [`MIN_BLOCK_M`, `MAX_BLOCK_M`]
    for the oriented kernels (CTA size `cta_threads`), or the CTA sizes
    `RECURSIVE_THREADS` for the recursive ones (``block_m`` is dead there
    and keeps the static value), which must pass `recursive_fits` for
    ``objective``. Both oriented variants are always candidates: no
    kernel here keeps its output resident. ``max_candidates`` caps the
    list, the static choice included, through `cap_candidates`. Under
    ``shards`` the static choice is the sharded plan's and only the
    oriented traversals are candidates."""
    static = static_mode_plan(meta, mode, rank, shards=shards)
    out = [static]
    seen = {(static.traversal, static.r_block, static.block_m,
             static.threads)}

    def add(traversal, rb, bm, threads):
        key = (traversal, rb, bm, threads)
        if key not in seen:
            seen.add(key)
            out.append(ModePlan(mode=mode, traversal=traversal, r_block=rb,
                                block_m=bm, temp_rows=meta.temp_rows[mode],
                                threads=threads))

    tiles = [rb for rb in divisors_desc(rank) if rb <= MAX_R_BLOCK]
    for traversal in heuristics.candidate_traversals(meta, mode):
        if shards is not None and not heuristics.is_oriented(traversal):
            continue
        for rb in tiles:
            if traversal is heuristics.Traversal.RECURSIVE:
                if recursive_fits(meta, mode, rank, rb, objective):
                    for th in RECURSIVE_THREADS:
                        add(traversal, rb, static.block_m, th)
                continue
            bm = MAX_BLOCK_M
            while bm >= MIN_BLOCK_M:
                add(traversal, rb, bm, cta_threads(rb))
                bm //= 2
    return cap_candidates(out, max_candidates)


def cap_candidates(cands, max_candidates: int | None
                   ) -> tuple[ModePlan, ...]:
    """At most ``max_candidates`` of a candidate list (None: all): the
    first (the static choice), then the traversal families in turn, each
    in its own order, so a capped list holds every family's leading
    tiles."""
    cands = tuple(cands)
    if max_candidates is None or len(cands) <= max_candidates:
        return cands
    families: dict = {}
    for c in cands[1:]:
        families.setdefault(c.traversal, []).append(c)
    queues = list(families.values())
    out, depth = [cands[0]], 0
    while len(out) < max_candidates:
        for q in queues:
            if depth < len(q) and len(out) < max_candidates:
                out.append(q[depth])
        depth += 1
    return tuple(out)


def default_backend(device=None) -> str:
    """The hand-written kernels for CUDA (the default device), the plain
    reference traversals for the CPU."""
    return "cuda" if torch.device(device or "cuda").type == "cuda" \
        else "reference"


def make_plan(meta: AltoMeta, rank: int, *, backend: str | None = None,
              device=None, device_bytes: int | None = None,
              tune: str = "off", tune_objective: str = "mttkrp",
              at: AltoTensor | None = None,
              search_budget: int | None = None,
              search_seconds: float | None = None,
              search_seed: int = 0, store_path=None,
              oriented_only: bool = False,
              shards: int | None = None, group=None) -> ExecutionPlan:
    """Resolve heuristics + static meta into a concrete execution plan.
    ``backend`` defaults from ``device`` (`default_backend`).

    ``device_bytes`` (default `default_device_bytes`) is the device byte
    budget: when the in-core working set (float32) overflows it the plan
    streams (`StreamPlan`), every mode on the carry traversal.

    ``tune`` picks the static model or a measured plan (`core.autotune`,
    persisted in the plan store):

    * ``"off"`` (default): the static plan;
    * ``"auto"``: the stored measured plan for this (meta, rank, backend,
      device kind, torch and CUDA versions, objective) if the store has
      one; else the tuner's winner when the tensor ``at`` is given (and
      stored); else the static plan;
    * ``"force"``: as ``"auto"``, but a store miss without ``at`` raises;
    * ``"search"``: as ``"auto"``, but a store miss with ``at`` runs the
      budgeted search (`core.search`): ``search_budget`` timing runs,
      ``search_seconds`` of measurement, ``search_seed`` its RNG.

    A streaming plan tunes through the search under every mode but
    ``"off"`` (``chunk_m`` is one of its genes). ``tune_objective``
    names what is timed: ``"mttkrp"`` (CP-ALS) or ``"phi"`` (CP-APR); it
    is part of the store key. The device whose kind keys the store is
    ``at``'s, else ``device``. A store hit costs zero timing runs.
    ``oriented_only`` keeps the tuner to oriented candidates (the static
    choice must be oriented too).

    ``shards`` makes a sharded plan for that many ranks
    (`repro_torch.dist.cpd`): every mode oriented (`static_mode_plan`),
    ``block_m`` sized for one rank's share of the stream, and no
    streaming (a budget the working set overflows raises). Its tuner
    times the sharded executables on every rank of the group and keeps
    rank 0's winner, in a store record of its own (`core.autotune`);
    ``tune="search"`` takes that exhaustive tuner too. ``group`` is the
    process group those timings run on (default the world group)."""
    backend = backend or default_backend(
        at.device if at is not None and device is None else device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if tune not in TUNE_MODES:
        raise ValueError(f"unknown tune mode {tune!r}")
    if device_bytes is None:
        device_bytes = default_device_bytes()
    streaming_needed = (device_bytes is not None
                        and needs_streaming(meta, rank, device_bytes))
    if shards is not None:
        if isinstance(shards, bool) or int(shards) != shards or shards < 1:
            raise ValueError(f"shards must be a positive int, got {shards!r}")
        if streaming_needed:
            raise ValueError("out-of-core streaming does not compose with a "
                             "sharded plan: shard first, then size "
                             "device_bytes for one rank")
    if tune != "off":
        from repro_torch.core import autotune
        tuned = autotune.tuned_plan(
            meta, rank, backend=backend,
            device=at.device if at is not None else device, at=at,
            require=tune == "force", objective=tune_objective,
            search=tune == "search",
            device_bytes=device_bytes if streaming_needed else None,
            search_budget_runs=search_budget,
            search_budget_s=search_seconds, search_seed=search_seed,
            store_path=store_path, oriented_only=oriented_only,
            shards=shards, group=group)
        if tuned is not None:
            return tuned
    modes = tuple(static_mode_plan(meta, n, rank,
                                   force_carry=streaming_needed,
                                   shards=shards)
                  for n in range(meta.enc.ndim))
    streaming = None
    if streaming_needed:
        cm = choose_chunk_m(meta, rank, device_bytes,
                            max(m.block_m for m in modes))
        streaming = StreamPlan(
            chunk_m=cm, n_chunks=chunk_count(meta, cm),
            device_bytes=device_bytes,
            stream_bytes=incore_working_set_bytes(meta, rank))
    return ExecutionPlan(meta=meta, rank=rank, backend=backend, modes=modes,
                         pi_policy=heuristics.choose_pi_policy(meta, rank),
                         streaming=streaming, shards=shards)


def plan_for(at: AltoTensor, rank: int, **kwargs) -> ExecutionPlan:
    """`make_plan` for a built tensor, the backend following its device;
    the tensor rides along (``at=``) so ``tune=`` can measure on it."""
    kwargs.setdefault("device", at.device)
    kwargs.setdefault("at", at)
    return make_plan(at.meta, rank, **kwargs)


def make_class_plan(sc, **kwargs) -> ExecutionPlan:
    """`make_plan` over a shape class's canonical meta
    (`core.shapeclass`): one plan, and under ``tune=`` one plan-store
    entry (`autotune.class_plan_key`), for every tenant the class admits.
    Every mode routes output-oriented (the canonical ``fiber_reuse`` is
    1.0), carry or one-hot by `heuristics.choose_oriented_variant`, and
    under ``tune=`` the tuner measures oriented candidates only: the
    batched drivers (`core.batched`) take oriented modes alone. A tensor
    given as ``at=`` must carry the canonical meta
    (`shapeclass.canonicalize_tensor`)."""
    from repro_torch.core import shapeclass
    return make_plan(shapeclass.canonical_meta(sc), sc.rank,
                     oriented_only=True, **kwargs)


def build_views(at: AltoTensor, plan: ExecutionPlan,
                route: str | None = None) -> dict:
    """Cached oriented views for exactly the modes the plan routes
    output-oriented (either variant), through `core.views`; host streams
    (`core.stream.HostStream`) in their place under a streaming plan; a
    view of every mode under a sharded plan. ``route`` picks the builder
    of a miss, ``"device"`` (`alto.oriented_view_device`) or ``"host"``
    (`alto.oriented_view`), default `views.default_route`; the two are
    bit-identical, so the cache ignores the route."""
    from repro_torch.core import views as views_mod
    return views_mod.build_views(at, plan, route=route)


def resident_bytes(at: AltoTensor,
                   views: dict[int, OrientedView] | None = None) -> int:
    """Device-resident bytes a decomposition holds: the padded words and
    values, the partition boxes, and each device view's rows, words,
    values and perm. A `core.stream.HostStream` lives in host memory and
    is skipped.

    `AltoTensor.storage_bytes` is the paper's Fig. 12 accounting (index
    and value words per real nonzero); this is the working set. The port
    stores words as int32 where the JAX package stores uint32: the same
    bytes, so the two counts are equal for the same tensor and plan."""
    from repro_torch.core.stream import HostStream

    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    total = (nbytes(at.words) + nbytes(at.values)
             + nbytes(at.part_start) + nbytes(at.part_end))
    for v in (views or {}).values():
        if isinstance(v, HostStream):
            continue
        total += (nbytes(v.rows) + nbytes(v.words) + nbytes(v.values)
                  + nbytes(v.perm))
    return total


# ---------------------------------------------------------------------------
# Plan-directed execution (the single entry point the drivers use)
# ---------------------------------------------------------------------------

def execute_mttkrp(plan: ExecutionPlan, at: AltoTensor,
                   views: dict[int, OrientedView] | None,
                   factors, mode: int, group=None) -> torch.Tensor:
    """MTTKRP for one mode through the plan's kernel choice. A mode the
    plan routes oriented but without a view falls back to the recursive
    traversal (same contract as `mttkrp_adaptive`). A streaming plan runs
    the chunked executor over the mode's host stream. A sharded plan runs
    this rank's slice and sums the ranks of ``group`` (default the world
    group; `dist.cpd.sharded_mttkrp`)."""
    faults.inject("plan.dispatch")
    if plan.shards is not None:
        from repro_torch.dist import cpd
        return cpd.sharded_mttkrp(plan, at, views, factors, mode,
                                  group=group)
    mp = plan.modes[mode]
    oriented = (heuristics.is_oriented(mp.traversal)
                and views is not None and mode in views)
    if plan.streaming is not None and oriented:
        if plan.backend == "cuda":
            return ops.mttkrp_oriented_chunked(
                views[mode], factors, chunk_m=plan.streaming.chunk_m,
                block_m=mp.block_m, r_block=mp.r_block, threads=mp.threads)
        return ops.mttkrp_oriented_chunked_reference(
            views[mode], factors, chunk_m=plan.streaming.chunk_m)
    if plan.backend == "cuda":
        kw = dict(r_block=mp.r_block, threads=mp.threads)
        if not oriented:
            return ops.mttkrp(at, factors, mode, **kw)
        if mp.traversal is heuristics.Traversal.ORIENTED_CARRY:
            return ops.mttkrp_oriented_carry(views[mode], factors,
                                             block_m=mp.block_m, **kw)
        return ops.mttkrp_oriented(views[mode], factors, block_m=mp.block_m,
                                   **kw)
    # reference backend: both oriented variants are one sorted segment sum.
    if oriented:
        return core_mttkrp.mttkrp_oriented(views[mode], factors)
    return core_mttkrp.mttkrp_recursive(at, factors, mode)


def execute_phi(plan: ExecutionPlan, at: AltoTensor,
                view: OrientedView | None, B: torch.Tensor, mode: int,
                factors=None, pi: torch.Tensor | None = None,
                eps: float = 1e-10, pre: bool | None = None,
                group=None) -> torch.Tensor:
    """CP-APR Φ row reduction for one mode through the plan's kernel
    choice. Pass ``pi`` (Π rows in the view's order for an oriented mode,
    in ALTO order for a recursive one: ALTO-PRE) or ``factors``
    (ALTO-OTF), exactly one. A mode routed oriented without a view runs
    recursive, as in `execute_mttkrp`.

    A streaming plan takes ``factors`` under both Π policies (a
    full-stream Π is the array streaming avoids; the chunked executor
    builds each chunk's Π rows on the device under ALTO-PRE): ``pre``
    then names the policy, the plan's by default. In-core routes ignore
    ``pre``. A sharded plan runs this rank's slice of the stream (and of
    ``pi``) and sums the ranks of ``group`` (`dist.cpd.sharded_phi`)."""
    faults.inject("plan.dispatch")
    if (pi is None) == (factors is None):
        raise ValueError("pass exactly one of pi= / factors=")
    if plan.shards is not None:
        from repro_torch.dist import cpd
        return cpd.sharded_phi(plan, at, view, B, mode, factors=factors,
                               pi=pi, eps=eps, group=group)
    mp = plan.modes[mode]
    oriented = heuristics.is_oriented(mp.traversal) and view is not None
    if plan.streaming is not None and oriented:
        if factors is None:
            raise ValueError("streaming Φ needs factors= — chunk Π rows are "
                             "built on the device per chunk, never passed "
                             "as a full-stream pi=")
        pre_flag = (pre if pre is not None
                    else plan.pi_policy is heuristics.PiPolicy.PRE)
        if plan.backend == "cuda":
            return ops.cpapr_phi_oriented_chunked(
                view, B, factors, pre=pre_flag, eps=eps,
                chunk_m=plan.streaming.chunk_m, block_m=mp.block_m,
                threads=mp.threads)
        return ops.cpapr_phi_oriented_chunked_reference(
            view, B, factors, pre=pre_flag, eps=eps,
            chunk_m=plan.streaming.chunk_m)
    if plan.backend == "cuda":
        if not oriented:
            return ops.cpapr_phi(at, B, mode, factors=factors, pi=pi,
                                 eps=eps, threads=mp.threads)
        fn = (ops.cpapr_phi_oriented_carry
              if mp.traversal is heuristics.Traversal.ORIENTED_CARRY
              else ops.cpapr_phi_oriented)
        return fn(view, B, factors=factors, pi=pi, eps=eps,
                  block_m=mp.block_m, threads=mp.threads)
    # reference backend: the plain traversals of core.mttkrp.
    src = view if oriented else at
    contrib = core_mttkrp.phi_contributions(
        plan.meta.enc, mode, src.words, src.values,
        view.rows if oriented else None, B, factors=factors, pi=pi, eps=eps)
    if oriented:
        return core_mttkrp.row_reduce_oriented(view, contrib)
    return core_mttkrp.row_reduce_recursive(at, mode, contrib)
