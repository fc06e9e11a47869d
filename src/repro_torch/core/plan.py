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
    (`heuristics.choose_pi_policy`, paper §4.3).

The Hopper model. In every kernel a thread owns one rank column of one
slice of the stream (a ``block_m`` slice, or an ALTO partition for the
recursive kernel) and walks it in order; factor rows are gathered from
device memory and the output lives in device memory. So no kernel keeps
a tile resident, shared memory per CTA is zero, and the carry variant —
whose whole output stayed in the TPU's VMEM — has no resident-output
gate here: on hyper-sparse long modes the port picks carry where the
JAX package's VMEM gate forces the one-hot variant.

  * ``r_block``: the largest divisor of the rank up to `MAX_R_BLOCK`
    (one thread per rank column; larger ranks split into rank tiles);
  * threads per CTA: ``r_block`` times the slices a CTA holds, about
    `THREADS_PER_CTA`;
  * ``block_m``: the largest power of two in [`MIN_BLOCK_M`,
    `MAX_BLOCK_M`] that still leaves `TARGET_WAVES` waves of slices on
    the card's `SMS` multiprocessors — a slice is walked serially, so
    the card needs many of them in flight.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import heuristics
from repro_torch.core import mttkrp as core_mttkrp
from repro_torch.core.alto import AltoMeta, AltoTensor, OrientedView
from repro_torch.kernels import ops

SMS = 132                    # H100 SXM multiprocessors
MAX_THREADS_PER_SM = 2048
THREADS_PER_CTA = 128
MAX_R_BLOCK = 128
MIN_BLOCK_M = 8
MAX_BLOCK_M = 1024
TARGET_WAVES = 4
BACKENDS = ("cuda", "reference")


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
class ExecutionPlan:
    """Static per-(tensor, rank) kernel routing, hashable."""
    meta: AltoMeta
    rank: int
    backend: str                       # "cuda" | "reference"
    modes: tuple[ModePlan, ...]
    pi_policy: heuristics.PiPolicy = heuristics.PiPolicy.OTF   # CP-APR

    def mode_plan(self, mode: int) -> ModePlan:
        return self.modes[mode]

    def traversals(self) -> tuple[str, ...]:
        return tuple(m.traversal.value for m in self.modes)


# ---------------------------------------------------------------------------
# Hopper model
# ---------------------------------------------------------------------------

def choose_rank_block(rank: int) -> int:
    """Largest divisor of ``rank`` up to `MAX_R_BLOCK`."""
    return max(d for d in range(1, min(rank, MAX_R_BLOCK) + 1)
               if rank % d == 0)


def cta_threads(r_block: int) -> int:
    """Threads per CTA: whole slices of ``r_block`` threads, about
    `THREADS_PER_CTA` in all."""
    return r_block * max(1, THREADS_PER_CTA // r_block)


def choose_block_m(meta: AltoMeta, r_block: int) -> int:
    """Largest power-of-two slice that leaves `TARGET_WAVES` waves of
    slices on the card (`MIN_BLOCK_M` for short streams)."""
    resident = SMS * (MAX_THREADS_PER_SM // r_block)
    bm = MAX_BLOCK_M
    while (bm > MIN_BLOCK_M
           and heuristics.stream_len(meta) < TARGET_WAVES * resident * bm):
        bm //= 2
    return bm


def static_mode_plan(meta: AltoMeta, mode: int, rank: int) -> ModePlan:
    """The analytic-model choice for one mode (float32 traffic: the
    kernels take float32 only)."""
    traversal = heuristics.choose_traversal(meta, mode)
    if heuristics.is_oriented(traversal):
        traversal = heuristics.choose_oriented_variant(meta, mode, rank,
                                                       dtype_bytes=4)
    rb = choose_rank_block(rank)
    return ModePlan(mode=mode, traversal=traversal, r_block=rb,
                    block_m=choose_block_m(meta, rb),
                    temp_rows=meta.temp_rows[mode], threads=cta_threads(rb))


def default_backend(device=None) -> str:
    """The hand-written kernels for CUDA (the default device), the plain
    reference traversals for the CPU."""
    return "cuda" if torch.device(device or "cuda").type == "cuda" \
        else "reference"


def make_plan(meta: AltoMeta, rank: int, *, backend: str | None = None,
              device=None) -> ExecutionPlan:
    """Resolve heuristics + static meta into a concrete execution plan.
    ``backend`` defaults from ``device`` (`default_backend`)."""
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    modes = tuple(static_mode_plan(meta, n, rank)
                  for n in range(meta.enc.ndim))
    return ExecutionPlan(meta=meta, rank=rank, backend=backend, modes=modes,
                         pi_policy=heuristics.choose_pi_policy(meta, rank))


def plan_for(at: AltoTensor, rank: int, **kwargs) -> ExecutionPlan:
    """`make_plan` for a built tensor, the backend following its device."""
    kwargs.setdefault("device", at.device)
    return make_plan(at.meta, rank, **kwargs)


def build_views(at: AltoTensor,
                plan: ExecutionPlan) -> dict[int, OrientedView]:
    """Cached oriented views for exactly the modes the plan routes
    output-oriented (either variant), through `core.views`."""
    from repro_torch.core import views as views_mod
    return views_mod.build_views(at, plan)


# ---------------------------------------------------------------------------
# Plan-directed execution (the single entry point the drivers use)
# ---------------------------------------------------------------------------

def execute_mttkrp(plan: ExecutionPlan, at: AltoTensor,
                   views: dict[int, OrientedView] | None,
                   factors, mode: int) -> torch.Tensor:
    """MTTKRP for one mode through the plan's kernel choice. A mode the
    plan routes oriented but without a view falls back to the recursive
    traversal (same contract as `mttkrp_adaptive`)."""
    mp = plan.modes[mode]
    oriented = (heuristics.is_oriented(mp.traversal)
                and views is not None and mode in views)
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
                eps: float = 1e-10) -> torch.Tensor:
    """CP-APR Φ row reduction for one mode through the plan's kernel
    choice. Pass ``pi`` (Π rows in the view's order for an oriented mode,
    in ALTO order for a recursive one: ALTO-PRE) or ``factors``
    (ALTO-OTF), exactly one. A mode routed oriented without a view runs
    recursive, as in `execute_mttkrp`."""
    if (pi is None) == (factors is None):
        raise ValueError("pass exactly one of pi= / factors=")
    mp = plan.modes[mode]
    oriented = heuristics.is_oriented(mp.traversal) and view is not None
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
