"""CP-ALS on ALTO tensors (paper Alg. 1), in PyTorch.

The MTTKRP bottleneck (line 11) runs through the plan layer
(`core.plan.execute_mttkrp`): on the card the hand-written kernels, on
the CPU their plain versions or the reference traversals. Gram matrices,
the pseudo-inverse solve and the normalization are dense torch ops; the
sweep runs eagerly and the outer iteration is a host loop with fit-based
early stopping.

The dense algebra runs in full float32: `cp_als` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (process-wide) before
its first sweep, since TF32 keeps about three decimal digits.

Fit tracking: the sweep returns the MTTKRP of its *last* mode update, the
one matrix for which ``<X, X̂> = Σ_r λ_r <A_n[:,r], M[:,r]>`` holds
exactly. The residual identity ``||X-X̂||² = ||X||² + ||X̂||² − 2<X,X̂>``
is then evaluated in float64 on the tensor's device, where its
cancellation is harmless; only the fit itself is copied back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import faults
from repro_torch.core import health as health_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.mttkrp import mttkrp_adaptive
from repro_torch.device import resolve_device


@dataclasses.dataclass
class CpalsResult:
    lam: torch.Tensor                # (R,) component weights
    factors: list[torch.Tensor]      # per-mode (I_n, R)
    fits: list[float]                # fit per iteration
    n_iters: int
    plan: plan_mod.ExecutionPlan | None = None
    health: health_mod.HealthReport | None = None   # guard=True only


def init_factors(dims: Sequence[int], rank: int, seed: int = 0,
                 dtype=torch.float32, device=None) -> list[torch.Tensor]:
    """Uniform [0, 1) factors from a `torch.Generator` seeded with
    ``seed`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.rand((I, rank), generator=g, dtype=dtype, device=dev)
            for I in dims]


def build_views(at: AltoTensor,
                plan: plan_mod.ExecutionPlan | None = None
                ) -> dict[int, OrientedView]:
    """Oriented views only for modes the plan routes that way, from the
    view cache (`core.views`)."""
    if plan is None:
        plan = plan_mod.plan_for(at, rank=1)  # traversal is rank-free
    return plan_mod.build_views(at, plan)


def _gram(A: torch.Tensor) -> torch.Tensor:
    return A.T @ A


def _update_factor(M, grams, n: int):
    """Mode ``n``'s new factor from its MTTKRP ``M`` (Alg. 1 lines 12-13)
    -> (A, λ): ``M V⁺``, V the Hadamard product of the other modes' Grams
    in mode order, then each column divided by its 2-norm (a zero norm
    counts as 1). `_sweep` calls it for one tensor, `core.batched` for
    each slot of a bucket."""
    V = None
    for m, G in enumerate(grams):
        if m != n:
            V = G if V is None else V * G
    with trace.span("read.pinv"):
        # On CUDA the pseudo-inverse synchronises (twice a call).
        V_inv = torch.linalg.pinv(V)
    A = M @ V_inv
    lam = torch.linalg.vector_norm(A, dim=0)
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    return A / lam[None, :], lam


def _sweep(plan, at: AltoTensor, views, factors, lam, gram_fn=None,
           group=None):
    """One CP-ALS sweep over all modes -> (factors, lam, M_last); M_last
    is the final mode's MTTKRP, the one consistent with the returned
    factors.

    ``gram_fn`` computes the Gram matrices (default ``A.T @ A``): the
    distributed driver passes `dist.cpd.sharded_gram`. A sharded plan
    routes the MTTKRP over the ranks of ``group`` itself."""
    gram = gram_fn or _gram
    factors = list(factors)
    grams = [gram(A) for A in factors]
    M = None
    for n in range(len(factors)):
        M = mttkrp_adaptive(at, views, factors, n, plan=plan,
                            group=group)                     # (I_n, R)
        factors[n], lam = _update_factor(M, grams, n)
        grams[n] = gram(factors[n])
    return factors, lam, M


def _fit(M_last, factors, lam, normX2: float) -> float:
    """Kolda–Bader fit from sweep-consistent state, in float64 on the
    factors' device; the fit is the one value copied back."""
    fit = _fit_tensor(M_last, factors, lam, normX2)
    with trace.span("read.fit"):
        return float(fit)


def _fit_tensor(M_last, factors, lam, normX2: float) -> torch.Tensor:
    """`_fit` as a 0-d float64 tensor on the factors' device, not yet
    copied back (the batched driver copies a bucket's fits at once)."""
    with trace.span("cpals.fit"):
        if normX2 == 0.0:
            return torch.ones((), dtype=torch.float64, device=lam.device)
        lam64 = lam.double()
        inner = ((factors[-1].double() * M_last.double()).sum(dim=0)
                 * lam64).sum()
        V = None
        for A in factors:
            A64 = A.double()
            gram = A64.T @ A64
            V = gram if V is None else V * gram
        norm_model2 = (torch.outer(lam64, lam64) * V).sum()
        resid2 = (normX2 + norm_model2 - 2.0 * inner).clamp_min(0.0)
        return 1.0 - resid2.sqrt() / math.sqrt(normX2)


def cp_als(at: AltoTensor, rank: int, n_iters: int = 50, tol: float = 1e-5,
           seed: int = 0, views: dict[int, OrientedView] | None = None,
           factors: list[torch.Tensor] | None = None,
           plan: plan_mod.ExecutionPlan | None = None,
           tune: str = "off", warm_start=None, guard: bool = False,
           guard_slack: float = 1e-3, gram_fn=None,
           group=None) -> CpalsResult:
    """CP-ALS driver on the tensor's device. ``factors`` seeds the
    iteration (default `init_factors` with ``seed``); ``plan`` defaults to
    `plan.plan_for` (kernels on CUDA, reference traversals on the CPU),
    with ``tune`` (`plan.make_plan`) measuring MTTKRP on this tensor.

    ``warm_start`` starts from a previous solve instead — a `CpalsResult`,
    ``(lam, factors)`` or a factor list — with the rows of extents grown
    since (`ingest.append_delta`) drawn from `init_factors` with ``seed``
    (`ingest.grow_factors`) and λ folded into the first factor, so the
    first sweep starts at the previous model.

    ``guard=True`` runs the health guards after each sweep
    (`core.health`): the fit must be finite and at least
    `health.FIT_FLOOR`, the factors, λ and the last MTTKRP finite, and
    the fit may not drop by more than ``guard_slack``. On a violation the
    result is the last good ``(factors, λ)`` and the solve stops;
    `CpalsResult.health` says why. On finite inputs the guard changes no
    bit.

    Under a sharded plan (`plan.make_plan(shards=)`) every MTTKRP sums
    the ranks of ``group`` (default the world group) and ``gram_fn``
    replaces ``A.T @ A`` (`dist.cpd.distributed_cp_als` passes
    `dist.cpd.sharded_gram`); the factors are replicated, so every rank
    computes the same fit."""
    resolve_device(at.device)
    if factors is not None and warm_start is not None:
        raise ValueError("pass factors= or warm_start=, not both")
    if warm_start is not None:
        from repro_torch.core import ingest
        lam_w, factors = ingest.grow_factors(
            warm_start, at.dims, rank, seed=seed, dtype=at.values.dtype,
            device=at.device)
        if lam_w is not None:
            factors[0] = factors[0] * lam_w[None, :]
    torch.backends.cuda.matmul.allow_tf32 = False
    if plan is None:
        plan = plan_mod.plan_for(at, rank, tune=tune)
    elif plan.rank != rank:
        raise ValueError(f"plan was built for rank {plan.rank}, "
                         f"cp_als called with rank {rank}")
    dtype = at.values.dtype
    if at.meta.nnz == 0:
        # The zero model is the exact decomposition of an empty tensor.
        return CpalsResult(
            lam=torch.zeros((rank,), dtype=dtype, device=at.device),
            factors=[torch.zeros((I, rank), dtype=dtype, device=at.device)
                     for I in at.dims],
            fits=[1.0], n_iters=0, plan=plan)
    if factors is None:
        factors = init_factors(at.dims, rank, seed=seed, dtype=dtype,
                               device=at.device)
    factors = [f.to(device=at.device, dtype=dtype).contiguous()
               for f in factors]
    if views is None:
        views = plan_mod.build_views(at, plan)
    lam = torch.ones((rank,), dtype=dtype, device=at.device)
    normX2_t = (at.values.detach().double() ** 2).sum()
    with trace.span("read.norm"):
        normX2 = float(normX2_t)
    report = health_mod.HealthReport() if guard else None
    fits: list[float] = []
    prev_fit = -np.inf
    it = 0
    for it in range(1, n_iters + 1):
        good = (factors, lam)
        factors, lam, M_last = _sweep(plan, at, views, factors, lam,
                                      gram_fn, group)
        pd = faults.fire("cpals.nan")
        if pd is not None:
            # Poison the last factor: the next sweep's first mode update
            # reads it through the Gram products.
            factors[-1] = factors[-1].clone()
            factors[-1][0, 0] = pd.get("value", float("nan"))
        fit = _fit(M_last, factors, lam, normX2)
        if guard:
            reason = _violation(fit, fits, [*factors, lam, M_last], it,
                                guard_slack)
            report.checks += 1
            if reason is not None:
                report.violations += 1
                report.rolled_back = True
                report.reason = reason
                factors, lam = good
                it -= 1
                break
        fits.append(fit)
        if abs(fit - prev_fit) < tol:
            break
        prev_fit = fit
    return CpalsResult(lam=lam, factors=list(factors), fits=fits,
                       n_iters=it, plan=plan, health=report)


def _violation(fit: float, fits: list[float], tensors, it: int,
               slack: float) -> str | None:
    """The fit guard's verdict on one sweep, None when it passes."""
    if not math.isfinite(fit) or not health_mod.all_finite(tensors):
        return f"non-finite sweep output at iteration {it}"
    if fit < health_mod.FIT_FLOOR:
        # Huge but finite: stopped here, before the next sweep's Grams
        # overflow (health.FIT_FLOOR).
        return f"fit diverged to {fit:.3e} at iteration {it}"
    if fits and fit < fits[-1] - slack:
        return f"fit regressed {fits[-1]:.6f} -> {fit:.6f} at iteration {it}"
    return None


def reconstruct_values(coords: torch.Tensor, lam: torch.Tensor,
                       factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Model values at given coordinates (for residual checks)."""
    out = lam[None, :].to(factors[0].dtype).expand(coords.shape[0], -1)
    for m, A in enumerate(factors):
        out = out * A[coords[:, m].long()]
    return out.sum(dim=-1)
