"""CP-APR multiplicative updates on ALTO tensors (paper Alg. 2 / Alg. 5),
in PyTorch.

Poisson tensor decomposition for non-negative count data. The Φ (model
update) row reduction — more than 99 % of the runtime per the paper §5.3 —
runs through the plan layer (`core.plan.execute_phi`): on the card the
hand-written Φ kernels, on the CPU their plain versions or the reference
traversals. The plan carries the paper's two adaptive choices:

  * traversal per mode: recursive (Temp + pull reduction) or
    output-oriented (carry or partials), per fiber reuse (§4.2);
  * Π policy: ALTO-PRE (the (M, R) Khatri-Rao rows built once per mode
    update by one kernel that decodes, gathers and multiplies,
    `ops.pi_rows`) or ALTO-OTF (rebuilt inside the Φ kernel on every
    inner iteration), per the memory heuristic (§4.3).

The inner multiplicative-update loop (Alg. 2 lines 7-14) is a host loop
that reads the KKT violation of each step and stops once it is below
``tau``: the semantics of the JAX package's masked ``lax.scan``, whose
frozen steps only recompute the Φ of an unchanged B. Each inner step
therefore waits for the card once (the ``repro.read.kkt`` span of
`repro_torch.trace`).

A streaming plan (`core.plan.StreamPlan`) runs the same loop; its Φ is
the chunked executor over host streams, which takes the factors under
both Π policies and builds each chunk's Π rows itself under ALTO-PRE, so
no full-stream Π is built. The log-likelihood still decodes the
card-resident ALTO tensor: only the oriented copies stream.

A sharded plan (`core.plan.make_plan(shards=)`) routes Φ through
`execute_phi` to `dist.cpd.sharded_phi` over the ranks of ``group``: each
rank reduces its slice of the row-sorted stream, the ALTO-PRE Π rows cut
with it. λ, the factors, the KKT violations and the log-likelihood are
replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import faults, heuristics
from repro_torch.core import health as health_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class CpaprParams:
    """Algorithmic parameters of Alg. 2 (defaults follow the paper / ttb)."""
    k_max: int = 50          # max outer iterations
    l_max: int = 10          # max inner iterations (paper uses 10)
    tau: float = 1e-4        # KKT convergence tolerance
    kappa: float = 1e-2      # inadmissible-zero avoidance adjustment
    kappa_tol: float = 1e-10  # potential inadmissible zero threshold
    eps_div: float = 1e-10   # minimum divisor


@dataclasses.dataclass
class CpaprResult:
    lam: torch.Tensor
    factors: list[torch.Tensor]
    kkt_violations: list[float]    # per outer iteration (max over modes)
    log_likelihoods: list[float]
    n_outer: int
    n_inner_total: int
    pi_policy: str
    traversals: list[str]
    plan: plan_mod.ExecutionPlan | None = None
    health: health_mod.HealthReport | None = None   # guard=True only


def init_factors(dims: Sequence[int], rank: int, seed: int = 0,
                 total: float = 1.0, dtype=torch.float32, device=None):
    """Random positive factors, uniform in [0.1, 1.1) from a
    `torch.Generator` seeded with ``seed`` on ``device`` (default
    ``cuda``), columns 1-normalized; λ = total / rank carries the mass.
    Returns ``(lam, factors)``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    factors = []
    for I in dims:
        A = torch.rand((I, rank), generator=g, dtype=dtype, device=dev) + 0.1
        factors.append(A / A.sum(dim=0, keepdim=True))
    lam = torch.full((rank,), total / rank, dtype=dtype, device=dev)
    return lam, factors


def _starting_factors(factors, dims, rank, dtype, device):
    """Given factors as the exact start, checked and placed."""
    if len(factors) != len(dims):
        raise ValueError(f"{len(factors)} factors for {len(dims)} modes")
    out = []
    for n, (A, I) in enumerate(zip(factors, dims)):
        A = torch.as_tensor(A).to(device=device, dtype=dtype)
        if tuple(A.shape) != (I, rank):
            raise ValueError(f"factor {n} has shape {tuple(A.shape)}; "
                             f"expected {(I, rank)}")
        out.append(A.contiguous())
    return out


def _shifted(A, lam, phi_prev, first_outer: bool, p: CpaprParams):
    """Alg. 2 lines 4-5: B = (A + S)Λ, S the inadmissible-zero shift (κ
    where A < κ_tol and the previous Φ exceeds 1; none on the first outer
    iteration). λ scales the last axis, so one tensor's ``(I, R)`` with
    ``(R,)`` and a bucket's ``(T, I, R)`` with ``(T, R)`` take the same
    expression."""
    if first_outer:
        S = torch.zeros_like(A)
    else:
        with trace.span("read.kappa"):
            # A scalar copied to the device from pageable host memory
            # waits for the device, twice a mode update.
            kappa, zero = A.new_tensor(p.kappa), A.new_tensor(0.0)
        S = torch.where((A < p.kappa_tol) & (phi_prev > 1.0), kappa, zero)
    return (A + S) * lam.unsqueeze(-2)


def _kkt(B, Phi) -> torch.Tensor:
    """Alg. 2 line 9: the KKT violation max |min(B, 1 − Φ)|, a 0-d tensor
    for one tensor, ``(T,)`` for a bucket's slots. A max is exact, so
    every slot gets the value of its own reduction."""
    return torch.minimum(B, 1.0 - Phi).abs().amax(dim=(-2, -1))


def _normalized(B):
    """Alg. 2 line 15 on one ``(I, R)`` B -> (A, λ): λ = eᵀB (a zero
    column sum counts as 1), A = BΛ⁻¹."""
    lam = B.sum(dim=0)
    lam = torch.where(lam > 0, lam, torch.ones_like(lam))
    return B / lam[None, :], lam


def _pi(plan: plan_mod.ExecutionPlan, at: AltoTensor | None,
        view: OrientedView | None, factors, mode: int) -> torch.Tensor:
    """Alg. 2 line 6 under ALTO-PRE: Π's rows (`ops.pi_rows`) in the
    element order the plan's traversal consumes: the view's for an
    oriented mode, ALTO order for a recursive one. A bucket passes its
    stacked tensor, view and factors and gets ``(T, M, R)``."""
    oriented = (view is not None
                and heuristics.is_oriented(plan.modes[mode].traversal))
    src = view if oriented else at
    with trace.span("cpapr.pi_build"):
        return ops.pi_rows(src.meta.enc, src.words, factors, mode)


def _mode_update(plan: plan_mod.ExecutionPlan, at: AltoTensor,
                 view: OrientedView | None, mode: int, lam, factors,
                 phi_prev, first_outer: bool, pre_pi: bool, p: CpaprParams,
                 group=None):
    """One full Alg. 2 mode update (lines 4-15). Returns (A, λ, Φ of the
    final B, converged, inner steps taken, KKT of the first step)."""
    B = _shifted(factors[mode], lam, phi_prev, first_outer, p)
    streamed = (plan.streaming is not None and view is not None
                and heuristics.is_oriented(plan.modes[mode].traversal))
    if streamed:
        operands = dict(factors=factors, pre=pre_pi)
    elif pre_pi:
        operands = dict(pi=_pi(plan, at, view, factors, mode))
    else:
        operands = dict(factors=factors)
    tau = float(np.float32(p.tau))     # the float32 comparison of the scan

    Phi = None
    kkt_first = None
    n_inner = 0
    for _ in range(p.l_max):
        Phi = plan_mod.execute_phi(plan, at, view, B, mode, eps=p.eps_div,
                                   group=group, **operands)  # line 8
        kkt_t = _kkt(B, Phi)                                 # line 9
        with trace.span("read.kkt"):
            kkt = kkt_t.item()
        if kkt_first is None:
            kkt_first = kkt
        if kkt < tau:
            break            # frozen: further steps recompute this Φ
        B = B * Phi                                          # line 13
        n_inner += 1

    A_new, lam_new = _normalized(B)                   # line 15: λ = eᵀB
    return A_new, lam_new, Phi, n_inner == 0, n_inner, kkt_first


def log_likelihood(at: AltoTensor, lam, factors,
                   eps: float = 1e-10) -> torch.Tensor:
    """Poisson log-likelihood Σ x·log(m) − Σ m (columns 1-normalized), as
    a 0-d tensor on the tensor's device; the decode goes through K4."""
    coords = ops.delinearize(at.meta.enc, at.words)
    prod = lam[None, :].expand(coords.shape[0], -1)
    for m, A in enumerate(factors):
        prod = prod * A[coords[:, m].long()]
    model = prod.sum(dim=-1).clamp_min(eps)
    ll = (at.values * torch.log(model)).sum()         # padding: v = 0
    return ll - lam.sum()


def cp_apr(at: AltoTensor, rank: int, params: CpaprParams | None = None,
           seed: int = 0, pi_policy: str | None = None,
           views: dict[int, OrientedView] | None = None,
           track_ll: bool = False,
           plan: plan_mod.ExecutionPlan | None = None,
           factors: list[torch.Tensor] | None = None,
           lam: torch.Tensor | None = None,
           tune: str = "off", warm_start=None,
           guard: bool = False, group=None) -> CpaprResult:
    """CP-APR MU driver (Alg. 2) on the tensor's device. ``pi_policy``:
    None (the plan's) | ``"pre"`` | ``"otf"``.

    ``factors`` and ``lam`` give the exact starting state (λ defaults to
    Σx / rank; a bucket's tenant starts so, `core.batched`); without them
    it is `init_factors` with ``seed``. ``warm_start`` starts from a
    previous solve — a `CpaprResult`, ``(lam, factors)`` or a factor list
    — clamped positive, columns rescaled to sum 1, the rows of extents
    grown since filled small and positive (`ingest.grow_factors(positive=
    True)`), the JAX package's warm start. ``plan`` defaults to
    `plan.plan_for` (kernels on CUDA, reference traversals on the CPU),
    with ``tune`` (`plan.make_plan`) measuring Φ on this tensor; oriented
    views come from the view cache (`core.views`).

    ``guard=True`` checks after each outer iteration that λ, the factors
    and the KKT violation are finite (`core.health`); on a violation the
    result is the state before that iteration and the solve stops
    (`CpaprResult.health`). On finite inputs it changes no bit.

    Under a sharded plan Φ sums the ranks of ``group`` (default the world
    group)."""
    resolve_device(at.device)
    p = params or CpaprParams()
    if pi_policy not in (None, "pre", "otf"):
        raise ValueError(f"unknown pi_policy {pi_policy!r}")
    N = len(at.dims)
    dtype = at.values.dtype
    if at.meta.nnz == 0:
        # The zero model maximizes the Poisson likelihood of an all-zero
        # tensor (λ → 0): a converged result instead of NaN iterations.
        return CpaprResult(
            lam=torch.zeros((rank,), dtype=dtype, device=at.device),
            factors=[torch.zeros((I, rank), dtype=dtype, device=at.device)
                     for I in at.dims],
            kkt_violations=[0.0], log_likelihoods=[], n_outer=0,
            n_inner_total=0, pi_policy=pi_policy or "otf",
            traversals=["oriented"] * N, plan=plan)
    if plan is None:
        plan = plan_mod.plan_for(at, rank, tune=tune, tune_objective="phi")
    elif plan.rank != rank:
        raise ValueError(f"plan was built for rank {plan.rank}, "
                         f"cp_apr called with rank {rank}")
    total_t = at.values.sum()
    with trace.span("read.total"):
        total = float(total_t)
    if warm_start is not None:
        if factors is not None or lam is not None:
            raise ValueError("pass factors=/lam= or warm_start=, not both")
        from repro_torch.core import ingest
        lam, factors = ingest.grow_factors(
            warm_start, at.dims, rank, seed=seed, dtype=dtype,
            device=at.device, positive=True)
    if factors is None:
        lam0, factors = init_factors(at.dims, rank, seed=seed, total=total,
                                     dtype=dtype, device=at.device)
        lam = lam0 if lam is None else lam
    else:
        factors = _starting_factors(factors, at.dims, rank, dtype,
                                    at.device)
    if lam is None:
        lam = torch.full((rank,), total / rank, dtype=dtype,
                         device=at.device)
    lam = torch.as_tensor(lam).to(device=at.device, dtype=dtype)
    if pi_policy is None:
        pi_policy = plan.pi_policy.value
    pre_pi = pi_policy == "pre"

    if views is None:
        views = plan_mod.build_views(at, plan)
    traversals = [plan.modes[n].traversal.value
                  if (n in views
                      and heuristics.is_oriented(plan.modes[n].traversal))
                  else "recursive" for n in range(N)]

    phi_prev = [torch.zeros_like(A) for A in factors]
    report = health_mod.HealthReport() if guard else None
    kkt_hist: list[float] = []
    ll_hist: list[float] = []
    n_inner_total = 0
    outer = 0
    for outer in range(1, p.k_max + 1):
        good = (lam, list(factors), list(phi_prev))
        all_converged = True
        kkt_max = 0.0
        for n in range(N):
            A, lam, phi_prev[n], conv, n_inner, kkt = _mode_update(
                plan, at, views.get(n), n, lam, factors, phi_prev[n],
                first_outer=(outer == 1), pre_pi=pre_pi, p=p, group=group)
            pd = faults.fire("cpapr.nan")
            if pd is not None:
                A = A.clone()
                A[0, 0] = pd.get("value", float("nan"))
            factors = list(factors)
            factors[n] = A
            n_inner_total += n_inner
            all_converged &= conv
            kkt_max = max(kkt_max, kkt)
        if guard:
            report.checks += 1
            if not np.isfinite(kkt_max) or not health_mod.all_finite(
                    [lam, *factors]):
                report.violations += 1
                report.rolled_back = True
                report.reason = (f"non-finite mode update at outer "
                                 f"iteration {outer}")
                lam, factors, phi_prev = good
                outer -= 1
                break
        kkt_hist.append(kkt_max)
        if track_ll:
            ll_hist.append(float(log_likelihood(at, lam, factors)))
        if all_converged:                              # lines 17-19
            break
    return CpaprResult(lam=lam, factors=factors, kkt_violations=kkt_hist,
                       log_likelihoods=ll_hist, n_outer=outer,
                       n_inner_total=n_inner_total, pi_policy=pi_policy,
                       traversals=traversals, plan=plan, health=report)
