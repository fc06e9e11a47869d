"""Batched CP-ALS / CP-APR: a bucket of same-class tenants per launch.

Tenants that `shapeclass.classify` buckets together share an encoding, a
padded stream length and the canonical `AltoMeta`, so their ALTO streams,
oriented views and factors stack along a leading tenant axis
(`stack_tenants`). The JAX package runs its single-tensor sweeps under
``vmap``; the port writes the batch dimension out: every in-core kernel
takes the tenant axis, the oriented ones (`kernels.mttkrp_oriented`), the
recursive ones with their pull (`kernels.mttkrp`, `kernels.cpapr_phi`,
`ops.pull_reduction`) and ALTO-PRE's Π build (`kernels.delinearize.
pi_rows`), so one launch per kernel and mode serves the whole bucket,
whatever its size and whatever the class plan routes, and each tenant
gets the bits of its solo launch. A streaming plan is refused: a bucket
runs in core.

The dense algebra is the solo drivers' own functions, so a bucket keeps
the solo bits by construction: CP-ALS's solve and normalisation
(`cpals._update_factor`) and Gram matrices, CP-APR's λ and normalised
factor (`cpapr._normalized`) and the float64 fit run slot by slot, since
a batched GEMM, pseudo-inverse or column sum is not promised the bits of
the unbatched call; CP-APR's shifted B (`cpapr._shifted`), KKT violation
(`cpapr._kkt`, one max a slot) and ALTO-PRE Π (`cpapr._pi`, `ops.pi_rows`
on the tenant axis) take the stacked tensors whole. What leaves the card
is one copy per sweep (CP-ALS: every active slot's fit) or per inner
step (CP-APR: every slot's KKT violation).

Per-tenant convergence: a converged tenant keeps its slot (its mates need
the stacked shapes) and freezes: each update is computed for every slot
and applied through ``torch.where(active, new, old)``, so a frozen slot's
factors, λ and (CP-APR) Φ memory keep their bits while the others sweep.
Within a CP-APR mode update the inner loop runs while any active slot is
not done; a done slot's B is frozen the same way, and its Φ, recomputed
from the same B, keeps its bits.

Exactness of bucketing: each tenant enters with its solo start embedded
in the class dims (`embed_factors`: the extra rows are zeros). Padded
elements carry value 0 and padded factor rows receive no contributions,
so the bucket's trajectory is the solo trajectory on the padded tensor,
zeros appended; the answer is sliced back to the tenant's dims.

Quarantine (``guard=True``, `core.health`): after each sweep (CP-ALS) or
mode update (CP-APR) a per-slot finite mask, and for CP-ALS the fit
floor, flag a poisoned slot; it rolls back to its state before the sweep
(outer iteration) and freezes through the same ``torch.where`` as a
converged slot, so its mates keep their bits and it costs the bucket at
most the update that poisoned it. Fault sites: ``batched.sweep`` before
each sweep (outer iteration), ``batched.nan`` after each sweep (mode
update), poisoning one slot.

Short buckets are filled to ``capacity`` with inactive replicas of slot
0, so every bucket of a class has one shape and launches the same
kernels. `sweep_traces` counts the batched set-ups (one per algorithm and
class plan, and per mode update for CP-APR), the port's counterpart of
the JAX package's jit traces: a class costs a few, never one per tenant.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cpals, cpapr, faults, heuristics
from repro_torch.core import health as health_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import views as views_mod
from repro_torch.core.alto import AltoTensor, OrientedView

_SWEEP_KEYS: set = set()
_SWEEP_TRACES = {"als": 0, "apr": 0}
_SWEEP_LOCK = threading.Lock()


def sweep_traces() -> dict[str, int]:
    """Batched set-ups per algorithm: distinct (algorithm, class plan)
    keys, and for CP-APR (plan, mode, first outer iteration, Π policy,
    parameters), the batched drivers have run."""
    with _SWEEP_LOCK:
        return dict(_SWEEP_TRACES)


def sweep_cache_clear() -> None:
    with _SWEEP_LOCK:
        _SWEEP_KEYS.clear()
        _SWEEP_TRACES["als"] = 0
        _SWEEP_TRACES["apr"] = 0


def _note_sweep(key: tuple) -> None:
    with _SWEEP_LOCK:
        if key not in _SWEEP_KEYS:
            _SWEEP_KEYS.add(key)
            _SWEEP_TRACES[key[0]] += 1


def stack_tenants(items: Sequence):
    """Stack same-class members along a new leading tenant axis: tensors,
    lists and tuples of them, dicts of them (one tenant's views),
    `OrientedView` and `AltoTensor` (which must share their meta, as the
    canonicalized members of a class do)."""
    items = list(items)
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, (list, tuple)):
        return [stack_tenants([it[k] for it in items])
                for k in range(len(first))]
    if isinstance(first, dict):
        return {k: stack_tenants([it[k] for it in items]) for k in first}
    if isinstance(first, (OrientedView, AltoTensor)):
        if any(it.meta != first.meta for it in items):
            raise ValueError("tenants differ in meta: canonicalize "
                             "(shapeclass.canonicalize_tensor) first")
        fields = [f.name for f in dataclasses.fields(first)
                  if isinstance(getattr(first, f.name), torch.Tensor)]
        return dataclasses.replace(first, **{
            f: torch.stack([getattr(it, f) for it in items])
            for f in fields})
    raise TypeError(f"cannot stack {type(first).__name__}")


def embed_factors(factors: Sequence[torch.Tensor],
                  class_dims: Sequence[int]) -> list[torch.Tensor]:
    """Factors at a tenant's dims embedded in the class dims, the extra
    rows zeros (they stay exactly zero through every update)."""
    out = []
    for A, D in zip(factors, class_dims):
        pad = int(D) - A.shape[0]
        if pad < 0:
            raise ValueError(f"factor rows {A.shape[0]} exceed class "
                             f"dim {D}")
        out.append(torch.cat([A, A.new_zeros((pad, A.shape[1]))])
                   if pad else A)
    return out


def _slice_factors(factors, dims):
    return [A[:int(I)] for A, I in zip(factors, dims)]


def _tenant_view(view: OrientedView, t: int) -> OrientedView:
    return dataclasses.replace(view, rows=view.rows[t], words=view.words[t],
                               values=view.values[t], perm=view.perm[t])


def _tenant_at(at: AltoTensor, t: int) -> AltoTensor:
    return dataclasses.replace(at, words=at.words[t], values=at.values[t],
                               part_start=at.part_start[t],
                               part_end=at.part_end[t])


def _check_bucket(ats, views, real_dims, plan, capacity) -> int:
    """Validate a bucket; returns its capacity."""
    K = len(ats)
    if len(views) != K or len(real_dims) != K:
        raise ValueError("ats/views/real_dims length mismatch")
    for at in ats:
        if at.meta != plan.meta:
            raise ValueError("tenant meta differs from plan meta — "
                             "canonicalize (shapeclass.canonicalize_tensor) "
                             "before batching")
    if plan.streaming is not None:
        raise ValueError("a bucket runs in core: a streaming plan cannot "
                         "be batched (plan.make_class_plan without a "
                         "device byte budget the class overflows)")
    cap = K if capacity is None else int(capacity)
    if cap < K:
        raise ValueError(f"capacity {cap} < bucket size {K}")
    return cap


def _fill(items: list, cap: int) -> list:
    """``items`` filled to ``cap`` with replicas of slot 0."""
    return items + [items[0]] * (cap - len(items))


def _streams(plan, ats, views_b, cap):
    """The bucket's stacked ALTO streams and, on the kernel backend, its
    members' pull orders stacked by mode, for the modes it runs recursive
    (routed so, or without a view: `plan.execute_mttkrp`); ``(None, {})``
    when it runs none."""
    rec = [mp.mode for mp in plan.modes
           if not (heuristics.is_oriented(mp.traversal)
                   and mp.mode in views_b)]
    if not rec:
        return None, {}
    members = _fill(list(ats), cap)
    pulls = {n: views_mod.stack_pull_orders(
        [views_mod.get_pull_order(at, n) for at in members])
        for n in rec} if plan.backend == "cuda" else {}
    return stack_tenants(members), pulls


def _mttkrp(plan, at_b, pulls, views_b, factors_b, mode: int):
    """The bucket's ``(T, I_n, R)`` MTTKRP through the plan's route for
    ``mode`` (the stacked view of an oriented mode, the stacked tensor
    and pull orders of a recursive one): one launch per kernel on the
    kernel backend, the reference traversal tenant by tenant else."""
    if plan.backend == "cuda":
        return plan_mod.execute_mttkrp(plan, at_b, views_b, factors_b, mode,
                                       pull=pulls.get(mode))
    view = views_b.get(mode)
    return torch.stack([
        plan_mod.execute_mttkrp(
            plan, None if at_b is None else _tenant_at(at_b, t),
            {} if view is None else {mode: _tenant_view(view, t)},
            [A[t] for A in factors_b], mode)
        for t in range(factors_b[0].shape[0])])


def _phi(plan, at_b, pull, view_b, B, mode: int, eps: float,
         factors=None, pi=None):
    """The bucket's ``(T, I_n, R)`` Φ, as `_mttkrp`."""
    if plan.backend == "cuda":
        return plan_mod.execute_phi(plan, at_b, view_b, B, mode,
                                    factors=factors, pi=pi, eps=eps,
                                    pull=pull)
    return torch.stack([
        plan_mod.execute_phi(
            plan, None if at_b is None else _tenant_at(at_b, t),
            None if view_b is None else _tenant_view(view_b, t), B[t], mode,
            factors=None if factors is None else [A[t] for A in factors],
            pi=None if pi is None else pi[t], eps=eps)
        for t in range(B.shape[0])])


# ---------------------------------------------------------------------------
# Batched CP-ALS
# ---------------------------------------------------------------------------

def _als_sweep(plan, at_b, pulls, views_b, factors_b, lam_b, active):
    """One CP-ALS sweep of every slot: `cpals._sweep` with the MTTKRP of
    the whole bucket and each slot's factor update by
    `cpals._update_factor`, skipped for the slots not ``active``
    (converged, quarantined or fill: their factors and λ come back as they
    were, and a quarantined slot's data never reaches a pseudo-inverse)."""
    T = lam_b.shape[0]
    factors_b = list(factors_b)
    grams = [[cpals._gram(A) for A in F.unbind(0)] for F in factors_b]
    lams, M = [], None
    for n in range(len(factors_b)):
        M = _mttkrp(plan, at_b, pulls, views_b, factors_b, n)
        new, lams = [], []
        for t in range(T):
            if not active[t]:
                new.append(factors_b[n][t])
                lams.append(lam_b[t])
                continue
            A, lam = cpals._update_factor(M[t], [g[t] for g in grams], n)
            new.append(A)
            lams.append(lam)
            grams[n][t] = cpals._gram(A)
        factors_b[n] = torch.stack(new)
    return factors_b, torch.stack(lams), M


def _freeze(mask: np.ndarray, new, old):
    """``new`` where ``mask`` (over the slots) is set, else ``old``."""
    m = torch.from_numpy(mask).to(old.device)
    return torch.where(m.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)


def _poison(x: torch.Tensor, pd: dict) -> torch.Tensor:
    """``x`` with the ``batched.nan`` poison in its slot's first entry."""
    x = x.clone()
    x[int(pd.get("tenant", 0)), 0, 0] = pd.get("value", float("nan"))
    return x


@dataclasses.dataclass
class BatchedCpalsResult:
    results: list[cpals.CpalsResult]   # per tenant, factors at its dims
    n_sweeps: int                      # batched sweeps run
    # quarantined[i]: under guard=True tenant i's update went non-finite
    # (or below the fit floor); its result is the last good iterate.
    quarantined: list[bool] = dataclasses.field(default_factory=list)


def batched_cp_als(ats: Sequence[AltoTensor],
                   views: Sequence[dict[int, OrientedView]],
                   real_dims: Sequence[tuple[int, ...]],
                   rank: int, *,
                   plan: plan_mod.ExecutionPlan,
                   n_iters: int = 50, tol: float = 1e-5,
                   seeds: Sequence[int] | None = None,
                   init_factors: Sequence[list[torch.Tensor]] | None = None,
                   capacity: int | None = None,
                   guard: bool = False) -> BatchedCpalsResult:
    """CP-ALS over K same-class tenants, one bucket.

    ``ats`` and ``views`` are the canonicalized class members (all with
    ``plan.meta``); ``real_dims[i]`` are tenant i's own extents, for its
    solo start (`cpals.init_factors` with ``seeds[i]``, or
    ``init_factors[i]``) and to slice its answer out. ``capacity`` (≥ K)
    fixes the stacked tenant axis: short buckets are filled with inactive
    replicas of slot 0. Each tenant stops on the solo driver's rule (fit
    change below ``tol``) and freezes while its mates sweep.

    ``guard=True`` quarantines a slot whose sweep output is not finite or
    whose fit falls below `health.FIT_FLOOR`: it rolls back to its
    previous iterate and freezes (``quarantined``); its mates keep their
    bits, and a clean bucket's bits do not change.
    """
    K = len(ats)
    if K == 0:
        return BatchedCpalsResult(results=[], n_sweeps=0)
    cap = _check_bucket(ats, views, real_dims, plan, capacity)
    if plan.rank != rank:
        raise ValueError(f"plan was built for rank {plan.rank}, "
                         f"batched_cp_als called with rank {rank}")
    _note_sweep(("als", plan))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dtype = ats[0].device, ats[0].values.dtype
    if seeds is None:
        seeds = [0] * K
    if init_factors is None:
        init_factors = [cpals.init_factors(real_dims[i], rank,
                                           seed=int(seeds[i]), dtype=dtype,
                                           device=dev) for i in range(K)]
    factors_k = [embed_factors([f.to(device=dev, dtype=dtype)
                                for f in fs], plan.meta.dims)
                 for fs in init_factors]
    views_b = stack_tenants(_fill(list(views), cap))
    at_b, pulls = _streams(plan, ats, views_b, cap)
    factors_b = stack_tenants(_fill(factors_k, cap))
    lam_b = torch.ones((cap, rank), dtype=dtype, device=dev)
    normX2 = [float((at.values.detach().double() ** 2).sum()) for at in ats]
    active = np.zeros(cap, bool)
    active[:K] = True
    quarantined = np.zeros(cap, bool)
    fits: list[list[float]] = [[] for _ in range(K)]
    prev = np.full(K, -np.inf)
    n_sweeps = 0
    for _ in range(n_iters):
        faults.inject("batched.sweep")
        good_f, good_l = factors_b, lam_b
        new_f, new_lam, M_last = _als_sweep(plan, at_b, pulls, views_b,
                                            factors_b, lam_b, active)
        factors_b = [_freeze(active, nf, f) for nf, f in zip(new_f, factors_b)]
        lam_b = _freeze(active, new_lam, lam_b)
        n_sweeps += 1
        pd = faults.fire("batched.nan")
        if pd is not None:
            factors_b[-1] = _poison(factors_b[-1], pd)
        bad = np.zeros(cap, bool)
        if guard:
            bad = active & ~health_mod.tenants_finite(
                [*factors_b, lam_b, M_last])
        live = [i for i in range(K) if active[i] and not bad[i]]
        now = torch.stack([cpals._fit_tensor(
            M_last[i], [A[i] for A in factors_b], lam_b[i], normX2[i])
            for i in live]).cpu().tolist() if live else []  # one copy
        for i, fit in zip(live, now):
            if guard and not (math.isfinite(fit)
                              and fit >= health_mod.FIT_FLOOR):
                # Huge but finite: quarantined before its Grams overflow
                # the next sweep (health.FIT_FLOOR).
                bad[i] = True
                continue
            fits[i].append(fit)
            if abs(fit - prev[i]) < tol:
                active[i] = False
            prev[i] = fit
        if bad.any():
            factors_b = [_freeze(bad, g, f) for g, f in zip(good_f, factors_b)]
            lam_b = _freeze(bad, good_l, lam_b)
            quarantined |= bad
            active &= ~bad
        if not active[:K].any():
            break
    results = [cpals.CpalsResult(
        lam=lam_b[i], factors=_slice_factors([A[i] for A in factors_b],
                                             real_dims[i]),
        fits=fits[i], n_iters=len(fits[i]), plan=plan) for i in range(K)]
    return BatchedCpalsResult(results=results, n_sweeps=n_sweeps,
                              quarantined=[bool(q) for q in quarantined[:K]])


# ---------------------------------------------------------------------------
# Batched CP-APR
# ---------------------------------------------------------------------------

def _apr_mode_update(plan, at_b, pull, view_b, mode: int, lam_b,
                     factors_b, phi_prev, active, first_outer: bool,
                     pre_pi: bool, p: cpapr.CpaprParams):
    """One Alg. 2 mode update of every slot (`cpapr._mode_update`), the Φ
    of the whole bucket per inner step; lines 4-5, 6 (Π) and 9 by the solo
    driver's functions on the stacked tensors, line 15 by its function
    slot by slot. Returns (A, λ, Φ of the final B, converged, inner steps,
    KKT of the first step), the last three as numpy arrays over the
    slots."""
    B = cpapr._shifted(factors_b[mode], lam_b, phi_prev, first_outer, p)
    T = B.shape[0]
    operands = (dict(pi=cpapr._pi(plan, at_b, view_b, factors_b, mode))
                if pre_pi else dict(factors=factors_b))
    tau = float(np.float32(p.tau))
    done = np.zeros(T, bool)
    n_inner = np.zeros(T, np.int64)
    kkt_first = np.zeros(T)
    Phi = None
    for step in range(p.l_max):
        if step and not (active & ~done).any():
            break                  # every active slot froze
        Phi = _phi(plan, at_b, pull, view_b, B, mode, p.eps_div,
                   **operands)
        kkt = cpapr._kkt(B, Phi).cpu().numpy().astype(np.float64)  # one copy
        if step == 0:
            kkt_first = kkt
        done |= kkt < tau
        upd = torch.from_numpy(~done).to(B.device)[:, None, None]
        B = torch.where(upd, B * Phi, B)
        n_inner += ~done
    A_new, lam_new = zip(*(cpapr._normalized(b) for b in B.unbind(0)))
    return (torch.stack(A_new), torch.stack(lam_new), Phi, n_inner == 0,
            n_inner, kkt_first)


@dataclasses.dataclass
class BatchedCpaprResult:
    results: list[cpapr.CpaprResult]   # per tenant, factors at its dims
    n_outer: int                       # batched outer iterations run
    # The contract of BatchedCpalsResult.quarantined (guard=True only).
    quarantined: list[bool] = dataclasses.field(default_factory=list)


def batched_cp_apr(ats: Sequence[AltoTensor],
                   views: Sequence[dict[int, OrientedView]],
                   real_dims: Sequence[tuple[int, ...]],
                   rank: int, *,
                   plan: plan_mod.ExecutionPlan,
                   params: cpapr.CpaprParams | None = None,
                   seeds: Sequence[int] | None = None,
                   init_factors: Sequence[tuple] | None = None,
                   capacity: int | None = None,
                   guard: bool = False) -> BatchedCpaprResult:
    """CP-APR over K same-class tenants, one bucket; the stacking and
    freezing contract of `batched_cp_als`. Tenant i starts from
    `cpapr.init_factors` at its dims with ``seeds[i]`` and λ = Σx / R, or
    from ``init_factors[i] = (λ, factors)``, embedded; it freezes (factors,
    λ and Φ memory) once every mode reports KKT convergence, the solo
    driver's rule. The Π policy is the plan's.

    ``guard=True`` checks each mode update per slot (λ, the updated
    factor and the KKT violation finite): a poisoned slot rolls back to
    its state before the outer iteration and freezes (``quarantined``),
    so it never holds its mates' inner loop past the mode that poisoned
    it, and they keep their bits."""
    K = len(ats)
    if K == 0:
        return BatchedCpaprResult(results=[], n_outer=0)
    cap = _check_bucket(ats, views, real_dims, plan, capacity)
    if plan.rank != rank:
        raise ValueError(f"plan was built for rank {plan.rank}, "
                         f"batched_cp_apr called with rank {rank}")
    p = params or cpapr.CpaprParams()
    N = len(plan.meta.dims)
    dev, dtype = ats[0].device, ats[0].values.dtype
    pre_pi = plan.pi_policy is heuristics.PiPolicy.PRE
    if seeds is None:
        seeds = [0] * K
    if init_factors is None:
        init_factors = [cpapr.init_factors(
            real_dims[i], rank, seed=int(seeds[i]),
            total=float(ats[i].values.sum()), dtype=dtype, device=dev)
            for i in range(K)]
    lam_k = [torch.as_tensor(lam).to(device=dev, dtype=dtype)
             for lam, _ in init_factors]
    factors_k = [embed_factors([f.to(device=dev, dtype=dtype) for f in fs],
                               plan.meta.dims) for _, fs in init_factors]
    views_b = stack_tenants(_fill(list(views), cap))
    at_b, pulls = _streams(plan, ats, views_b, cap)
    factors_b = stack_tenants(_fill(factors_k, cap))
    lam_b = stack_tenants(_fill(lam_k, cap))
    phi_b = [torch.zeros_like(A) for A in factors_b]

    active = np.zeros(cap, bool)
    active[:K] = True
    quarantined = np.zeros(cap, bool)
    kkt_hist: list[list[float]] = [[] for _ in range(K)]
    n_inner_tot = np.zeros(cap, np.int64)
    n_outer_seen = np.zeros(K, np.int64)
    n_outer = 0
    for outer in range(1, p.k_max + 1):
        faults.inject("batched.sweep")
        good = (lam_b, list(factors_b), list(phi_b))
        n_outer = outer
        conv_all = np.ones(cap, bool)
        kkt_max = np.zeros(cap)
        for n in range(N):
            _note_sweep(("apr", plan, n, outer == 1, pre_pi, p))
            A, lam_new, Phi, conv, n_inner, kkt = _apr_mode_update(
                plan, at_b, pulls.get(n), views_b.get(n), n, lam_b,
                factors_b, phi_b[n], active, outer == 1, pre_pi, p)
            factors_b = list(factors_b)
            factors_b[n] = _freeze(active, A, factors_b[n])
            lam_b = _freeze(active, lam_new, lam_b)
            phi_b[n] = _freeze(active, Phi, phi_b[n])
            pd = faults.fire("batched.nan")
            if pd is not None:
                factors_b[n] = _poison(factors_b[n], pd)
            conv_all &= conv
            n_inner_tot += np.where(active, n_inner, 0)
            # Python's max, as the solo driver folds (NaN-blind).
            kkt_max = np.array([max(a, b) for a, b in zip(kkt_max, kkt)])
            if guard:
                bad = active & ~(health_mod.tenants_finite(
                    [lam_b, factors_b[n]]) & np.isfinite(kkt))
                if bad.any():
                    g_lam, g_fac, g_phi = good
                    factors_b = [_freeze(bad, g, f)
                                 for g, f in zip(g_fac, factors_b)]
                    phi_b = [_freeze(bad, g, f) for g, f in zip(g_phi, phi_b)]
                    lam_b = _freeze(bad, g_lam, lam_b)
                    quarantined |= bad
                    active &= ~bad
        for i in range(K):
            if active[i]:
                kkt_hist[i].append(float(kkt_max[i]))
                n_outer_seen[i] = outer
        active &= ~conv_all
        if not active[:K].any():
            break
    traversals = [m.traversal.value for m in plan.modes]
    results = [cpapr.CpaprResult(
        lam=lam_b[i], factors=_slice_factors([A[i] for A in factors_b],
                                             real_dims[i]),
        kkt_violations=kkt_hist[i], log_likelihoods=[],
        n_outer=int(n_outer_seen[i]), n_inner_total=int(n_inner_tot[i]),
        pi_policy=plan.pi_policy.value, traversals=traversals, plan=plan)
        for i in range(K)]
    return BatchedCpaprResult(results=results, n_outer=n_outer,
                              quarantined=[bool(q) for q in quarantined[:K]])
