"""Port parity: the health guards (`repro_torch.core.health`) on the solo
and batched drivers, against the JAX package's.

The cases of `tests/test_resilience.py::TestGuards` and
`TestBatchedQuarantine`, run through both packages from the same numpy
starts (`torch_starts`): the same poison at the same ``after`` gives the
same stopping iteration and the same ``rolled_back`` and ``quarantined``
flags, CP-ALS fits within 1e-4 relative and CP-APR log-likelihoods within
1e-5 relative (the parity rules of `tests/test_torch_cpals.py` and
`tests/test_torch_cpapr.py`). Within the port, bit for bit: a guarded
clean run equals an unguarded one, and a quarantined tenant's mates equal
the clean bucket's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_starts
from repro.core import alto as jalto
from repro.core import batched as jbatched
from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro.core import faults as jfaults
from repro.core import health as jhealth
from repro.core import plan as jplan
from repro.core import shapeclass as jsc
from repro.sparse.synthetic import uniform_tensor
from repro_torch.core import alto, batched, cpals, cpapr, faults, health
from repro_torch.core import plan as plan_mod
from repro_torch.core import shapeclass
from repro_torch.sparse.tensor import SparseTensor

RANK = 3
DIMS = (9, 7, 5)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    faults.reset()
    jfaults.reset()
    torch_starts.use(monkeypatch)
    yield
    faults.reset()
    jfaults.reset()


def _x(seed, count_data=False, nnz=80, dims=DIMS):
    return uniform_tensor(dims, nnz, seed=seed, count_data=count_data)


def _port(x):
    return alto.build_device(SparseTensor(x.dims, x.coords, x.values),
                             n_partitions=2, device="cpu")


def _both(site, arm, run_j, run_t):
    """``run_j()`` and ``run_t()``, each with ``site`` armed as ``arm``
    (None: clean) in its own package."""
    if arm is not None:
        jfaults.arm(site, **arm)
    ref = run_j()
    jfaults.reset()
    if arm is not None:
        faults.arm(site, **arm)
    got = run_t()
    faults.reset()
    return ref, got


def _finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


# ---------------------------------------------------------------------------
# The guard primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poison", [None, np.nan, np.inf, -np.inf, 1e30])
def test_finite_checks_match_the_jax_package(poison):
    rng = np.random.default_rng(3)
    arrays = [rng.random((4, 6, 2)).astype(np.float32),
              rng.random((4, 5)).astype(np.float32),
              np.arange(4, dtype=np.int32)]
    if poison is not None:
        arrays[0][2, 3, 1] = poison
    ref_all = jhealth.all_finite([jnp.asarray(a) for a in arrays])
    ref_t = jhealth.tenants_finite([jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a) for a in arrays]
    assert health.all_finite(ts) == ref_all
    assert health.tenants_finite(ts).tolist() == np.asarray(ref_t).tolist()
    assert health.all_finite([]) and health.all_finite(ts[2:])
    with pytest.raises(ValueError):
        health.tenants_finite(ts[2:])


def test_device_lost_is_none_on_the_cpu():
    assert health.device_lost("cpu") is None


# ---------------------------------------------------------------------------
# Solo CP-ALS and CP-APR
# ---------------------------------------------------------------------------

def test_guard_is_bitwise_noop_on_finite_inputs():
    at = _port(_x(7))
    a = cpals.cp_als(at, RANK, n_iters=5, seed=7, guard=False)
    b = cpals.cp_als(at, RANK, n_iters=5, seed=7, guard=True)
    assert a.fits == b.fits and a.health is None
    assert all(torch.equal(fa, fb) for fa, fb in zip(a.factors, b.factors))
    assert torch.equal(a.lam, b.lam)
    assert b.health.checks == 5 and b.health.violations == 0
    assert not b.health.rolled_back
    ref = jcpals.cp_als(jalto.build(_x(7), n_partitions=2), RANK,
                        n_iters=5, seed=7, guard=True)
    np.testing.assert_allclose(b.fits, ref.fits, rtol=1e-4, atol=0)


# (seed, n_iters, poison value, after, guard_slack, reason)
ALS_POISON = [(8, 5, float("nan"), 0, 1e-3, "non-finite"),
              (8, 5, float("nan"), 3, 1e-3, "non-finite"),
              (9, 6, 1e30, 0, 1e-3, "diverged"),
              (16, 8, 25.0, 2, 1e-6, "regressed")]


@pytest.mark.parametrize("seed,n_iters,value,after,slack,reason",
                         ALS_POISON)
def test_cp_als_poison_rolls_back_as_the_jax_package(seed, n_iters, value,
                                                     after, slack, reason):
    x = _x(seed)
    arm = dict(data={"value": value}, after=after)
    ref, got = _both(
        "cpals.nan", arm,
        lambda: jcpals.cp_als(jalto.build(x, n_partitions=2), RANK,
                              n_iters=n_iters, seed=seed, guard=True,
                              guard_slack=slack),
        lambda: cpals.cp_als(_port(x), RANK, n_iters=n_iters, seed=seed,
                             guard=True, guard_slack=slack))
    assert ref.health.rolled_back and got.health.rolled_back
    assert reason in ref.health.reason and reason in got.health.reason
    assert got.n_iters == ref.n_iters == after
    np.testing.assert_allclose(got.fits, ref.fits, rtol=1e-4, atol=0)
    assert _finite(got.factors) and torch.isfinite(got.lam).all()
    # the rollback is the clean run's iterate at that point, bit for bit
    clean = cpals.cp_als(_port(x), RANK, n_iters=max(after, 1), seed=seed)
    if after:
        assert got.fits == clean.fits[:after]
        assert all(torch.equal(a, b)
                   for a, b in zip(got.factors, clean.factors))


def test_unguarded_poison_reaches_the_result():
    """The hazard the guard exists for, poisoned on the last sweep: both
    packages hand the NaN back."""
    x = _x(8)
    ref, got = _both(
        "cpals.nan", dict(after=4),
        lambda: jcpals.cp_als(jalto.build(x, n_partitions=2), RANK,
                              n_iters=5, seed=8),
        lambda: cpals.cp_als(_port(x), RANK, n_iters=5, seed=8))
    assert not all(bool(jnp.all(jnp.isfinite(A))) for A in ref.factors)
    assert not _finite(got.factors) and got.health is None
    assert np.isnan(got.fits[-1]) and np.isnan(ref.fits[-1])


# (seed, poison value, after: mode updates let through)
APR_POISON = [(10, float("nan"), 0), (10, float("nan"), 4),
              (12, float("inf"), 7)]


@pytest.mark.parametrize("seed,value,after", APR_POISON)
def test_cp_apr_poison_rolls_back_as_the_jax_package(seed, value, after):
    x = _x(seed, count_data=True)
    params_j = jcpapr.CpaprParams(k_max=4)
    params_t = cpapr.CpaprParams(k_max=4)
    ref, got = _both(
        "cpapr.nan", dict(data={"value": value}, after=after),
        lambda: jcpapr.cp_apr(jalto.build(x, n_partitions=2), RANK,
                              params=params_j, seed=seed, guard=True,
                              track_ll=True),
        lambda: cpapr.cp_apr(_port(x), RANK, params=params_t, seed=seed,
                             guard=True, track_ll=True))
    assert ref.health.rolled_back and got.health.rolled_back
    assert got.n_outer == ref.n_outer == after // len(DIMS)
    np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods,
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.kkt_violations, ref.kkt_violations,
                               rtol=1e-4, atol=1e-6)
    assert _finite(got.factors) and torch.isfinite(got.lam).all()


def test_guarded_apr_matches_unguarded_clean():
    x = _x(11, count_data=True)
    params = cpapr.CpaprParams(k_max=4)
    a = cpapr.cp_apr(_port(x), RANK, params=params, seed=11, guard=False)
    b = cpapr.cp_apr(_port(x), RANK, params=params, seed=11, guard=True)
    assert all(torch.equal(fa, fb) for fa, fb in zip(a.factors, b.factors))
    assert torch.equal(a.lam, b.lam)
    assert a.kkt_violations == b.kkt_violations
    assert b.health.violations == 0 and b.health.checks == b.n_outer


# ---------------------------------------------------------------------------
# Batched quarantine
# ---------------------------------------------------------------------------

def _bucket_j(xs, algorithm, guard, n_iters=5, capacity=4):
    sc = jsc.classify(xs[0], RANK)
    plan = jplan.make_class_plan(sc)
    ats, views = [], []
    for x in xs:
        at = jsc.canonicalize_tensor(jalto.build_device(
            jsc.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False), sc)
        ats.append(at)
        views.append(jplan.build_views(at, plan))
    seeds = list(range(len(xs)))
    dims = [x.dims for x in xs]
    if algorithm == "als":
        return jbatched.batched_cp_als(ats, views, dims, RANK, plan=plan,
                                       n_iters=n_iters, seeds=seeds,
                                       capacity=capacity, guard=guard)
    return jbatched.batched_cp_apr(
        ats, views, dims, RANK, plan=plan,
        params=jcpapr.CpaprParams(k_max=n_iters), seeds=seeds,
        capacity=capacity, guard=guard)


def _bucket_t(xs, algorithm, guard, n_iters=5, capacity=4,
              backend="reference"):
    xs = [SparseTensor(x.dims, x.coords, x.values) for x in xs]
    sc = shapeclass.classify(xs[0], RANK)
    plan = plan_mod.make_class_plan(sc, backend=backend, device="cpu")
    ats, views = [], []
    for x in xs:
        at = shapeclass.canonicalize_tensor(alto.build_device(
            shapeclass.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False, device="cpu"), sc)
        ats.append(at)
        views.append(plan_mod.build_views(at, plan))
    seeds = list(range(len(xs)))
    dims = [x.dims for x in xs]
    if algorithm == "als":
        return batched.batched_cp_als(ats, views, dims, RANK, plan=plan,
                                      n_iters=n_iters, seeds=seeds,
                                      capacity=capacity, guard=guard)
    return batched.batched_cp_apr(
        ats, views, dims, RANK, plan=plan,
        params=cpapr.CpaprParams(k_max=n_iters), seeds=seeds,
        capacity=capacity, guard=guard)


def _history(result, algorithm):
    return result.fits if algorithm == "als" else result.kkt_violations


# (algorithm, poisoned tenant, poison value, after, backend)
QUARANTINE = [("als", 1, float("nan"), 0, "reference"),
              ("als", 1, float("nan"), 2, "cuda"),
              ("als", 2, 1e30, 1, "reference"),
              ("apr", 1, float("nan"), 0, "reference"),
              ("apr", 0, float("nan"), 4, "cuda")]


@pytest.mark.parametrize("algorithm,tenant,value,after,backend", QUARANTINE)
def test_poisoned_slot_quarantined_as_the_jax_package(algorithm, tenant,
                                                      value, after,
                                                      backend):
    """CP-ALS against the JAX guarded bucket under the same poison. The
    JAX guarded batched CP-APR raises (its guard writes into the
    read-only array `np.asarray` gives), so CP-APR is held to the JAX clean
    bucket: the mates' histories, and the poisoned tenant's up to its
    rollback."""
    xs = [_x(s, count_data=algorithm == "apr") for s in (0, 1, 2)]
    clean = _bucket_t(xs, algorithm, guard=True, backend=backend)
    assert clean.quarantined == [False, False, False]
    arm = dict(data={"tenant": tenant, "value": value}, after=after)
    if algorithm == "als":
        ref, got = _both("batched.nan", arm,
                         lambda: _bucket_j(xs, algorithm, guard=True),
                         lambda: _bucket_t(xs, algorithm, guard=True,
                                           backend=backend))
        assert ref.quarantined == [i == tenant for i in range(3)]
        kept = after                 # sweeps before the poisoned one
    else:
        ref = _bucket_j(xs, algorithm, guard=False)
        faults.arm("batched.nan", **arm)
        got = _bucket_t(xs, algorithm, guard=True, backend=backend)
        kept = after // len(DIMS)    # outer iterations before it
    assert got.quarantined == [i == tenant for i in range(3)]
    for i in range(3):
        g, r, c = got.results[i], ref.results[i], clean.results[i]
        hist = _history(g, algorithm)
        want = _history(c, algorithm)
        if i == tenant:
            want = want[:kept]       # rolled back to its last good iterate
        assert hist == want
        np.testing.assert_allclose(hist, _history(r, algorithm)[:len(hist)],
                                   rtol=1e-4, atol=1e-6)
        assert len(hist) == len(_history(r, algorithm)) or i == tenant
        assert _finite(g.factors) and torch.isfinite(g.lam).all()
        if i != tenant:      # the mates keep the clean bucket's bits
            assert all(torch.equal(a, b)
                       for a, b in zip(g.factors, c.factors))
            assert torch.equal(g.lam, c.lam)


@pytest.mark.parametrize("algorithm", ["als", "apr"])
def test_unguarded_bucket_returns_poison(algorithm):
    """Poisoned in the last update, unguarded: the NaN comes back (and
    only in its slot)."""
    xs = [_x(s, count_data=algorithm == "apr") for s in (0, 1, 2)]
    last = 4 if algorithm == "als" else 4 * len(DIMS) - 1
    faults.arm("batched.nan", data={"tenant": 1}, after=last)
    out = _bucket_t(xs, algorithm, guard=False)
    assert not any(out.quarantined)
    assert not _finite(out.results[1].factors)
    assert _finite(out.results[0].factors) and _finite(out.results[2].factors)


@pytest.mark.parametrize("algorithm,backend", [("als", "reference"),
                                               ("als", "cuda"),
                                               ("apr", "cuda")])
def test_guard_bitwise_noop_on_clean_bucket(algorithm, backend):
    xs = [_x(s, count_data=algorithm == "apr") for s in (3, 4)]
    a = _bucket_t(xs, algorithm, guard=False, backend=backend)
    b = _bucket_t(xs, algorithm, guard=True, backend=backend)
    assert b.quarantined == [False, False]
    for ra, rb in zip(a.results, b.results):
        assert _history(ra, algorithm) == _history(rb, algorithm)
        assert all(torch.equal(fa, fb)
                   for fa, fb in zip(ra.factors, rb.factors))
