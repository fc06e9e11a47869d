"""Port parity: the batched drivers (`core.batched`) and the tenant axis
of the oriented kernels.

* Against the JAX package's `batched` (reference backend, its own
  tests' shapes and seeds), with the starts made in numpy and handed to
  both: CP-ALS fits within 1e-4 relative and factors within 1e-3 (float32
  pinv from LAPACK against XLA's, sums in another order); CP-APR
  log-likelihoods within 1e-5 relative, KKT violations within 1e-4, λ
  within 1e-5 relative, factors within 1e-4, equal inner counts (the
  parity rules of `tests/test_torch_cpapr.py`).
* Within the port, bit for bit: a bucket equals each member's solo run on
  its padded tensor with the class plan and the embedded start; a
  converged tenant freezes at its solo early-stopped result; the bucket's
  capacity changes no bit.
* The tenant axis: every stacked wrapper (the runs passes of K1/K2 and
  K5/K6, the fix-up, the split) equals its per-tenant calls, with tenant
  t's last row equal to tenant t + 1's first; the same carries walked as
  one concatenated stream would join those two runs.
* Recursive modes in a bucket: class plans with modes forced recursive
  (`_route`) against the JAX package's `batched` under the same plan
  (the tolerances above), bit for bit each member's solo run on its
  padded tensor, a freeze and a quarantine inside such a bucket; the
  stacked K3, K7 (OTF and PRE) and pull equal their per-tenant calls.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import batched as jbatched
from repro.core import cpapr as jcpapr
from repro.core import plan as jplan
from repro.core import shapeclass as jsc
from repro.sparse import synthetic as jsyn
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch.core import alto as talto
from repro_torch.core import batched as tbatched
from repro_torch.core import faults as tfaults
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import encoding as tenc
from repro_torch.core import heuristics as theur
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import plan as tplan
from repro_torch.core import shapeclass as tsc
from repro_torch.core import views as tviews
from repro_torch.kernels import cpapr_phi as tk7
from repro_torch.kernels import mttkrp as tk3
from repro_torch.kernels import mttkrp_oriented as kori
from repro_torch.kernels import ops as tops
from repro_torch.sparse.tensor import SparseTensor as TSparse

RANK = 4


def _port(x):
    return TSparse(x.dims, x.coords, x.values)


def _port_members(xs, sc, plan):
    ats, views = [], []
    for x in xs:
        at = tsc.canonicalize_tensor(talto.build_device(
            tsc.pad_to_class(_port(x), sc), n_partitions=sc.n_partitions,
            compute_reuse=False, device="cpu"), sc)
        ats.append(at)
        views.append(tplan.build_views(at, plan))
    return ats, views


def _jax_members(xs, sc, plan):
    ats, views = [], []
    for x in xs:
        at = jsc.canonicalize_tensor(jalto.build_device(
            jsc.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False), sc)
        ats.append(at)
        views.append(jplan.build_views(at, plan))
    return ats, views


def _classes(xs, rank=RANK):
    """The JAX and port class of a bucket: the smallest admitting all."""
    d = tuple(max(tsc._next_pow2(x.dims[k]) for x in xs)
              for k in range(len(xs[0].dims)))
    n = max(max(tsc._next_pow2(x.nnz) for x in xs), 8)
    return (jsc.ShapeClass(dims=d, nnz=n, n_partitions=8, rank=rank),
            tsc.ShapeClass(dims=d, nnz=n, n_partitions=8, rank=rank))


def _als_inits(xs, seed, rank=RANK):
    rng = np.random.default_rng(seed)
    return [[rng.random((I, rank)).astype(np.float32) for I in x.dims]
            for x in xs]


def _apr_inits(xs, seed, rank=RANK):
    rng = np.random.default_rng(seed)
    out = []
    for x in xs:
        fs = [rng.random((I, rank)).astype(np.float32) + 0.1
              for I in x.dims]
        fs = [(A / A.sum(axis=0, keepdims=True)).astype(np.float32)
              for A in fs]
        lam = np.full(rank, float(np.asarray(x.values).sum()) / rank,
                      np.float32)
        out.append((lam, fs))
    return out


ALS_BUCKET = [("uniform_tensor", (9, 7, 5), 90, 1),
              ("uniform_tensor", (12, 6, 8), 100, 2)]
APR_BUCKET = [("uniform_tensor", (9, 7, 5), 90, 5),
              ("uniform_tensor", (16, 8, 8), 128, 6)]


def _bucket(spec, count_data=False):
    return [getattr(jsyn, g)(d, n, seed=s, count_data=count_data)
            for g, d, n, s in spec]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_batched_cp_als_matches_the_jax_package(backend):
    xs = _bucket(ALS_BUCKET)
    sc_j, sc_t = _classes(xs)
    jp = jplan.make_class_plan(sc_j, backend="reference")
    tp = tplan.make_class_plan(sc_t, backend=backend)
    inits = _als_inits(xs, 11)
    ref = jbatched.batched_cp_als(
        *_jax_members(xs, sc_j, jp), [x.dims for x in xs], RANK, plan=jp,
        n_iters=4, tol=0.0, capacity=3,
        init_factors=[[jnp.asarray(f) for f in fs] for fs in inits])
    got = tbatched.batched_cp_als(
        *_port_members(xs, sc_t, tp), [x.dims for x in xs], RANK, plan=tp,
        n_iters=4, tol=0.0, capacity=3,
        init_factors=[[torch.from_numpy(f) for f in fs] for fs in inits])
    assert got.n_sweeps == ref.n_sweeps == 4
    for g, r in zip(got.results, ref.results):
        np.testing.assert_allclose(g.fits, r.fits, rtol=1e-4, atol=0)
        for a, b in zip(g.factors, r.factors):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_batched_cp_apr_matches_the_jax_package(backend, policy,
                                                monkeypatch):
    xs = _bucket(APR_BUCKET, count_data=True)
    sc_j, sc_t = _classes(xs)
    jp = jplan.make_class_plan(sc_j, backend="reference")
    jp = dataclasses.replace(jp, pi_policy=type(jp.pi_policy)(policy))
    tp = dataclasses.replace(tplan.make_class_plan(sc_t, backend=backend),
                             pi_policy=theur.PiPolicy(policy))
    inits = _apr_inits(xs, 12)
    by_dims = {tuple(x.dims): init for x, init in zip(xs, inits)}

    def jax_init(dims, rank, seed=0, total=1.0, dtype=jnp.float32):
        lam, fs = by_dims[tuple(dims)]
        return jnp.asarray(lam), [jnp.asarray(f) for f in fs]
    monkeypatch.setattr(jcpapr, "init_factors", jax_init)
    p = tcpapr.CpaprParams(k_max=4)
    ref = jbatched.batched_cp_apr(
        *_jax_members(xs, sc_j, jp), [x.dims for x in xs], RANK, plan=jp,
        params=jcpapr.CpaprParams(k_max=4), capacity=3)
    got = tbatched.batched_cp_apr(
        *_port_members(xs, sc_t, tp), [x.dims for x in xs], RANK, plan=tp,
        params=p, capacity=3,
        init_factors=[(torch.from_numpy(lam),
                       [torch.from_numpy(f) for f in fs])
                      for lam, fs in inits])
    for x, g, r in zip(xs, got.results, ref.results):
        assert (g.n_outer, g.n_inner_total) == (r.n_outer, r.n_inner_total)
        assert g.pi_policy == r.pi_policy == policy
        np.testing.assert_allclose(g.kkt_violations, r.kkt_violations,
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.lam.numpy(), np.asarray(r.lam),
                                   rtol=1e-5, atol=0)
        for a, b in zip(g.factors, r.factors):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
        ll_t = tcpapr.log_likelihood(
            talto.build(_port(x), device="cpu"), g.lam, g.factors)
        ll_j = jcpapr.log_likelihood(jalto.build(x), r.lam, r.factors)
        np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-5)


# ---------------------------------------------------------------------------
# Within the port: bucket ≡ solo, the freeze, capacity, degenerate tenants
# ---------------------------------------------------------------------------

def _assert_solo_bits(res, solo, dims):
    for a, b in zip(res.factors, solo.factors):
        assert torch.equal(a, b[:a.shape[0]])
        assert not b[a.shape[0]:].any()          # padded rows stay zero
    assert torch.equal(res.lam, solo.lam)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_bucketed_cp_als_equals_solo_on_padded_bitwise(backend):
    xs = _bucket(ALS_BUCKET)
    _, sc = _classes(xs)
    plan = tplan.make_class_plan(sc, backend=backend)
    ats, views = _port_members(xs, sc, plan)
    inits = [tcpals.init_factors(x.dims, RANK, seed=i, device="cpu")
             for i, x in enumerate(xs)]
    res = tbatched.batched_cp_als(ats, views, [x.dims for x in xs], RANK,
                                  plan=plan, n_iters=4, tol=0.0,
                                  init_factors=inits, capacity=3)
    for i, x in enumerate(xs):
        solo = tcpals.cp_als(ats[i], RANK, n_iters=4, tol=0.0, plan=plan,
                             views=views[i],
                             factors=tbatched.embed_factors(inits[i],
                                                            sc.dims))
        assert res.results[i].fits == solo.fits
        _assert_solo_bits(res.results[i], solo, x.dims)


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_bucketed_cp_apr_equals_solo_on_padded_bitwise(backend, policy):
    xs = _bucket(APR_BUCKET, count_data=True)
    _, sc = _classes(xs)
    plan = dataclasses.replace(tplan.make_class_plan(sc, backend=backend),
                               pi_policy=theur.PiPolicy(policy))
    ats, views = _port_members(xs, sc, plan)
    p = tcpapr.CpaprParams(k_max=4, tau=0.05)      # some modes freeze
    res = tbatched.batched_cp_apr(ats, views, [x.dims for x in xs], RANK,
                                  plan=plan, params=p, seeds=[3, 4],
                                  capacity=3)
    for i, x in enumerate(xs):
        lam, fs = tcpapr.init_factors(x.dims, RANK, seed=3 + i,
                                      total=float(ats[i].values.sum()),
                                      device="cpu")
        solo = tcpapr.cp_apr(ats[i], RANK, p, plan=plan, views=views[i],
                             factors=tbatched.embed_factors(fs, sc.dims),
                             lam=lam)
        r = res.results[i]
        assert r.kkt_violations == solo.kkt_violations
        assert (r.n_outer, r.n_inner_total) == (solo.n_outer,
                                                solo.n_inner_total)
        _assert_solo_bits(r, solo, x.dims)
    assert any(r.n_inner_total < r.n_outer * 3 * p.l_max
               for r in res.results)


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_a_bucket_runs_the_drivers_own_steps(policy, monkeypatch):
    """The bucket's dense algebra is the solo drivers' functions: a factor
    update (`cpals._update_factor`) and a normalisation
    (`cpapr._normalized`) per slot and mode update, the shift
    (`cpapr._shifted`) and, under ALTO-PRE, Π (`cpapr._pi`) once a mode
    update on the stacked tensors, the KKT violation (`cpapr._kkt`) once
    an inner step. Two tenants in three slots, the third a fill."""
    calls = {}
    _counting(monkeypatch, tcpals, "_update_factor", calls)
    for name in ("_shifted", "_kkt", "_normalized", "_pi"):
        _counting(monkeypatch, tcpapr, name, calls)
    xs = _bucket(APR_BUCKET, count_data=True)
    _, sc = _classes(xs)
    plan = dataclasses.replace(tplan.make_class_plan(sc, backend="cuda"),
                               pi_policy=theur.PiPolicy(policy))
    ats, views = _port_members(xs, sc, plan)
    dims = [x.dims for x in xs]
    tbatched.batched_cp_als(ats, views, dims, RANK, plan=plan, n_iters=2,
                            tol=0.0, seeds=[1, 2], capacity=3)
    assert calls == {"_update_factor": 2 * 3 * 2}   # tenants, modes, sweeps
    calls.clear()
    p = tcpapr.CpaprParams(k_max=2, l_max=4, tau=0.0)
    tbatched.batched_cp_apr(ats, views, dims, RANK, plan=plan, params=p,
                            seeds=[3, 4], capacity=3)
    updates = 3 * p.k_max                            # modes × outer
    assert calls == {"_shifted": updates, "_kkt": updates * p.l_max,
                     "_normalized": 3 * updates,
                     **({"_pi": updates} if policy == "pre" else {})}


def test_convergence_freezes_a_converged_tenant():
    """A rank-1 tenant converges in a few sweeps, its mate needs more: the
    frozen tenant equals its solo early-stopped run on the padded tensor,
    bit for bit, though the bucket sweeps on."""
    rng = np.random.default_rng(0)
    u, v, w = (rng.random(9) + 0.5, rng.random(7) + 0.5, rng.random(5) + 0.5)
    dense = np.einsum("i,j,k->ijk", u, v, w).astype(np.float32)
    coords = np.argwhere(rng.random(dense.shape) < 0.4).astype(np.int32)
    coords = coords[:100]
    easy = TSparse((9, 7, 5), coords, dense[tuple(coords.T)])
    hard = _port(jsyn.uniform_tensor((12, 6, 8), 128, seed=7))
    sc = tsc.ShapeClass(dims=(16, 8, 8), nnz=128, n_partitions=8, rank=1)
    plan = tplan.make_class_plan(sc, backend="cuda")
    ats, views = [], []
    for x in (easy, hard):
        at = tsc.canonicalize_tensor(talto.build_device(
            tsc.pad_to_class(x, sc), n_partitions=8, compute_reuse=False,
            device="cpu"), sc)
        ats.append(at)
        views.append(tplan.build_views(at, plan))
    res = tbatched.batched_cp_als(ats, views, [easy.dims, hard.dims], 1,
                                  plan=plan, n_iters=20, tol=1e-4,
                                  capacity=2)
    easy_r, hard_r = res.results
    assert easy_r.n_iters < hard_r.n_iters == res.n_sweeps
    init = tcpals.init_factors(easy.dims, 1, seed=0, device="cpu")
    solo = tcpals.cp_als(ats[0], 1, n_iters=20, tol=1e-4, plan=plan,
                         views=views[0],
                         factors=tbatched.embed_factors(init, sc.dims))
    assert easy_r.fits == solo.fits and easy_r.n_iters == solo.n_iters
    _assert_solo_bits(easy_r, solo, easy.dims)


def test_capacity_fill_changes_no_bit():
    xs = _bucket(ALS_BUCKET)
    _, sc = _classes(xs)
    plan = tplan.make_class_plan(sc, backend="cuda")
    ats, views = _port_members(xs, sc, plan)
    runs = [tbatched.batched_cp_als(ats, views, [x.dims for x in xs], RANK,
                                    plan=plan, n_iters=3, tol=0.0,
                                    seeds=[5, 6], capacity=cap)
            for cap in (None, 2, 5)]
    for r in runs[1:]:
        for a, b in zip(r.results, runs[0].results):
            assert a.fits == b.fits
            assert all(torch.equal(x, y)
                       for x, y in zip(a.factors, b.factors))
    with pytest.raises(ValueError, match="capacity"):
        tbatched.batched_cp_als(ats, views, [x.dims for x in xs], RANK,
                                plan=plan, capacity=1)
    assert tbatched.batched_cp_als([], [], [], RANK, plan=plan).results == []
    assert tbatched.batched_cp_apr([], [], [], RANK, plan=plan).results == []


def test_empty_and_singleton_tenants_match_the_jax_package():
    empty = JSparse((6, 5, 4), np.zeros((0, 3), np.int32),
                    np.zeros((0,), np.float32))
    single = JSparse((6, 5, 4), np.array([[2, 3, 1]], np.int32),
                     np.array([2.5], np.float32))
    xs = [empty, single, jsyn.uniform_tensor((8, 5, 4), 60, seed=9,
                                             count_data=True)]
    sc_j, sc_t = _classes(xs)
    jp = jplan.make_class_plan(sc_j, backend="reference")
    tp = tplan.make_class_plan(sc_t, backend="cuda")
    inits = _als_inits(xs, 13)
    ref = jbatched.batched_cp_als(
        *_jax_members(xs, sc_j, jp), [x.dims for x in xs], RANK, plan=jp,
        n_iters=6, tol=1e-5,
        init_factors=[[jnp.asarray(f) for f in fs] for fs in inits])
    got = tbatched.batched_cp_als(
        *_port_members(xs, sc_t, tp), [x.dims for x in xs], RANK, plan=tp,
        n_iters=6, tol=1e-5,
        init_factors=[[torch.from_numpy(f) for f in fs] for fs in inits])
    assert got.results[0].fits == [1.0, 1.0]          # the zero model
    assert not any(A.any() for A in got.results[0].factors)
    for g, r in zip(got.results, ref.results):
        assert g.n_iters == r.n_iters
        np.testing.assert_allclose(g.fits, r.fits, rtol=1e-4, atol=0)
    apr = tbatched.batched_cp_apr(
        *_port_members(xs, sc_t, tp), [x.dims for x in xs], RANK, plan=tp,
        params=tcpapr.CpaprParams(k_max=3))
    e = apr.results[0]            # λ = 0, then 1: the zero model in two
    assert e.n_outer == 2 and e.kkt_violations[-1] == 0.0
    assert not any(A.any() for A in e.factors)
    assert all(np.isfinite(r.kkt_violations).all() for r in apr.results)


def test_sweep_set_ups_count_classes_not_tenants():
    xs = _bucket(ALS_BUCKET)
    _, sc = _classes(xs)
    plan = tplan.make_class_plan(sc, backend="cuda")
    ats, views = _port_members(xs, sc, plan)
    tbatched.sweep_cache_clear()
    for bucket in ([0], [1], [0, 1]):
        tbatched.batched_cp_als([ats[i] for i in bucket],
                                [views[i] for i in bucket],
                                [xs[i].dims for i in bucket], RANK,
                                plan=plan, n_iters=1, capacity=2)
    assert tbatched.sweep_traces()["als"] == 1


# ---------------------------------------------------------------------------
# The tenant axis of the kernels' plain paths
# ---------------------------------------------------------------------------

T, BM, R = 4, 8, 8
DIMS = (20, 6, 5)


@pytest.fixture(scope="module")
def stacked():
    """T tenants' sorted streams, tenant t's last row equal to tenant
    t + 1's first."""
    enc = talto.make_encoding(DIMS)
    rng = np.random.default_rng(4)
    M = 5 * BM
    rows, words, values = [], [], []
    first = 2
    for _ in range(T):
        r = np.sort(rng.integers(first, 15, M)).astype(np.int32)
        r[0] = first
        first = int(r[-1])
        c = np.stack([r, rng.integers(0, 6, M), rng.integers(0, 5, M)], 1)
        rows.append(torch.from_numpy(r))
        words.append(tenc.words_from_np(tenc.linearize_np(enc, c)))
        values.append(torch.from_numpy(rng.random(M).astype(np.float32)))
    g = torch.Generator().manual_seed(0)
    facs = [torch.rand((T, I, R), generator=g) + 0.1 for I in DIMS]
    B = torch.rand((T, DIMS[0], R), generator=g) + 0.1
    pi = torch.rand((T, M, R), generator=g)
    return (enc, torch.stack(rows), torch.stack(words), torch.stack(values),
            facs, B, pi)


def _per_tenant(fn, *args):
    parts = [fn(*(a[t] if isinstance(a, torch.Tensor)
                  else [x[t] for x in a] if isinstance(a, list) else a
                  for a in args)) for t in range(T)]
    if isinstance(parts[0], tuple):
        return tuple(torch.stack(z) for z in zip(*parts))
    return torch.stack(parts)


def _equal(a, b):
    if isinstance(a, tuple):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    else:
        assert torch.equal(a, b)


def test_stacked_rows_share_a_row_across_tenants(stacked):
    _, rows = stacked[:2]
    assert all(rows[t, -1] == rows[t + 1, 0] for t in range(T - 1))


@pytest.mark.parametrize("kernel", ["carry_runs", "oriented_partials"])
def test_stacked_mttkrp_runs_pass_equals_per_tenant(stacked, kernel):
    enc, rows, words, values, facs = stacked[:5]
    fn = getattr(kori, kernel)
    got = fn(enc, 0, rows, words, values, facs, BM)
    _equal(got, _per_tenant(lambda *a: fn(enc, 0, *a, BM), rows, words,
                            values, facs))


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("kernel", ["phi_carry_runs",
                                    "phi_oriented_partials"])
def test_stacked_phi_runs_pass_equals_per_tenant(stacked, kernel, policy):
    enc, rows, words, values, facs, B, pi = stacked
    fn = getattr(kori, kernel)
    kw = "pi" if policy == "pre" else "factors"
    op = pi if policy == "pre" else facs
    got = fn(enc, 0, 1e-10, rows, words, values, B, block_m=BM,
             **{kw: op})
    _equal(got, _per_tenant(
        lambda r, w, v, b, o: fn(enc, 0, 1e-10, r, w, v, b, block_m=BM,
                                 **{kw: o}), rows, words, values, B, op))


def test_stacked_split_and_fixup_equal_per_tenant(stacked):
    enc, rows, words, values, facs = stacked[:5]
    part = kori.oriented_partials(enc, 0, rows, words, values, facs, BM)
    split = kori.segment_split(part, rows, DIMS[0])
    _equal(split, _per_tenant(lambda p, r: kori.segment_split(p, r,
                                                              DIMS[0]),
                              part, rows))
    out, crow, cval = split
    merged = kori.carry_fixup(crow, cval, out.clone())
    _equal(merged, _per_tenant(kori.carry_fixup, crow, cval, out.clone()))
    _equal(tops.segment_merge(part, rows, DIMS[0]), merged)
    carry = kori.mttkrp_oriented_carry(enc, 0, rows, words, values, facs,
                                       BM)
    _equal(carry, merged)                  # K1 ≡ K2 + merge, per tenant


def test_concatenated_carries_would_join_tenants(stacked):
    """What the tenant axis prevents: one walk over all tenants' carries
    continues tenant t's last chain into tenant t + 1's first (their rows
    are equal), so a row of tenant t + 1 would receive tenant t's
    pieces."""
    enc, rows, words, values, facs = stacked[:5]
    out, crow, cval = kori.carry_runs(enc, 0, rows, words, values, facs, BM)
    axis = kori.carry_fixup(crow, cval, out.clone())
    nb = crow.shape[1]
    joined = torch.zeros((DIMS[0], R))
    kori.carry_fixup(crow.reshape(T * nb, 2), cval.reshape(T * nb, 2, R),
                     joined)
    shared = int(rows[0, -1])
    assert not torch.equal(joined[shared], axis[1, shared])


def test_pi_rows_of_a_bucket_equal_the_solo_rows(stacked):
    enc, _, words, _, facs = stacked[:5]
    for mode in range(3):
        got = tops.pi_rows(enc, words, facs, mode)
        want = torch.stack([tmttkrp.krp_rows(
            tops.delinearize(enc, words[t]), [f[t] for f in facs], mode)
            for t in range(T)])
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Recursive modes in a bucket (K3, K7 and the pull on the tenant axis)
# ---------------------------------------------------------------------------

def _route(plan, modes):
    """``plan`` (either package's) with ``modes`` routed recursive, their
    tiles kept: the forced class plan of a bucket with recursive modes."""
    return dataclasses.replace(plan, modes=tuple(
        dataclasses.replace(m, traversal=type(m.traversal).RECURSIVE)
        if m.mode in modes else m for m in plan.modes))


RECURSIVE = [(0,), (1, 2), (0, 1, 2)]


@pytest.mark.parametrize("modes", RECURSIVE)
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_recursive_bucket_cp_als_matches_the_jax_package(backend, modes):
    xs = _bucket(ALS_BUCKET)
    sc_j, sc_t = _classes(xs)
    jp = _route(jplan.make_class_plan(sc_j, backend="reference"), modes)
    tp = _route(tplan.make_class_plan(sc_t, backend=backend), modes)
    inits = _als_inits(xs, 21)
    ref = jbatched.batched_cp_als(
        *_jax_members(xs, sc_j, jp), [x.dims for x in xs], RANK, plan=jp,
        n_iters=4, tol=0.0, capacity=3,
        init_factors=[[jnp.asarray(f) for f in fs] for fs in inits])
    ats, views = _port_members(xs, sc_t, tp)
    assert all(set(v) == set(range(3)) - set(modes) for v in views)
    got = tbatched.batched_cp_als(
        ats, views, [x.dims for x in xs], RANK, plan=tp, n_iters=4,
        tol=0.0, capacity=3,
        init_factors=[[torch.from_numpy(f) for f in fs] for fs in inits])
    assert got.n_sweeps == ref.n_sweeps == 4
    for g, r in zip(got.results, ref.results):
        np.testing.assert_allclose(g.fits, r.fits, rtol=1e-4, atol=0)
        for a, b in zip(g.factors, r.factors):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_recursive_bucket_cp_apr_matches_the_jax_package(backend, policy,
                                                         monkeypatch):
    xs = _bucket(APR_BUCKET, count_data=True)
    sc_j, sc_t = _classes(xs)
    modes = (0, 2)
    jp = _route(jplan.make_class_plan(sc_j, backend="reference"), modes)
    jp = dataclasses.replace(jp, pi_policy=type(jp.pi_policy)(policy))
    tp = dataclasses.replace(
        _route(tplan.make_class_plan(sc_t, backend=backend), modes),
        pi_policy=theur.PiPolicy(policy))
    inits = _apr_inits(xs, 22)
    by_dims = {tuple(x.dims): init for x, init in zip(xs, inits)}

    def jax_init(dims, rank, seed=0, total=1.0, dtype=jnp.float32):
        lam, fs = by_dims[tuple(dims)]
        return jnp.asarray(lam), [jnp.asarray(f) for f in fs]
    monkeypatch.setattr(jcpapr, "init_factors", jax_init)
    ref = jbatched.batched_cp_apr(
        *_jax_members(xs, sc_j, jp), [x.dims for x in xs], RANK, plan=jp,
        params=jcpapr.CpaprParams(k_max=4), capacity=3)
    got = tbatched.batched_cp_apr(
        *_port_members(xs, sc_t, tp), [x.dims for x in xs], RANK, plan=tp,
        params=tcpapr.CpaprParams(k_max=4), capacity=3,
        init_factors=[(torch.from_numpy(lam),
                       [torch.from_numpy(f) for f in fs])
                      for lam, fs in inits])
    for x, g, r in zip(xs, got.results, ref.results):
        assert (g.n_outer, g.n_inner_total) == (r.n_outer, r.n_inner_total)
        assert g.traversals == list(tp.traversals())
        np.testing.assert_allclose(g.kkt_violations, r.kkt_violations,
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.lam.numpy(), np.asarray(r.lam),
                                   rtol=1e-5, atol=0)
        for a, b in zip(g.factors, r.factors):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
        ll_t = tcpapr.log_likelihood(
            talto.build(_port(x), device="cpu"), g.lam, g.factors)
        ll_j = jcpapr.log_likelihood(jalto.build(x), r.lam, r.factors)
        np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-5)


@pytest.mark.parametrize("algorithm", ["als", "otf", "pre"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_recursive_bucket_equals_solo_on_padded_bitwise(backend, algorithm):
    apr = algorithm != "als"
    xs = _bucket(APR_BUCKET if apr else ALS_BUCKET, count_data=apr)
    _, sc = _classes(xs)
    plan = _route(tplan.make_class_plan(sc, backend=backend), (0, 2))
    if apr:
        plan = dataclasses.replace(plan,
                                   pi_policy=theur.PiPolicy(algorithm))
    ats, views = _port_members(xs, sc, plan)
    dims = [x.dims for x in xs]
    if apr:
        p = tcpapr.CpaprParams(k_max=4, tau=0.05)
        res = tbatched.batched_cp_apr(ats, views, dims, RANK, plan=plan,
                                      params=p, seeds=[3, 4], capacity=3)
    else:
        res = tbatched.batched_cp_als(ats, views, dims, RANK, plan=plan,
                                      n_iters=4, tol=0.0, seeds=[3, 4],
                                      capacity=3)
    for i, x in enumerate(xs):
        if apr:
            lam, fs = tcpapr.init_factors(x.dims, RANK, seed=3 + i,
                                          total=float(ats[i].values.sum()),
                                          device="cpu")
            solo = tcpapr.cp_apr(ats[i], RANK, p, plan=plan, views=views[i],
                                 factors=tbatched.embed_factors(fs, sc.dims),
                                 lam=lam)
            assert res.results[i].kkt_violations == solo.kkt_violations
            assert (res.results[i].n_inner_total, res.results[i].n_outer) \
                == (solo.n_inner_total, solo.n_outer)
        else:
            fs = tcpals.init_factors(x.dims, RANK, seed=3 + i, device="cpu")
            solo = tcpals.cp_als(ats[i], RANK, n_iters=4, tol=0.0,
                                 plan=plan, views=views[i],
                                 factors=tbatched.embed_factors(fs, sc.dims))
            assert res.results[i].fits == solo.fits
        _assert_solo_bits(res.results[i], solo, x.dims)


def test_recursive_bucket_freezes_a_converged_tenant():
    """`test_convergence_freezes_a_converged_tenant` with every mode
    recursive: the frozen tenant equals its solo early-stopped run."""
    rng = np.random.default_rng(0)
    u, v, w = (rng.random(9) + 0.5, rng.random(7) + 0.5, rng.random(5) + 0.5)
    dense = np.einsum("i,j,k->ijk", u, v, w).astype(np.float32)
    coords = np.argwhere(rng.random(dense.shape) < 0.4).astype(np.int32)[:100]
    easy = TSparse((9, 7, 5), coords, dense[tuple(coords.T)])
    hard = _port(jsyn.uniform_tensor((12, 6, 8), 128, seed=7))
    sc = tsc.ShapeClass(dims=(16, 8, 8), nnz=128, n_partitions=8, rank=1)
    plan = _route(tplan.make_class_plan(sc, backend="cuda"), (0, 1, 2))
    ats, views = [], []
    for x in (easy, hard):
        at = tsc.canonicalize_tensor(talto.build_device(
            tsc.pad_to_class(x, sc), n_partitions=8, compute_reuse=False,
            device="cpu"), sc)
        ats.append(at)
        views.append(tplan.build_views(at, plan))
    assert views == [{}, {}]
    res = tbatched.batched_cp_als(ats, views, [easy.dims, hard.dims], 1,
                                  plan=plan, n_iters=20, tol=1e-4,
                                  capacity=2)
    easy_r, hard_r = res.results
    assert easy_r.n_iters < hard_r.n_iters == res.n_sweeps
    init = tcpals.init_factors(easy.dims, 1, seed=0, device="cpu")
    solo = tcpals.cp_als(ats[0], 1, n_iters=20, tol=1e-4, plan=plan,
                         views=views[0],
                         factors=tbatched.embed_factors(init, sc.dims))
    assert easy_r.fits == solo.fits and easy_r.n_iters == solo.n_iters
    _assert_solo_bits(easy_r, solo, easy.dims)


@pytest.mark.parametrize("algorithm", ["als", "apr"])
def test_recursive_bucket_quarantines_a_poisoned_slot(algorithm):
    """A poisoned slot of a bucket with recursive modes rolls back and
    freezes; its mates keep the clean bucket's bits."""
    apr = algorithm == "apr"
    xs = _bucket(APR_BUCKET if apr else ALS_BUCKET, count_data=apr)
    _, sc = _classes(xs)
    plan = _route(tplan.make_class_plan(sc, backend="cuda"), (0, 2))
    ats, views = _port_members(xs, sc, plan)
    dims = [x.dims for x in xs]

    def run():
        if apr:
            return tbatched.batched_cp_apr(
                ats, views, dims, RANK, plan=plan, seeds=[1, 2],
                params=tcpapr.CpaprParams(k_max=3), capacity=3, guard=True)
        return tbatched.batched_cp_als(ats, views, dims, RANK, plan=plan,
                                       n_iters=4, tol=0.0, seeds=[1, 2],
                                       capacity=3, guard=True)
    tfaults.reset()
    clean = run()
    tfaults.arm("batched.nan", data={"tenant": 1}, after=1)
    try:
        got = run()
    finally:
        tfaults.reset()
    assert clean.quarantined == [False, False]
    assert got.quarantined == [False, True]
    a, c = got.results[0], clean.results[0]
    assert all(torch.equal(x, y) for x, y in zip(a.factors, c.factors))
    assert torch.equal(a.lam, c.lam)
    bad = got.results[1]
    assert all(torch.isfinite(f).all() for f in bad.factors)
    if apr:                 # rolled back to before its first outer iteration
        assert bad.kkt_violations == []
    else:                   # rolled back to its first sweep
        assert bad.fits == clean.results[1].fits[:1]


def test_a_bucket_refuses_a_streaming_plan():
    xs = _bucket(ALS_BUCKET)
    _, sc = _classes(xs)
    plan = tplan.make_class_plan(sc, backend="cuda")
    ats, views = _port_members(xs, sc, plan)
    streamed = dataclasses.replace(plan, streaming=tplan.StreamPlan(
        chunk_m=64, n_chunks=2, device_bytes=1, stream_bytes=2))
    with pytest.raises(ValueError, match="streaming plan"):
        tbatched.batched_cp_als(ats, views, [x.dims for x in xs], RANK,
                                plan=streamed)


@pytest.mark.parametrize("modes", [()] + RECURSIVE)
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_a_bucket_stacks_streams_only_for_recursive_modes(backend, modes):
    """The ALTO streams are stacked only when some mode runs recursive,
    and the members' pull orders (kernel backend) only for those modes,
    each its members' cached orders stacked."""
    xs = _bucket(ALS_BUCKET)
    _, sc = _classes(xs)
    plan = _route(tplan.make_class_plan(sc, backend=backend), modes)
    ats, views = _port_members(xs, sc, plan)
    views_b = tbatched.stack_tenants(tbatched._fill(views, 4))
    at_b, pulls = tbatched._streams(plan, ats, views_b, 4)
    if not modes:
        assert at_b is None and pulls == {}
        return
    members = tbatched._fill(ats, 4)
    assert torch.equal(at_b.words, torch.stack([a.words for a in members]))
    assert sorted(pulls) == (sorted(modes) if backend == "cuda" else [])
    for n, order in pulls.items():
        for t, at in enumerate(members):
            _assert_solo_then_padding(order, t, tviews.get_pull_order(at, n))


def _assert_solo_then_padding(order, t, solo):
    """Tenant ``t`` of a stacked pull order is its solo order up to the
    solo's own length, then padding: pieces on its last row that take a
    Temp row the solo order leaves out."""
    n = solo.order.shape[0]
    assert torch.equal(order.rows[t, :n], solo.rows)
    assert torch.equal(order.order[t, :n], solo.order)
    assert bool((order.rows[t, n:] == solo.rows[-1]).all())
    assert not bool(torch.isin(order.order[t, n:], solo.order).any())


@pytest.fixture(scope="module")
def rec_bucket():
    """Three members of one class (the APR bucket and a third), stacked,
    with stacked factors, B and Π in ALTO order."""
    xs = _bucket(APR_BUCKET + [("uniform_tensor", (14, 8, 7), 120, 9)],
                 count_data=True)
    _, sc = _classes(xs)
    plan = tplan.make_class_plan(sc, backend="cuda")
    ats, _ = _port_members(xs, sc, plan)
    at_b = tbatched.stack_tenants(ats)
    g = torch.Generator().manual_seed(3)
    facs = [torch.rand((len(ats), I, 8), generator=g) + 0.1
            for I in sc.dims]
    B = [torch.rand((len(ats), I, 8), generator=g) + 0.1 for I in sc.dims]
    return ats, at_b, facs, B


def _stacked_and_solo(kind, ats, at_b, facs, B, mode):
    """The stacked call of ``kind`` and its per-tenant calls, stacked."""
    enc, T_rows = at_b.meta.enc, at_b.meta.temp_rows[mode]

    def call(at, f, b):
        if kind == "k3":
            return tk3.recursive_partials(enc, mode, T_rows, at.words,
                                          at.values, at.part_start, f,
                                          r_block=4)
        operand = (dict(factors=f) if kind == "k7-otf" else
                   dict(pi=tops.pi_rows(enc, at.words, f, mode)
                        if at.words.dim() == 3 else tmttkrp.krp_rows(
                            tops.delinearize(enc, at.words), f, mode)))
        if kind == "pull":
            order = None if at is not at_b else tviews.stack_pull_orders(
                [tviews.get_pull_order(a, mode) for a in ats])
            return tops.cpapr_phi(at, b[mode], mode, eps=1e-10,
                                  order=order, **operand)
        return tk7.phi_partials(enc, mode, T_rows, 1e-10, at.words,
                                at.values, at.part_start, b[mode],
                                **operand)
    got = call(at_b, facs, B)
    want = torch.stack([call(at, [f[t] for f in facs], [b[t] for b in B])
                        for t, at in enumerate(ats)])
    return got, want


@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("kind", ["k3", "k7-otf", "k7-pre", "pull"])
def test_stacked_recursive_kernels_equal_per_tenant(rec_bucket, kind, mode):
    ats, at_b, facs, B = rec_bucket
    got, want = _stacked_and_solo(kind, ats, at_b, facs, B, mode)
    assert got.shape[0] == len(ats)
    assert torch.equal(got, want)


def test_stacked_mttkrp_and_pull_equal_per_tenant(rec_bucket):
    """`ops.mttkrp` on the stacked tensor: K3 on the tenant axis, then the
    pull of each tenant in its member's cached order (stacked by the
    caller, `views.stack_pull_orders`), each the bits of its solo call.
    The stacked tensor has no cached order of its own."""
    ats, at_b, facs, _ = rec_bucket
    for mode in range(3):
        order = tviews.stack_pull_orders(
            [tviews.get_pull_order(at, mode) for at in ats])
        got = tops.mttkrp(at_b, facs, mode, order=order)
        want = torch.stack([tops.mttkrp(at, [f[t] for f in facs], mode)
                            for t, at in enumerate(ats)])
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="stack_pull_orders"):
            tviews.get_pull_order(at_b, mode)
        for t, at in enumerate(ats):
            _assert_solo_then_padding(order, t,
                                      tviews.get_pull_order(at, mode))
        temp = tk3.recursive_partials(
            at_b.meta.enc, mode, at_b.meta.temp_rows[mode], at_b.words,
            at_b.values, at_b.part_start, facs)
        assert torch.equal(
            tops.pull_reduction(temp, at_b.part_start[..., mode],
                                at_b.meta.dims[mode]), got)
