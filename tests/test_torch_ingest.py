"""Port parity: incremental ingest (`core.ingest`), the merge reference in
`core.alto`, warm starts and surgical view invalidation.

* `append_delta` and `append_linearized` equal the JAX package's
  `ingest.append_delta` bit for bit — words, values, partition boxes and
  `AltoMeta` — under both duplicate policies, with and without extent
  growth (which re-encodes the resident words), and with an empty delta;
  `alto.merge_reference` (the host rebuild) equals `append_delta`.
* `grow_factors` keeps the warm rows bit for bit and refuses a shrink or
  another rank; ``positive=True`` gives unit-sum columns.
* Warm-start `cp_als` / `cp_apr` from the same numpy warm factors as the
  JAX drivers, without growth: fits within 1e-4, log-likelihoods within
  1e-5 relative (the parity rules of the drivers' own tests).
* `views.invalidate_changed` drops as many cached entries as the JAX
  package's: none after a no-op append, every mode after a content one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro.core import encoding as jenc
from repro.core import ingest as jingest
from repro.core import views as jviews
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch.core import alto as talto
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import encoding as tenc
from repro_torch.core import ingest as tingest
from repro_torch.core import views as tviews
from repro_torch.sparse.tensor import SparseTensor as TSparse

DIMS = (6, 7, 8)


def _coo(dims, nnz, seed, lo=0, hi=None, dup=0):
    rng = np.random.default_rng(seed)
    hi = hi or dims
    coords = np.stack([rng.integers(lo, h, nnz) for h in hi],
                      axis=1).astype(np.int32)
    if dup and nnz > 4:
        coords[-dup:] = coords[:dup]
    return coords, rng.standard_normal(nnz).astype(np.float32)


CASES = {
    "plain": dict(M=40, D=12),
    "empty_delta": dict(M=40, D=0),
    "empty_resident": dict(M=0, D=12),
    "cross_duplicates": dict(M=40, D=12, cross=5, dup=8),
    "dup_heavy_delta": dict(M=20, D=30, cross=10, dup=15),
    "extent_growth": dict(M=40, D=12, grow=(3, 0, 9)),
    "two_words": dict(M=60, D=20, dims=(300, 300, 300, 300)),
    "two_words_growth": dict(M=60, D=20, dims=(300, 300, 300, 300),
                             grow=(0, 70000, 0, 0)),
    "one_partition": dict(M=25, D=9, L=1),
    "more_partitions_than_nnz": dict(M=3, D=2, L=16),
}


def _case(name):
    c = CASES[name]
    dims = c.get("dims", DIMS)
    coords, values = _coo(dims, c["M"], seed=len(name), dup=c.get("dup", 0))
    x = JSparse(dims, coords, values)
    hi = (tuple(d + g for d, g in zip(dims, c["grow"])) if "grow" in c
          else dims)
    dc, dv = _coo(dims, c["D"], seed=len(name) + 7, hi=hi)
    if c.get("cross") and c["M"] and c["D"]:
        dc[:c["cross"]] = coords[:c["cross"]]          # resident duplicates
    L = c.get("L", 4)
    return (jalto.build_device(x, n_partitions=L),
            talto.build_device(TSparse(dims, coords, values),
                               n_partitions=L, device="cpu"), dc, dv)


def _assert_same(got, ref):
    m, r = got.meta, ref.meta
    assert (m.dims, m.nnz, m.n_partitions, m.temp_rows) == \
        (r.dims, r.nnz, r.n_partitions, r.temp_rows)
    assert m.enc.bit_mode == r.enc.bit_mode
    np.testing.assert_array_equal(m.fiber_reuse, r.fiber_reuse)
    np.testing.assert_array_equal(tenc.words_to_np(got.words),
                                  np.asarray(ref.words))
    np.testing.assert_array_equal(got.values.numpy().view(np.uint32),
                                  np.asarray(ref.values).view(np.uint32))
    np.testing.assert_array_equal(got.part_start.numpy(),
                                  np.asarray(ref.part_start))
    np.testing.assert_array_equal(got.part_end.numpy(),
                                  np.asarray(ref.part_end))


@pytest.mark.parametrize("policy", ["sum", "last"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_append_delta_matches_the_jax_package(name, policy):
    jat, at, dc, dv = _case(name)
    ref = jingest.append_delta(jat, dc, dv, policy=policy)
    got = tingest.append_delta(at, dc, dv, policy=policy)
    _assert_same(got, ref)
    _assert_same(talto.merge_reference(at, dc, dv, policy=policy), ref)


@pytest.mark.parametrize("policy", ["sum", "last"])
@pytest.mark.parametrize("name", ["plain", "extent_growth",
                                  "two_words_growth"])
def test_append_linearized_matches_the_jax_package(name, policy):
    jat, at, dc, dv = _case(name)
    dims = jalto.grown_dims(jat.dims, dc)
    words = jenc.linearize_np(jenc.make_encoding(dims), dc)
    ref = jingest.append_linearized(jat, words, dv, dims, policy=policy)
    _assert_same(tingest.append_linearized(at, words, dv, dims,
                                           policy=policy), ref)
    _assert_same(tingest.append_delta(at, dc, dv, policy=policy), ref)


def test_merge_coo_and_grown_dims_match_the_jax_package():
    coords, values = _coo(DIMS, 30, seed=1, dup=10)
    x = JSparse(DIMS, coords, values)
    dc, dv = _coo(DIMS, 12, seed=2, hi=(9, 7, 8))
    dc[:4] = coords[:4]
    dc[-1] = (8, 6, 7)
    assert talto.grown_dims(DIMS, dc) == jalto.grown_dims(DIMS, dc) == \
        (9, 7, 8)
    with pytest.raises(ValueError, match="cover"):
        talto.grown_dims(DIMS, dc, override=(8, 7, 8))
    for policy in ("sum", "last"):
        ref = jalto.merge_coo(x, dc, dv, policy=policy)
        got = talto.merge_coo(TSparse(DIMS, coords, values), dc, dv,
                              policy=policy)
        assert got.dims == ref.dims
        np.testing.assert_array_equal(got.coords, ref.coords)
        np.testing.assert_array_equal(got.values, ref.values)
    with pytest.raises(ValueError, match="policy"):
        talto.merge_coo(TSparse(DIMS, coords, values), dc, dv, "max")


def test_append_chain_equals_one_rebuild():
    coords, values = _coo(DIMS, 30, seed=3)
    at = talto.build_device(TSparse(DIMS, coords, values), n_partitions=4,
                            device="cpu")
    d1 = _coo(DIMS, 8, seed=4, hi=(8, 7, 8))
    d2 = _coo(DIMS, 8, seed=5, hi=(6, 9, 8))
    two = tingest.append_delta(tingest.append_delta(at, *d1), *d2)
    once = tingest.append_delta(at, np.concatenate([d1[0], d2[0]]),
                                np.concatenate([d1[1], d2[1]]))
    for f in ("words", "values", "part_start", "part_end"):
        assert torch.equal(getattr(two, f), getattr(once, f))
    assert two.meta == once.meta


def test_grow_factors_keeps_rows_and_validates():
    rng = np.random.default_rng(6)
    lam = torch.from_numpy(rng.random(3).astype(np.float32))
    fs = [torch.from_numpy(rng.random((d, 3)).astype(np.float32))
          for d in (4, 5)]
    lam2, grown = tingest.grow_factors((lam, fs), (6, 5), 3, seed=2)
    assert torch.equal(lam2, lam)
    assert torch.equal(grown[0][:4], fs[0]) and torch.equal(grown[1], fs[1])
    again = tingest.grow_factors(fs, (6, 5), 3, seed=2)
    assert again[0] is None and torch.equal(again[1][0], grown[0])
    assert bool(((grown[0][4:] >= 0) & (grown[0][4:] < 1)).all())
    with pytest.raises(ValueError, match="shrank"):
        tingest.grow_factors((lam, fs), (3, 5), 3)
    with pytest.raises(ValueError, match="expected"):
        tingest.grow_factors((lam, fs), (4, 5), 2)
    with pytest.raises(ValueError, match="factors"):
        tingest.grow_factors((lam, [fs[0]]), (4, 5), 3)
    _, pos = tingest.grow_factors((lam, fs), (6, 5), 3, positive=True)
    assert pos[0].shape == (6, 3) and bool((pos[0] > 0).all())
    np.testing.assert_allclose(pos[0].sum(dim=0).numpy(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="not both"):
        tcpals.cp_als(talto.build_device(
            TSparse(DIMS, *_coo(DIMS, 20, seed=7)), n_partitions=2,
            device="cpu"), 3, factors=fs, warm_start=(lam, fs))


def _lowrank(dims, rank, nnz, seed, count_data=False):
    rng = np.random.default_rng(seed)
    fac = [rng.uniform(0.1, 1.0, (d, rank)) for d in dims]
    coords = np.stack([rng.integers(0, d, nnz) for d in dims],
                      axis=1).astype(np.int32)
    v = np.ones(nnz)
    for m, A in enumerate(fac):
        v = v * A[coords[:, m]].sum(axis=1)
    if count_data:
        v = np.maximum(1, np.round(v))
    return coords, v.astype(np.float32)


def test_warm_start_cp_als_matches_the_jax_package():
    dims = (14, 12, 10)
    coords, values = _lowrank(dims, 3, 250, seed=0)
    dc, dv = _lowrank(dims, 3, 6, seed=5)
    jat = jingest.append_delta(jalto.build_device(
        JSparse(dims, coords, values), n_partitions=4), dc, dv)
    at = tingest.append_delta(talto.build_device(
        TSparse(dims, coords, values), n_partitions=4, device="cpu"), dc, dv)
    rng = np.random.default_rng(8)
    lam = rng.uniform(1, 3, 3).astype(np.float32)
    fs = [rng.random((d, 3)).astype(np.float32) for d in dims]
    ref = jcpals.cp_als(jat, 3, n_iters=6, tol=0.0,
                        warm_start=(jnp.asarray(lam),
                                    [jnp.asarray(f) for f in fs]))
    got = tcpals.cp_als(at, 3, n_iters=6, tol=0.0,
                        warm_start=(torch.from_numpy(lam),
                                    [torch.from_numpy(f) for f in fs]))
    np.testing.assert_allclose(got.fits, ref.fits, rtol=1e-4, atol=0)
    cold = tcpals.cp_als(at, 3, n_iters=6, tol=0.0, seed=1)
    assert got.fits[0] != cold.fits[0]


def test_warm_start_cp_apr_matches_the_jax_package():
    dims = (12, 10, 9)
    coords, values = _lowrank(dims, 3, 220, seed=7, count_data=True)
    dc = _lowrank(dims, 3, 5, seed=8)[0]
    dv = np.ones(5, np.float32)
    jat = jingest.append_delta(jalto.build_device(
        JSparse(dims, coords, values), n_partitions=4), dc, dv)
    at = tingest.append_delta(talto.build_device(
        TSparse(dims, coords, values), n_partitions=4, device="cpu"), dc, dv)
    rng = np.random.default_rng(9)
    lam = np.full(3, float(values.sum()) / 3, np.float32)
    fs = [rng.random((d, 3)).astype(np.float32) + 0.1 for d in dims]
    p = jcpapr.CpaprParams(k_max=4)
    ref = jcpapr.cp_apr(jat, 3, params=p, track_ll=True,
                        warm_start=(jnp.asarray(lam),
                                    [jnp.asarray(f) for f in fs]))
    got = tcpapr.cp_apr(at, 3, params=tcpapr.CpaprParams(k_max=4),
                        track_ll=True,
                        warm_start=(torch.from_numpy(lam),
                                    [torch.from_numpy(f) for f in fs]))
    assert (got.n_outer, got.n_inner_total) == (ref.n_outer,
                                                ref.n_inner_total)
    np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods,
                               rtol=1e-5, atol=0)


def test_invalidate_changed_counts_match_the_jax_package():
    coords, values = _coo(DIMS, 40, seed=10)
    jat = jalto.build_device(JSparse(DIMS, coords, values), n_partitions=4)
    at = talto.build_device(TSparse(DIMS, coords, values), n_partitions=4,
                            device="cpu")
    dc, dv = _coo(DIMS, 5, seed=11)
    counts = []
    for views, ingest, a in ((jviews, jingest, jat), (tviews, tingest, at)):
        views.cache_clear()
        for mode in range(3):
            views.get_view(a, mode)
        noop = ingest.append_delta(a, np.zeros((0, 3), np.int32),
                                   np.zeros(0, np.float32),
                                   invalidate_stale=False)
        grown = ingest.append_delta(a, dc, dv, invalidate_stale=False)
        counts.append((views.invalidate_changed(a, noop),
                       views.invalidate_changed(a, grown),
                       views.cache_stats()["size"]))
        views.cache_clear()
    assert counts[1] == counts[0] == (0, 3, 0)
