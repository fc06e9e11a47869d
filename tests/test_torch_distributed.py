"""Port parity: row-range-sharded CP-ALS, CP-APR and ingest over gloo
ranks on the CPU (`repro_torch.dist.cpd`), against the port's
single-device runs and the JAX package.

The ranks are spawned processes (`tests/torch_ranks.py`, one CPU thread
each, a file rendezvous per test) that run the kernels' plain versions:
one job per group size runs every path, and the tests read its results.
The JAX references run here on one device. Tolerances:

* one rank: the single-device run under the same plan, bit for bit;
* two ranks: every MTTKRP the in-process sum of the two slices, bit for
  bit (``s0 + s1`` does not depend on the order of the sum); more ranks
  within ``rtol=1e-6`` of it (the collective's order is its own);
* CP-ALS fits within 1e-4 absolute of the port's single-device run, of
  the JAX `distributed_cp_als` on a one-device mesh and of JAX `cp_als`,
  from the same numpy start (float32 sums in other orders, LAPACK's pinv
  against XLA's);
* CP-APR log-likelihoods within 1e-5 relative of the JAX package's
  (`tests/test_torch_cpapr.py`'s tolerance);
* `sharded_append_delta` bit for bit `append_delta`, a delta shorter
  than the group included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.core import alto as jalto
from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro.core import plan as jplan
from repro.dist import cpd as jcpd
from repro.sparse import synthetic as jsyn
from repro_torch.core import cpals as tcpals
from repro_torch.core import plan as tplan

R = torch_ranks.RANK
WORLDS = (1, 2, 4, 8)
ITERS = 4


def _als_start():
    rng = np.random.default_rng(7)
    return [rng.random((I, R)).astype(np.float32)
            for I in torch_ranks.ALS_DIMS]


def _apr_state():
    rng = np.random.default_rng(3)
    fs = [rng.random((I, R)).astype(np.float32) + np.float32(0.1)
          for I in torch_ranks.APR_DIMS]
    at = torch_ranks.apr_tensor()
    lam = np.full(R, float(at.values.sum()) / R, np.float32)
    return lam, fs


def _deltas():
    """A 1 % delta growing mode 0, and one of 3 nonzeros (shorter than the
    4- and 8-rank groups; 1 nonzero is shorter than 2)."""
    rng = np.random.default_rng(11)
    dims = torch_ranks.ALS_DIMS
    big = np.stack([rng.integers(0, I + (4 if n == 0 else 0), 40)
                    for n, I in enumerate(dims)], axis=1).astype(np.int32)
    small = np.array([[3, 5, 7], [29, 0, 24], [1, 39, 2]], np.int32)
    return [(big, rng.random(40).astype(np.float32)),
            (small, np.float32([1.5, -2.0, 0.25])),
            (small[:1], np.float32([4.0]))]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The `torch_ranks.job_cpd` results of every group size."""
    tmp = tmp_path_factory.mktemp("ranks")
    return {w: torch_ranks.run("job_cpd", w, tmp, _als_start(),
                               _apr_state(), _deltas(), timeout=180)
            for w in WORLDS}


@pytest.fixture(scope="module")
def references():
    """The port's single-device CP-ALS and the JAX package's runs."""
    fs = _als_start()
    at = torch_ranks.als_tensor()
    p = tplan.make_plan(at.meta, R, backend="cuda")
    port = tcpals.cp_als(at, R, n_iters=ITERS, tol=0.0,
                         factors=[torch.from_numpy(A) for A in fs], plan=p)
    x, _ = jsyn.sparse_lowrank(torch_ranks.ALS_DIMS, rank=R,
                               col_support=0.3, seed=2)
    jat = jalto.build(x, n_partitions=8)
    assert np.array_equal(np.asarray(jat.words).view(np.int32),
                          at.words.numpy())
    mesh = jax.make_mesh((1,), ("data",))
    _, _, jdist = jcpd.distributed_cp_als(
        jat, R, mesh, n_iters=ITERS, tol=0.0, backend="reference",
        warm_start=[jnp.asarray(A) for A in fs])
    jsingle = jcpals.cp_als(
        jat, R, n_iters=ITERS, tol=0.0, factors=[jnp.asarray(A) for A in fs],
        plan=jplan.make_plan(jat.meta, R, backend="reference"))
    xa = jsyn.uniform_tensor(torch_ranks.APR_DIMS, 250, seed=4,
                             count_data=True)
    jat_a = jalto.build(xa, n_partitions=2)
    lam, fs_a = _apr_state()
    apr = {}
    for policy in ("otf", "pre"):
        ref = jcpapr.cp_apr(
            jat_a, R, params=jcpapr.CpaprParams(k_max=3), pi_policy=policy,
            track_ll=True, plan=jplan.make_plan(jat_a.meta, R, mesh=mesh,
                                                backend="reference"),
            warm_start=(jnp.asarray(lam), [jnp.asarray(A) for A in fs_a]))
        apr[policy] = ref.log_likelihoods
    return {"port": port.fits, "jax_dist": jdist, "jax": jsingle.fits,
            "apr": apr}


def test_one_rank_is_the_single_device_run(groups):
    """World size 1: fits, factors and λ bit for bit `cp_als` under the
    same plan without shards."""
    (res,) = groups[1]
    fits, factors, lam = res["single"]
    assert res["fits"] == fits
    assert all(torch.equal(a, b) for a, b in zip(res["factors"], factors))
    assert torch.equal(res["lam"], lam)


@pytest.mark.parametrize("world", WORLDS)
def test_mttkrp_is_the_in_process_sum(groups, world):
    """Every rank's all-reduced MTTKRP against the sum in rank order of
    the slices computed in one process: bit for bit up to two ranks,
    within rtol=1e-6 past that."""
    for res in groups[world]:
        for got, ref in zip(res["mttkrp"], res["mttkrp_in_process"]):
            if world <= 2:
                assert torch.equal(got, ref)
            else:
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 *
                                           float(ref.abs().max()))


@pytest.mark.parametrize("world", WORLDS)
def test_fits_match_single_device_and_jax(groups, references, world):
    """CP-ALS fits within 1e-4 of the port's single-device run, the JAX
    one-device-mesh `distributed_cp_als` and JAX `cp_als`, and the same
    on every rank."""
    fits = groups[world][0]["fits"]
    assert len(fits) == ITERS
    for res in groups[world][1:]:
        assert res["fits"] == fits
    for ref in ("port", "jax_dist", "jax"):
        np.testing.assert_allclose(fits, references[ref], rtol=0, atol=1e-4,
                                   err_msg=ref)


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("world", WORLDS)
def test_cp_apr_matches_jax(groups, references, world, policy):
    """CP-APR under a sharded plan: log-likelihoods within 1e-5 relative
    of the JAX package's (one-device mesh), the same on every rank."""
    lls, _ = groups[world][0][f"apr_{policy}"]
    for res in groups[world][1:]:
        assert res[f"apr_{policy}"][0] == lls
    np.testing.assert_allclose(lls, references["apr"][policy], rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_append_is_append_delta(groups, world):
    """`sharded_append_delta` bit for bit `append_delta` on every rank:
    words, values, partition boxes and meta, a delta shorter than the
    group included."""
    for res in groups[world]:
        assert [n for n, _ in res["appends"]] == [40, 3, 1]
        assert all(ok for _, ok in res["appends"]), res["appends"]


def test_wrong_group_size_raises(groups):
    for world in (1, 2):
        for res in groups[world]:
            assert res["wrong_group"] is not None
            assert f"made for {world + 1} shards" in res["wrong_group"]


def test_tuned_plan_is_rank0s_and_stored_once(tmp_path):
    """A sharded tune on two ranks: every rank gets the same oriented
    plan, only rank 0 writes the store, and a second make is a store hit
    with no timing run."""
    res = torch_ranks.run("job_tune", 2, tmp_path,
                          str(tmp_path / "plans.json"), timeout=180)
    assert res[0]["modes"] == res[1]["modes"]
    assert all(r["shards"] == 2 for r in res)
    assert all(m.traversal.value.startswith("oriented")
               for m in res[0]["modes"])
    assert [r["writes"] for r in res] == [1, 0]
    assert all(r["again_runs"] == 0 and r["again_same"] for r in res)
