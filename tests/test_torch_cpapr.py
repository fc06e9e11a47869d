"""Port parity: CP-APR end to end (paper Alg. 2), against the JAX package.

Both packages start from the same numpy state (λ and factors, the JAX
side through ``warm_start=``) on the same built tensor. The JAX side runs
its Pallas kernels in interpret mode; the port runs its kernel backend,
which on CPU tensors means the kernels' plain versions. Tolerances:
log-likelihoods within 1e-5 relative, KKT violations within 1e-4, factors
within 1e-4 absolute, λ within 1e-4 relative (λ carries the tensor's mass,
about 1e3 here, where one float32 step is 6e-5 to 1.2e-4), and the inner
and outer iteration counts equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import cpapr as jcpapr
from repro.core import plan as jplan
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import plan as tplan
from repro_torch.sparse import synthetic as tsyn

RANK = 4
K_MAX = 3


def _port_tensor(ref):
    m = ref.meta
    return interop.alto_tensor(
        np.asarray(ref.words), np.asarray(ref.values),
        np.asarray(ref.part_start), np.asarray(ref.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")


@pytest.fixture(scope="module")
def problem():
    # Modes 0 and 2 reuse fibers (recursive, K7), mode 1 does not (K5).
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=2, count_data=True)
    jat = jalto.build(x, n_partitions=8)
    rng = np.random.default_rng(3)
    fs = [rng.random((I, RANK)).astype(np.float32) + 0.1 for I in x.dims]
    lam = np.full(RANK, float(np.asarray(jat.values).sum()) / RANK,
                  np.float32)
    return jat, _port_tensor(jat), lam, fs


def _both(problem, policy, params):
    jat, at, lam, fs = problem
    jp = jplan.make_plan(jat.meta, RANK, backend="pallas", interpret=True)
    tp = tplan.make_plan(at.meta, RANK, backend="cuda")
    assert tp.traversals() == jp.traversals()
    assert {"recursive", "oriented_carry"} <= set(tp.traversals())
    ref = jcpapr.cp_apr(jat, RANK, params=params, pi_policy=policy,
                        track_ll=True, plan=jp,
                        warm_start=(jnp.asarray(lam),
                                    [jnp.asarray(f) for f in fs]))
    got = tcpapr.cp_apr(at, RANK, params=params, pi_policy=policy,
                        track_ll=True, plan=tp,
                        warm_start=(torch.from_numpy(lam),
                                    interop.factors(fs, device="cpu")))
    return ref, got


def _assert_close(ref, got):
    """λ is held relative: it carries the tensor's mass (about 1.2e3
    here), where one float32 step is 6e-5 to 1.2e-4. The measured gap is
    at most 1.2e-3 absolute, 1.0e-6 relative; the limit is 10× that."""
    assert (got.n_outer, got.n_inner_total) == (ref.n_outer,
                                                ref.n_inner_total)
    assert got.traversals == ref.traversals
    np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods,
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.kkt_violations, ref.kkt_violations,
                               rtol=0, atol=1e-4)
    for a, b in zip(got.factors, ref.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref.lam),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_cp_apr_matches_pallas_interpret(problem, policy):
    ref, got = _both(problem, policy, jcpapr.CpaprParams(k_max=K_MAX))
    assert got.pi_policy == policy
    assert got.n_inner_total == K_MAX * 3 * 10      # no mode froze
    _assert_close(ref, got)
    assert got.log_likelihoods[-1] > got.log_likelihoods[0]


@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_early_freeze_matches_scan(problem, tau):
    """With a larger tau modes freeze inside the inner loop (0.1) or the
    whole solve converges early (0.3): the host loop's break gives the
    masked scan's inner counts, B and Φ."""
    params = jcpapr.CpaprParams(k_max=K_MAX, tau=tau)
    ref, got = _both(problem, "otf", params)
    assert got.n_inner_total < got.n_outer * 3 * 10
    _assert_close(ref, got)


def test_log_likelihood_matches_reference(problem):
    jat, at, lam, fs = problem
    want = jcpapr.log_likelihood(jat, jnp.asarray(lam),
                                 [jnp.asarray(f) for f in fs])
    got = tcpapr.log_likelihood(at, torch.from_numpy(lam),
                                interop.factors(fs, device="cpu"))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_reference_backend_matches_kernel_backend(problem):
    """The default plan on the CPU (reference traversals) against the
    kernel backend's plain versions, both policies."""
    _, at, lam, fs = problem
    p = tcpapr.CpaprParams(k_max=2)
    for policy in ("otf", "pre"):
        runs = [tcpapr.cp_apr(at, RANK, params=p, pi_policy=policy,
                              track_ll=True, plan=plan,
                              factors=interop.factors(fs, device="cpu"))
                for plan in (tplan.make_plan(at.meta, RANK,
                                             backend="reference"),
                             tplan.make_plan(at.meta, RANK, backend="cuda"))]
        assert runs[0].plan.backend == "reference"
        assert runs[0].n_inner_total == runs[1].n_inner_total
        np.testing.assert_allclose(runs[0].log_likelihoods,
                                   runs[1].log_likelihoods, rtol=1e-5)


def test_quickstart_decomposition_on_cpu():
    x = tsyn.uniform_tensor((30, 24, 20), 800, seed=1, count_data=True)
    at = talto.build_device(x, n_partitions=8, device="cpu")
    res = tcpapr.cp_apr(at, 4, params=tcpapr.CpaprParams(k_max=4), seed=2,
                        track_ll=True)
    assert res.plan.pi_policy.value == res.pi_policy == "otf"
    lls = res.log_likelihoods
    assert all(np.isfinite(lls)) and lls[-1] > lls[0]
    assert all(np.isfinite(res.kkt_violations))
    for A in res.factors:
        assert float(A.min()) >= 0.0
        np.testing.assert_allclose(A.sum(dim=0).numpy(), 1.0, atol=1e-3)
    assert [tuple(A.shape) for A in res.factors] == [(I, 4) for I in x.dims]


def test_init_factors_seeded_and_degenerate_inputs():
    lam, a = tcpapr.init_factors((5, 6), 3, seed=4, total=6.0, device="cpu")
    _, b = tcpapr.init_factors((5, 6), 3, seed=4, total=6.0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a[0].min()) > 0.0
    np.testing.assert_allclose(a[1].sum(dim=0).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(lam.numpy(), 2.0)
    empty = tsyn.uniform_tensor((4, 5, 6), 0, seed=0)
    at = talto.build_device(empty, n_partitions=2, device="cpu")
    res = tcpapr.cp_apr(at, 3)
    assert res.n_outer == 0 and float(res.lam.abs().sum()) == 0.0
    x = tsyn.uniform_tensor((4, 5, 6), 30, seed=0, count_data=True)
    at = talto.build_device(x, n_partitions=2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        tcpapr.cp_apr(at, 3, plan=tplan.make_plan(at.meta, 2))
    with pytest.raises(ValueError, match="pi_policy"):
        tcpapr.cp_apr(at, 3, pi_policy="sometimes")
    with pytest.raises(ValueError, match="shape"):
        tcpapr.cp_apr(at, 3, factors=[torch.ones((4, 3))] * 3)
