"""Port parity: CP-ALS end to end, the main path of the port.

Both packages start from the same numpy factors on the same built tensor
(handed over through `repro_torch.interop`). The JAX side runs its Pallas
kernels in interpret mode; the port runs its kernel backend, which on CPU
tensors means the kernels' plain versions. Fits per iteration agree
within 1e-4 absolute over 5 iterations: float32 pinv from LAPACK against
XLA's, and sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import cpals as jcpals
from repro.core import plan as jplan
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import cpals as tcpals
from repro_torch.core import plan as tplan
from repro_torch.sparse import synthetic as tsyn

RANK = 4
ITERS = 5


def _port_tensor(ref):
    m = ref.meta
    return interop.alto_tensor(
        np.asarray(ref.words), np.asarray(ref.values),
        np.asarray(ref.part_start), np.asarray(ref.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")


@pytest.fixture(scope="module")
def problem():
    # Modes 0 and 2 reuse fibers (recursive), mode 1 does not (carry).
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=2, count_data=True)
    jat = jalto.build(x, n_partitions=8)
    rng = np.random.default_rng(7)
    fs = [rng.random((I, RANK)).astype(np.float32) for I in x.dims]
    return jat, _port_tensor(jat), fs


def test_fits_match_pallas_interpret(problem):
    jat, at, fs = problem
    jp = jplan.make_plan(jat.meta, RANK, backend="pallas", interpret=True)
    tp = tplan.make_plan(at.meta, RANK, backend="cuda")
    assert tp.traversals() == jp.traversals()
    assert len(set(tp.traversals())) > 1
    ref = jcpals.cp_als(jat, RANK, n_iters=ITERS, tol=0.0,
                        factors=[jnp.asarray(f) for f in fs], plan=jp)
    got = tcpals.cp_als(at, RANK, n_iters=ITERS, tol=0.0,
                        factors=interop.factors(fs, device="cpu"), plan=tp)
    assert len(got.fits) == len(ref.fits) == ITERS
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=1e-4)
    for a, b in zip(got.factors, ref.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


def test_reference_backend_matches_reference(problem):
    jat, at, fs = problem
    ref = jcpals.cp_als(jat, RANK, n_iters=ITERS, tol=0.0,
                        factors=[jnp.asarray(f) for f in fs],
                        plan=jplan.make_plan(jat.meta, RANK,
                                             backend="reference"))
    got = tcpals.cp_als(at, RANK, n_iters=ITERS, tol=0.0,
                        factors=interop.factors(fs, device="cpu"))
    assert got.plan.backend == "reference"
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=1e-4)
    coords = at.coords()[:at.nnz]
    np.testing.assert_allclose(
        tcpals.reconstruct_values(coords, got.lam, got.factors).numpy(),
        np.asarray(jcpals.reconstruct_values(
            jnp.asarray(coords.numpy()), ref.lam, ref.factors)),
        rtol=1e-3, atol=1e-3)


def test_quickstart_decomposition_on_cpu():
    x, _ = tsyn.sparse_lowrank((30, 24, 20), rank=4, col_support=0.3,
                               seed=0)
    at = talto.build_device(x, n_partitions=8, device="cpu")
    res = tcpals.cp_als(at, rank=4, n_iters=10, seed=1)
    assert all(np.isfinite(res.fits))
    assert all(b >= a - 1e-3 for a, b in zip(res.fits, res.fits[1:]))
    assert res.fits[-1] > 0.5
    assert [f.shape for f in res.factors] == [(I, 4) for I in x.dims]


def test_init_factors_seeded_and_degenerate_inputs():
    a = tcpals.init_factors((5, 6), 3, seed=4, device="cpu")
    b = tcpals.init_factors((5, 6), 3, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (5, 3) and float(a[1].min()) >= 0.0
    empty = tsyn.uniform_tensor((4, 5, 6), 0, seed=0)
    at = talto.build_device(empty, n_partitions=2, device="cpu")
    res = tcpals.cp_als(at, 3, n_iters=3)
    assert res.fits == [1.0] and res.n_iters == 0
    with pytest.raises(ValueError, match="rank"):
        tcpals.cp_als(at, 3, plan=tplan.make_plan(at.meta, 2))


def _fit_plain(M_last, factors, lam, normX2: float) -> float:
    """The host float64 fit the port used to compute (numpy), as the
    plain version of `cpals._fit`."""
    if normX2 == 0.0:
        return 1.0
    fs = [A.numpy().astype(np.float64) for A in factors]
    lam64 = lam.numpy().astype(np.float64)
    M = M_last.numpy().astype(np.float64)
    inner = float(((fs[-1] * M).sum(axis=0) * lam64).sum())
    V = np.ones((lam64.size, lam64.size))
    for A in fs:
        V *= A.T @ A
    norm_model2 = float((np.outer(lam64, lam64) * V).sum())
    resid2 = max(normX2 + norm_model2 - 2.0 * inner, 0.0)
    return float(1.0 - np.sqrt(resid2) / np.sqrt(normX2))


@pytest.mark.parametrize("seed", range(4))
def test_device_fit_matches_the_host_formula(seed):
    """`cpals._fit` computes the host float64 formula on the factors'
    device: equal within 1e-12 relative, a float copied back, and 1.0 for
    an all-zero tensor."""
    rng = np.random.default_rng(seed)
    dims, R = (40, 30, 20), 6
    fs = [torch.from_numpy(rng.random((I, R)).astype(np.float32))
          for I in dims]
    lam = torch.from_numpy(rng.random(R).astype(np.float32) + 0.5)
    M = torch.from_numpy(rng.standard_normal((dims[-1], R))
                         .astype(np.float32))
    for normX2 in (float(rng.random() * 1e3 + 1.0), 1e-3, 0.0):
        got = tcpals._fit(M, fs, lam, normX2)
        want = _fit_plain(M, fs, lam, normX2)
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)
    assert tcpals._fit(M, fs, lam, 0.0) == 1.0


def test_fit_of_a_run_matches_the_host_formula(problem):
    jat, at, fs = problem
    tp = tplan.make_plan(at.meta, RANK, backend="cuda")
    res = tcpals.cp_als(at, RANK, n_iters=3, tol=0.0, plan=tp,
                        factors=interop.factors(fs, device="cpu"))
    factors, lam, M = tcpals._sweep(tp, at, tplan.build_views(at, tp),
                                    res.factors, res.lam)
    normX2 = float((at.values.double() ** 2).sum())
    got = tcpals._fit(M, factors, lam, normX2)
    assert abs(got - _fit_plain(M, factors, lam, normX2)) <= 1e-12
    assert 0.0 < got < 1.0
