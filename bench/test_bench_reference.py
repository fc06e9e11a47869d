"""The plain reference against dense computations at small shapes."""
import math

import pytest
import torch

from bench import generators as G
from bench.reference import compare as cmp
from bench.reference import cpd

DIMS = [(7, 5, 6), (6, 4, 5, 3)]


def _tensor(dims, nnz, seed=3):
    x = G.uniform_tensor(dims, nnz, seed, "cpu")
    dense = torch.zeros(dims, dtype=torch.float64)
    dense[tuple(x.coords.T)] = x.values.double()
    return x, dense


def _factors(dims, rank, seed=4, low=0.0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((d, rank), generator=g, dtype=torch.float64) + low
            for d in dims]


def _dense_mttkrp(dense, factors, mode):
    letters = "abcd"[:dense.ndim]
    ops = [f for m, f in enumerate(factors) if m != mode]
    subs = [letters[m] + "r" for m in range(dense.ndim) if m != mode]
    return torch.einsum(f"{letters},{','.join(subs)}->{letters[mode]}r",
                        dense, *ops)


def _dense_model(lam, factors):
    letters = "abcd"[:len(factors)]
    return torch.einsum(",".join(c + "r" for c in letters) + ",r->" + letters,
                        *factors, lam)


@pytest.mark.parametrize("dims", DIMS)
def test_mttkrp_matches_dense_einsum(dims, monkeypatch):
    monkeypatch.setattr(cpd, "CHUNK", 17)        # several blocks
    x, dense = _tensor(dims, 60)
    fs = _factors(dims, 3)
    for mode in range(len(dims)):
        got = cpd.mttkrp(x.coords, x.values.double(), fs, mode)
        torch.testing.assert_close(got, _dense_mttkrp(dense, fs, mode))


@pytest.mark.parametrize("dims", DIMS)
def test_phi_matches_dense(dims, monkeypatch):
    monkeypatch.setattr(cpd, "CHUNK", 17)
    x, dense = _tensor(dims, 60)
    fs = _factors(dims, 3, low=0.1)
    for mode in range(len(dims)):
        B = _factors(dims, 3, seed=9 + mode, low=0.1)[mode]
        model = _dense_model(torch.ones(3, dtype=torch.float64),
                             [B if m == mode else f
                              for m, f in enumerate(fs)])
        w = torch.where(dense != 0, dense / model.clamp_min(1e-10),
                        torch.zeros_like(dense))
        want = _dense_mttkrp(w, fs, mode)
        got = cpd.phi(x.coords, x.values.double(), B, fs, mode, 1e-10)
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("dims", DIMS)
def test_cp_als_iteration_matches_dense(dims):
    x, dense = _tensor(dims, 70)
    fs = _factors(dims, 3)
    out = cpd.cp_als(x.coords, x.values, fs, n_iters=2)
    A = [f.clone() for f in fs]
    for _ in range(2):
        for n in range(len(dims)):
            V = torch.ones(3, 3, dtype=torch.float64)
            for m in range(len(dims)):
                if m != n:
                    V = V * (A[m].T @ A[m])
            An = _dense_mttkrp(dense, A, n) @ torch.linalg.pinv(V)
            lam = An.norm(dim=0)
            A[n] = An / lam
    for a, b in zip(out.factors, A):
        torch.testing.assert_close(a, b)
    resid = (dense - _dense_model(lam, A)).norm()
    assert out.fits[-1] == pytest.approx(1 - float(resid / dense.norm()),
                                         abs=1e-12)
    assert len(out.fits) == 2


def test_cp_apr_outer_matches_dense():
    dims = (6, 5, 4)
    x, dense = _tensor(dims, 40)
    fs = [f / f.sum(0) for f in _factors(dims, 2, low=0.1)]
    lam0 = torch.full((2,), float(x.values.sum()) / 2, dtype=torch.float64)
    kw = dict(k_max=1, l_max=3, tau=0.0, kappa=1e-2, kappa_tol=1e-10,
              eps_div=1e-10)
    out = cpd.cp_apr(x.coords, x.values, lam0, fs, **kw)
    A, lam, kkt_max = [f.clone() for f in fs], lam0.clone(), 0.0
    for n in range(3):
        B = A[n] * lam
        for step in range(3):
            model = _dense_model(torch.ones(2, dtype=torch.float64),
                                 [B if m == n else f
                                  for m, f in enumerate(A)])
            w = torch.where(dense != 0, dense / model, torch.zeros_like(dense))
            Phi = _dense_mttkrp(w, A, n)
            if step == 0:
                kkt_max = max(kkt_max, float(
                    torch.minimum(B, 1 - Phi).abs().max()))
            B = B * Phi
        lam = B.sum(0)
        A[n] = B / lam
    for a, b in zip(out.factors, A):
        torch.testing.assert_close(a, b)
    torch.testing.assert_close(out.lam, lam)
    assert out.kkts == [pytest.approx(kkt_max, rel=1e-12)]


def test_log_likelihood_matches_dense():
    dims = (5, 4, 6)
    x, dense = _tensor(dims, 30)
    fs = [f / f.sum(0) for f in _factors(dims, 2, low=0.1)]
    lam = torch.tensor([3.0, 5.0], dtype=torch.float64)
    model = _dense_model(lam, fs)
    want = float((dense * torch.log(model)).sum() - lam.sum())
    assert cpd.log_likelihood(x.coords, x.values, lam, fs) == \
        pytest.approx(want, rel=1e-12)


def test_round_tf32():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-12, -1 - 2**-10, 0.1,
                      math.inf, math.nan], dtype=torch.float32)
    r = cpd.round_tf32(x)
    assert r[0] == 1.0                         # a tie goes to even
    assert r[1] == 1 + 2**-10
    assert r[2] == -1 - 2**-10                 # already representable
    assert (r[:4].view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(r[3]) - 0.1) <= 0.1 * 2**-11
    assert math.isinf(r[4]) and math.isnan(r[5])


def test_gaps_read_faults_as_infinite():
    assert cmp.series_gap([1.0], [1.0, 2.0], scaled=False) == cmp.INF
    assert cmp.series_gap([math.nan], [1.0], scaled=True) == cmp.INF
    assert cmp.relative(1.0, 0.0) == cmp.INF
    assert cmp.fit_gap([0.1, 0.5], [0.2, 0.4]) == pytest.approx(0.25)
    assert cmp.fit_gap([0.1, 0.5], [0.2]) == cmp.INF
    a = torch.ones(3, 2)
    assert cmp.vector_gap(a * math.nan, a) == cmp.INF
    assert cmp.factor_gap([a], [a, a]) == cmp.INF
    assert cmp.vector_gap(a * 1.5, a) == pytest.approx(0.5)
    assert cmp.factor_gap([a, a * 1.5], [a, a]) == pytest.approx(0.5)
    b = a.clone()
    b[0, 0] = 3.0                  # ‖(2, 0, ...)‖ / ‖ones(3, 2)‖
    assert cmp.factor_gap([b], [a]) == pytest.approx(2 / 6 ** 0.5)
