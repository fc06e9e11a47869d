"""The port's spans (`repro_torch.trace`): under a profiler a small CP-ALS
and a small CP-APR solve emit exactly their ``repro.*`` spans, with exact
counts; without one they never reach `record_function`."""
import pytest
import torch

from repro_torch import trace
from repro_torch.core import alto, cpals, cpapr
from repro_torch.sparse import synthetic

RANK = 3
N_ITERS = 4
APR = cpapr.CpaprParams(k_max=3, l_max=4, tau=0.0)


@pytest.fixture(scope="module")
def at():
    x = synthetic.uniform_tensor((12, 7, 9), 150, seed=5, count_data=True)
    return alto.build(x, n_partitions=4, device="cpu")


def _als(at):
    return cpals.cp_als(at, RANK, n_iters=N_ITERS, tol=0.0, seed=1)


def _apr(at):
    return cpapr.cp_apr(at, RANK, APR, seed=1, pi_policy="pre")


def _profiled(solve, at):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        res = solve(at)
    return res, {e.key: e.count for e in prof.key_averages()
                 if e.key.startswith(trace.PREFIX)}


def test_cp_als_spans(at):
    res, spans = _profiled(_als, at)
    N = len(at.dims)
    assert res.n_iters == N_ITERS
    assert spans == {"repro.mttkrp": N * N_ITERS,
                     "repro.read.pinv": N * N_ITERS,
                     "repro.cpals.fit": N_ITERS,
                     "repro.read.fit": N_ITERS,
                     "repro.read.norm": 1}


def test_cp_apr_spans(at):
    res, spans = _profiled(_apr, at)
    N = len(at.dims)
    steps = N * APR.l_max * APR.k_max        # tau 0: no step stops early
    assert res.n_outer == APR.k_max and res.n_inner_total == steps
    assert spans == {"repro.phi": steps,
                     "repro.read.kkt": steps,
                     "repro.cpapr.pi_build": N * APR.k_max,
                     "repro.read.kappa": N * (APR.k_max - 1),
                     "repro.read.total": 1}


def test_no_span_without_a_profiler(at, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _als(at).n_iters == N_ITERS
    assert _apr(at).n_outer == APR.k_max
    assert trace.span("a") is trace.span("read.b")


def test_profiler_check_exists():
    # `span` rests on this private torch function: a torch without it
    # fails here.
    assert torch.autograd._profiler_enabled() is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled() is True
        assert trace.span("x") is not trace.span("x")
