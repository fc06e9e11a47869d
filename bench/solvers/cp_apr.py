"""CP-APR solves back to back: `repro_torch.core.cpapr.cp_apr` with
``tau`` 0, so every mode update takes ``l_max`` inner steps, from factors
uniform in [0.1, 1.1) with columns summing to 1 and λ = Σx / R, drawn per
solve."""
from __future__ import annotations

import torch

from bench import generators, roofline
from bench.reference import compare as cmp
from bench.reference import cpd

METRIC = "apr_outer_ms"
CONTROL = "bfloat16"
SPANS = {"bench.phi": ("repro_torch.core.plan", "execute_phi")}
# The paper's inadmissible-zero shift and least divisor, handed to both
# sides.
PAPER = {"kappa": 1e-2, "kappa_tol": 1e-10, "eps_div": 1e-10}


def _params(traffic: dict) -> dict:
    return {"k_max": int(traffic["k_max"]), "l_max": int(traffic["l_max"]),
            "tau": float(traffic["tau"]), **PAPER}


def initial(coo, rank: int, seed: int, index: int) -> dict:
    dev = coo.values.device
    g = generators.generator(seed, "cp_apr.init", dev, index)
    factors = []
    for I in coo.dims:
        A = torch.rand((int(I), rank), generator=g, device=dev) + 0.1
        factors.append(A / A.sum(dim=0, keepdim=True))
    total = float(coo.values.double().sum())
    lam = torch.full((rank,), total / rank, dtype=torch.float32, device=dev)
    return {"factors": factors, "lam": lam}


def solve(port, traffic: dict, init: dict):
    from repro_torch.core import cpapr
    return cpapr.cp_apr(port.at, port.rank, cpapr.CpaprParams(
        **_params(traffic)), views=port.views, plan=port.plan,
        factors=init["factors"], lam=init["lam"])


def iterations(result) -> int:
    return int(result.n_outer)


def answer(result) -> cpd.AprOut:
    """What the solve answers, in the reference's form."""
    return cpd.AprOut(lam=result.lam, factors=list(result.factors),
                      kkts=list(result.kkt_violations))


def bound_s(dims, nnz, distinct, rank, traffic) -> float:
    return roofline.apr_outer_s(dims, nnz, distinct, rank,
                                int(traffic["l_max"]))


def reference(coo, traffic: dict, init: dict, precision: str):
    return cpd.cp_apr(coo.coords, coo.values, init["lam"], init["factors"],
                      precision=precision, **_params(traffic))


def compare(coo, out, ref) -> dict:
    """The KKT value of every outer iteration, the log-likelihood of the
    final model, every factor and λ."""
    ll_ref = cpd.log_likelihood(coo.coords, coo.values, ref.lam, ref.factors)
    ll_out = cpd.log_likelihood(coo.coords, coo.values, out.lam, out.factors)
    return {"kkt_gap": cmp.series_gap(out.kkts, ref.kkts, scaled=True),
            "ll_gap": cmp.relative(ll_out, ll_ref),
            "factor_gap": cmp.factor_gap(out.factors, ref.factors),
            "lam_gap": cmp.vector_gap(out.lam, ref.lam)}
