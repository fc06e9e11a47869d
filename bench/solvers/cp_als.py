"""CP-ALS solves back to back: `repro_torch.core.cpals.cp_als` with no
early stop, from uniform [0, 1) factors drawn per solve."""
from __future__ import annotations

import torch

from bench import generators, roofline
from bench.reference import compare as cmp
from bench.reference import cpd

METRIC = "als_iter_ms"
CONTROL = "tf32"
SPANS = {"bench.mttkrp": ("repro_torch.core.cpals", "mttkrp_adaptive")}


def initial(coo, rank: int, seed: int, index: int) -> dict:
    dev = coo.values.device
    g = generators.generator(seed, "cp_als.init", dev, index)
    return {"factors": [torch.rand((int(I), rank), generator=g, device=dev)
                        for I in coo.dims]}


def solve(port, traffic: dict, init: dict):
    from repro_torch.core import cpals
    return cpals.cp_als(port.at, port.rank, n_iters=int(traffic["n_iters"]),
                        tol=float(traffic["tol"]), views=port.views,
                        factors=init["factors"], plan=port.plan)


def iterations(result) -> int:
    return int(result.n_iters)


def answer(result) -> cpd.AlsOut:
    """What the solve answers, in the reference's form."""
    return cpd.AlsOut(lam=result.lam, factors=list(result.factors),
                      fits=list(result.fits))


def bound_s(dims, nnz, distinct, rank, traffic) -> float:
    return roofline.als_iteration_s(dims, nnz, distinct, rank)


def reference(coo, traffic: dict, init: dict, precision: str):
    return cpd.cp_als(coo.coords, coo.values, init["factors"],
                      int(traffic["n_iters"]), precision=precision)


def compare(coo, out, ref) -> dict:
    """The fit of every iteration (relative to the reference's last fit),
    every factor and λ."""
    return {"fit_gap": cmp.fit_gap(out.fits, ref.fits),
            "factor_gap": cmp.factor_gap(out.factors, ref.factors),
            "lam_gap": cmp.vector_gap(out.lam, ref.lam)}
