"""A run with the timed path broken underneath comes out not correct.

Each cell's run is driven on the CPU at a small stand-in of its
configuration, with its own traffic and limits, once sound and once for
each fault the cell can have: a step that returns its state unchanged,
half of the nonzeros left out and the rest counted twice (the mean over
what is left), and an answer altered where it is produced. The cells run
on one device, so there is no exchange between devices to leave out.
"""
import dataclasses
import time

import pytest
import torch

from bench import harness

CELLS = ["darpa1998.cp_als", "chicago-crime-comm.cp_apr",
         "darpa1998.cp_apr", "chicago-crime-comm.cp_als"]


def _halved(at, views):
    """The tensor and views with the second half of the nonzeros left out
    and the first half counted twice."""
    keep = torch.arange(at.values.shape[0]) < at.nnz // 2
    values = torch.where(keep, 2 * at.values, torch.zeros_like(at.values))
    half = dataclasses.replace(at, values=values)
    if views is None:
        return half, None
    return half, {m: dataclasses.replace(v, values=values[v.perm.long()])
                  for m, v in views.items()}


def _unchanged_state(monkeypatch):
    from repro_torch.core import cpals, cpapr
    sweep, update = cpals._sweep, cpapr._mode_update

    def frozen_sweep(plan, at, views, factors, lam, *args):
        _, _, M = sweep(plan, at, views, factors, lam, *args)
        return list(factors), lam, M

    def frozen_update(plan, at, view, mode, lam, factors, *args, **kw):
        _, _, *rest = update(plan, at, view, mode, lam, factors, *args, **kw)
        return (factors[mode], lam, *rest)
    monkeypatch.setattr(cpals, "_sweep", frozen_sweep)
    monkeypatch.setattr(cpapr, "_mode_update", frozen_update)


def _half_the_nonzeros(monkeypatch):
    from repro_torch.core import cpals
    from repro_torch.core import plan as plan_mod
    mttkrp, phi = cpals.mttkrp_adaptive, plan_mod.execute_phi

    def half_mttkrp(at, views, *args, **kw):
        return mttkrp(*_halved(at, views), *args, **kw)

    def half_phi(plan, at, view, *args, **kw):
        at2, views2 = _halved(at, None if view is None else {0: view})
        return phi(plan, at2, None if view is None else views2[0], *args,
                   **kw)
    monkeypatch.setattr(cpals, "mttkrp_adaptive", half_mttkrp)
    monkeypatch.setattr(plan_mod, "execute_phi", half_phi)


def _altered_answer(monkeypatch):
    from repro_torch.core import cpals, cpapr
    als, apr = cpals.cp_als, cpapr.cp_apr

    def alter(res):
        A = res.factors[0].clone()
        A[0, 0] += A.abs().max()
        res.factors[0] = A
        return res
    monkeypatch.setattr(cpals, "cp_als", lambda *a, **k: alter(als(*a, **k)))
    monkeypatch.setattr(cpapr, "cp_apr", lambda *a, **k: alter(apr(*a, **k)))


FAULTS = {"unchanged_state": _unchanged_state,
          "half_the_nonzeros": _half_the_nonzeros,
          "altered_answer": _altered_answer}


def _run(cell):
    return harness.run_cell(cell, 2**31 + 41, 0.1, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(small_cell, monkeypatch, name, fault):
    cell = small_cell(name)
    FAULTS[fault](monkeypatch)
    out = _run(cell)
    assert out["correct"] is False, out["checks"]
    assert out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
