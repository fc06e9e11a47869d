"""MTTKRP and the ALTO sparse row reductions, in plain PyTorch (paper
Alg. 3/4) — the plan's ``"reference"`` backend and the tests' oracles.

MTTKRP for CP-ALS is a per-nonzero contribution of R values, reduced by
the target-mode row. The two paper traversals:

  * recursive       — ALTO-ordered chunks per balanced partition, local
                      dense ``Temp`` buffers bounded by the partition's
                      mode interval, then a pull reduction into the output;
  * output-oriented — nonzeros permuted by target row; the update becomes
                      a sorted segment reduction.

`mttkrp_adaptive` picks the traversal per mode from fiber reuse
(`heuristics.choose_traversal`), or follows a plan.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import heuristics
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.encoding import delinearize


def krp_rows(coords: torch.Tensor, factors: Sequence[torch.Tensor],
             mode: int) -> torch.Tensor:
    """Khatri-Rao rows: prod_{m != mode} A^(m)[i_m, :] -> (M, R), the
    factors multiplied in increasing mode order."""
    out = None
    for m, A in enumerate(factors):
        if m == mode:
            continue
        rows = A[coords[..., m].long()]
        out = rows if out is None else out * rows
    return out


def contributions(enc, words: torch.Tensor, values: torch.Tensor,
                  factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
    """values[:, None] * krp: the (M, R) per-nonzero MTTKRP terms."""
    coords = delinearize(enc, words)
    return values[:, None] * krp_rows(coords, factors, mode)


# ---------------------------------------------------------------------------
# Baseline: COO scatter-add (the paper's list-based baseline, §2.3.1)
# ---------------------------------------------------------------------------

def mttkrp_coo(coords: torch.Tensor, values: torch.Tensor,
               factors: Sequence[torch.Tensor], mode: int) -> torch.Tensor:
    """COO MTTKRP: unordered scatter-add."""
    contrib = values[:, None] * krp_rows(coords, factors, mode)
    out = contrib.new_zeros((factors[mode].shape[0], contrib.shape[-1]))
    return out.index_add_(0, coords[:, mode].long(), contrib)


# ---------------------------------------------------------------------------
# Generic ALTO row reductions
# ---------------------------------------------------------------------------

def row_reduce_recursive(at: AltoTensor, mode: int,
                         contrib: torch.Tensor) -> torch.Tensor:
    """Reduce (Mp, R) contributions by target row, recursive traversal.

    Per partition l: Temp_l[i - T_l^s, :] += contrib (Alg. 4 line 6), then
    out[b, :] += Temp_l[b - T_l^s, :] for all overlapping l (lines 14-18).
    """
    meta = at.meta
    L = meta.n_partitions
    chunk = at.words.shape[0] // L
    R = contrib.shape[-1]
    T = meta.temp_rows[mode]
    rows = at.coords()[:, mode].long().reshape(L, chunk)
    local = rows - at.part_start[:, mode].long()[:, None]     # in [0, T)
    part = torch.arange(L, device=rows.device)[:, None]
    temp = contrib.new_zeros((L * T, R)).index_add_(
        0, (part * T + local).reshape(-1), contrib).reshape(L, T, R)
    return pull_rows(temp, at.part_start[:, mode], meta.dims[mode])


def pull_rows(temp: torch.Tensor, part_start_mode: torch.Tensor,
              out_dim: int) -> torch.Tensor:
    """Pull reduction of (L, T, R) Temp buffers into (out_dim, R). Rows
    past a partition's interval hold zeros; their clamped global index
    keeps the scatter in bounds."""
    L, T, R = temp.shape
    rows = (part_start_mode.long()[:, None]
            + torch.arange(T, device=temp.device)[None, :])
    rows = rows.clamp_max(out_dim - 1)
    return temp.new_zeros((out_dim, R)).index_add_(
        0, rows.reshape(-1), temp.reshape(L * T, R))


def row_reduce_oriented(view: OrientedView,
                        contrib: torch.Tensor) -> torch.Tensor:
    """Reduce (Mp, R) contributions (in the view's row-sorted order) by
    target row: a sorted segment sum."""
    I_n = view.meta.dims[view.mode]
    return contrib.new_zeros((I_n, contrib.shape[-1])).index_add_(
        0, view.rows.long(), contrib)


# ---------------------------------------------------------------------------
# MTTKRP variants
# ---------------------------------------------------------------------------

def mttkrp_recursive(at: AltoTensor, factors: Sequence[torch.Tensor],
                     mode: int) -> torch.Tensor:
    contrib = contributions(at.meta.enc, at.words, at.values, factors, mode)
    return row_reduce_recursive(at, mode, contrib)


def mttkrp_oriented(view: OrientedView, factors: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    contrib = contributions(view.meta.enc, view.words, view.values, factors,
                            view.mode)
    return row_reduce_oriented(view, contrib)


def mttkrp_adaptive(at: AltoTensor,
                    views: dict[int, OrientedView] | None,
                    factors: Sequence[torch.Tensor], mode: int,
                    plan=None) -> torch.Tensor:
    """Adaptive conflict resolution (paper §4.2).

    With a ``plan`` (`core.plan.make_plan`) its routing is used, kernels
    included; without one the heuristic picks between the two plain
    traversals above.
    """
    if plan is not None:
        from repro_torch.core import plan as plan_mod
        return plan_mod.execute_mttkrp(plan, at, views, factors, mode)
    choice = heuristics.choose_traversal(at.meta, mode)
    if (choice is heuristics.Traversal.OUTPUT_ORIENTED and views
            and mode in views):
        return mttkrp_oriented(views[mode], factors)
    return mttkrp_recursive(at, factors, mode)


def dense_mttkrp_reference(dense, factors: Sequence[torch.Tensor],
                           mode: int) -> torch.Tensor:
    """Oracle: matricized-dense einsum MTTKRP (tests only)."""
    dense = torch.as_tensor(dense)
    letters = "abcdefghij"[:dense.ndim]
    operands, subs = [], [letters]
    for m in range(dense.ndim):
        if m == mode:
            continue
        operands.append(factors[m])
        subs.append(letters[m] + "r")
    expr = ",".join(subs) + "->" + letters[mode] + "r"
    return torch.einsum(expr, dense, *operands)
