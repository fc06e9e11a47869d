"""MTTKRP and the ALTO sparse row reductions, in plain PyTorch (paper
Alg. 3/4) — the plan's ``"reference"`` backend and the tests' oracles.

MTTKRP for CP-ALS (and Φ for CP-APR, `phi_contributions`) is a
per-nonzero contribution of R values, reduced by the target-mode row.
The two paper traversals:

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
from repro_torch.core.encoding import delinearize, extract_mode


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


def phi_contributions(enc, mode: int, words: torch.Tensor,
                      values: torch.Tensor, rows: torch.Tensor | None,
                      B: torch.Tensor, factors=None, pi=None,
                      eps: float = 1e-10) -> torch.Tensor:
    """The (M, R) per-nonzero CP-APR Φ terms (paper Alg. 5):
    ``(v / max(<B[row, :], krp>, eps)) · krp``.

    ``krp`` is the Khatri-Rao row of the other modes (ALTO-OTF,
    ``factors=``) or the given Π row (ALTO-PRE, ``pi=``): exactly one.
    ``rows`` is the target row of each element, or None to decode it from
    the words. The denominator is summed serially in rank order from 0.0
    and floored with ``fmax`` (NaN-ignoring, as C's ``fmaxf``), the order
    of the Φ kernels (``csrc/phi_scan.cuh``), so every route's plain
    version rounds each term as its kernel does.
    """
    if (pi is None) == (factors is None):
        raise ValueError("pass exactly one of pi= / factors=")
    if pi is None:
        coords = delinearize(enc, words)
        krp = krp_rows(coords, factors, mode)
        if rows is None:
            rows = coords[:, mode]
    else:
        krp = pi
        if rows is None:
            rows = extract_mode(enc, words, mode)
    prod = B[rows.long()] * krp
    dot = prod.new_zeros(prod.shape[0])
    for k in range(prod.shape[1]):
        dot = dot + prod[:, k]
    denom = torch.fmax(dot, dot.new_tensor(eps))
    return (values / denom)[:, None] * krp


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


_PULL_SORTS = [0]


def pull_sorts() -> int:
    """How many times `pull_pieces` or `reach_pieces` has sorted (the pull
    order is cached per tensor and mode by `core.views.get_pull_order`)."""
    return _PULL_SORTS[0]


def reach_pieces(rows: torch.Tensor, part_start_mode: torch.Tensor,
                 T: int):
    """The pull's pieces that the stream reaches: the distinct (row,
    partition) pairs of the ``Mp`` stream's coordinates ``rows`` of the
    mode (padding included), sorted by row and then by partition. Returns
    each piece's global row and its Temp row, ``l·T + row - start[l]``.

    These are `pull_pieces` with the Temp rows no nonzero reaches left out,
    in the same relative order. Those rows hold exact ``+0.0`` (a Temp row
    starts at ``+0.0`` and only adds, so it is never ``-0.0``), so each
    row's pieces sum to the same bits."""
    _PULL_SORTS[0] += 1
    L = part_start_mode.shape[0]
    part = torch.arange(L, device=rows.device)
    keys = torch.unique(rows.long().reshape(L, -1) * L + part[:, None])
    row = torch.div(keys, L, rounding_mode="floor")
    l = keys - row * L
    return row, l * T + row - part_start_mode.long()[l]


def pull_pieces(part_start_mode: torch.Tensor, T: int, out_dim: int):
    """The dense pull's pieces in a fixed order: the global rows of all
    ``L·T`` Temp rows, stably sorted, and the permutation that sorts them.
    Each output row's pieces then come in partition order. Rows past a
    partition's interval hold zeros; their index is clamped into range."""
    _PULL_SORTS[0] += 1
    rows = (part_start_mode.long()[:, None]
            + torch.arange(T, device=part_start_mode.device)[None, :])
    return torch.sort(rows.reshape(-1).clamp_max(out_dim - 1), stable=True)


def pull_rows(temp: torch.Tensor, part_start_mode: torch.Tensor,
              out_dim: int) -> torch.Tensor:
    """Pull reduction of (L, T, R) Temp buffers into (out_dim, R) (Alg. 4
    lines 14-18): every output row adds the partitions covering it in
    partition order, the dense `pull_pieces` summed in sorted order (on the
    CPU ``index_add_`` adds in index order). `kernels.ops.pull_reduction`
    hands the fix-up kernel the same pieces, or only those the stream
    reaches (`reach_pieces`), with the same bits."""
    L, T, R = temp.shape
    rows, order = pull_pieces(part_start_mode, T, out_dim)
    return temp.new_zeros((out_dim, R)).index_add_(
        0, rows, temp.reshape(L * T, R)[order])


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
                    plan=None, group=None) -> torch.Tensor:
    """Adaptive conflict resolution (paper §4.2).

    With a ``plan`` (`core.plan.make_plan`) its routing is used, kernels
    included (a sharded plan's over the ranks of ``group``); without one
    the heuristic picks between the two plain traversals above.
    """
    if plan is not None:
        from repro_torch.core import plan as plan_mod
        return plan_mod.execute_mttkrp(plan, at, views, factors, mode,
                                       group=group)
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
