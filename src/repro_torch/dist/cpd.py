"""Distributed CP-ALS / CP-APR over row-range shards (paper §4.1/§4.2).

ALTO's linearized nonzero stream is "streamed from memory and amenable to
parallel execution"; this module cuts it across the ranks of a
`torch.distributed` process group. The oriented view of a mode sorts the
nonzeros by target row; the sharding is the simplest one that keeps every
single-device invariant: the sorted stream is cut into **contiguous,
equal-size slices**, one a rank. Every rank holds the same `AltoTensor`
(built from the same COO) and the whole views, and computes on its own
slice. Each rank runs the single-device oriented reduction on its slice —
the hand-written kernels the plan picks (K1 carry, or K2 + the split +
the fix-up; K5 or K6 for Φ), or the reference segment sum — into a
full-width ``(I_n, R)`` output, zeros outside its rows, and the outputs
are summed with ``all_reduce``.

Invariants (the carry-merge correctness condition):

* the stream stays **row-sorted**; a slice is contiguous, so each rank's
  rows are a sorted run and the kernels' run scan stays valid;
* row ids are **global**, so a row whose run spans a slice boundary
  yields one partial sum on each side and the ``all_reduce`` adds them,
  as the fix-up adds the pieces of a row across blocks;
* the padding (`kernels.ops.pad_sorted_stream`) replicates the last
  element with zero values and zero Π rows, so it contributes nothing and
  every slice holds the same whole number of ``block_m`` blocks.

On the card a slice's kernels write its row window only, the rows from
its first to its last, given relative to the first (`kernels.
mttkrp_oriented`'s ``n_rows``); the rows outside are zeroed at once. The
runs passes and the split store the zeros of the rows a stream skips one
sub-warp per gap, so handed the mode's full extent the gaps below and
above a slice (half the mode on each of two ranks) went to one sub-warp
each. A view's windows are read back once and kept.

A plan names its shard count (`core.plan.ExecutionPlan.shards`); the
group is passed at call time (``group=``, default the world group), and
each collective checks that the group has that many ranks.

`distributed_cp_als` is `core.cpals.cp_als` under a sharded plan, with
`sharded_gram` as its Gram hook; CP-APR is `core.cpapr.cp_apr` under a
sharded plan (no driver of its own). At one rank the sharded run is the
single-device run bit for bit: the padding is to ``block_m`` alone, the
kernels are the same, and the sum of one rank changes nothing. At two
ranks each output element is ``s0 + s1``, which does not depend on the
order of the sum, so it equals the in-process sum of the two slices bit
for bit; at more ranks the collective's order is its own.

The shard-local functions are pure functions of their slice, so the
tests run them slice by slice in one process and sum there.
"""
from __future__ import annotations

import functools
import threading
import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import alto, cpals, faults, heuristics
from repro_torch.core import encoding as enc_mod
from repro_torch.core import ingest as ingest_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.mttkrp import contributions, phi_contributions
from repro_torch.kernels import mttkrp_oriented as _oriented
from repro_torch.kernels import ops
from repro_torch.sparse.tensor import SparseTensor


def _shard_mult(plan: plan_mod.ExecutionPlan, mode: int) -> int:
    """The padding multiple of the whole stream: every slice a whole
    number of the mode's ``block_m`` blocks on the kernel backend (the
    kernels take whole blocks), of elements on the reference one."""
    bm = plan.modes[mode].block_m if plan.backend == "cuda" else 1
    return plan.shards * bm


def _group_size(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size(group)


def _rank(plan: plan_mod.ExecutionPlan, group) -> int:
    """This rank's index in ``group``, which must have the plan's shard
    count of ranks."""
    if plan.shards is None:
        raise ValueError("a sharded route needs a sharded plan "
                         "(plan.make_plan(..., shards=N))")
    size = _group_size(group)
    if size != plan.shards:
        raise ValueError(f"the plan was made for {plan.shards} shards; the "
                         f"process group has {size} ranks")
    return dist.get_rank(group)


def _slice(n: int, shards: int, rank: int) -> slice:
    per = n // shards
    return slice(rank * per, (rank + 1) * per)


def _row_window(rows: torch.Tensor) -> tuple[int, int]:
    """A sorted slice's first row and its number of rows up to its last
    (one read back to the host)."""
    lo, hi = torch.stack([rows[0], rows[-1]]).tolist()
    return int(lo), int(hi) - int(lo) + 1


# id(view rows) -> (weak reference to them, {(padded length, shards): the
# ranks' row windows}): a view's windows are read back once, not on every
# call, where the read would stall the host behind the card.
_WINDOWS: dict = {}
_WINDOWS_LOCK = threading.Lock()


def _slice_windows(rows: torch.Tensor, n: int,
                   shards: int) -> list[tuple[int, int]]:
    """Every rank's `_row_window` of the view's sorted ``rows`` padded to
    ``n`` elements (`ops.pad_sorted_stream` repeats the last row), in one
    read back, memoized per view."""
    key = (n, shards)
    with _WINDOWS_LOCK:
        entry = _WINDOWS.get(id(rows))
        if entry is not None and entry[0]() is rows and key in entry[1]:
            return entry[1][key]
    M, per = rows.shape[0], n // shards
    if M == 0:
        wins = [(0, 1)] * shards
    else:
        pos = [min(p, M - 1) for r in range(shards)
               for p in (r * per, (r + 1) * per - 1)]
        ends = rows[torch.tensor(pos, device=rows.device)].tolist()
        wins = [(lo, hi - lo + 1) for lo, hi in zip(ends[::2], ends[1::2])]
    with _WINDOWS_LOCK:
        for k in [k for k, (ref, _) in _WINDOWS.items() if ref() is None]:
            del _WINDOWS[k]
        entry = _WINDOWS.get(id(rows))
        if entry is None or entry[0]() is not rows:
            entry = _WINDOWS[id(rows)] = (weakref.ref(rows), {})
        entry[1][key] = wins
    return wins


def _full_width(I_n: int, R: int, lo: int, w: int, like: torch.Tensor):
    """``(out, window)``: an ``(I_n, R)`` output whose rows outside
    ``[lo, lo + w)`` are zeros, and its window, left for the kernels."""
    out = like.new_empty((I_n, R))
    out[:lo].zero_()
    out[lo + w:].zero_()
    return out, out[lo:lo + w]


# ---------------------------------------------------------------------------
# Shard-local reductions (pure: testable without a process group)
# ---------------------------------------------------------------------------

def local_mttkrp(plan: plan_mod.ExecutionPlan, mode: int, rows, words,
                 values, factors, window=None) -> torch.Tensor:
    """One rank's oriented MTTKRP over its slice: full-width ``(I_n, R)``,
    zeros off the slice's rows.

    The single-device oriented reduction the plan picks: K1 (carry) or K2
    + the split + the fix-up (`ops.segment_merge`) on the kernel backend,
    or the sorted segment sum on the reference backend. The slice holds
    whole ``block_m`` blocks on the kernel backend, whose kernels run on
    the slice's row window (rows relative to its first row; `kernels.
    mttkrp_oriented`'s ``n_rows``): the rows below and above it are zeroed
    here at once, not one row at a time by the sub-warp that meets the
    gap. ``window`` is the slice's `_row_window` when the caller has it."""
    enc = plan.meta.enc
    I_n = plan.meta.dims[mode]
    if plan.backend == "cuda":
        mp = plan.modes[mode]
        kw = dict(block_m=mp.block_m, r_block=mp.r_block, threads=mp.threads)
        lo, w = window or _row_window(rows)
        if lo:
            rows = rows - lo
        out, win = _full_width(I_n, factors[0].shape[-1], lo, w, values)
        if mp.traversal is heuristics.Traversal.ORIENTED_CARRY:
            _oriented.mttkrp_oriented_carry(enc, mode, rows, words, values,
                                            factors, **kw, out=win, n_rows=w)
            return out
        partials = _oriented.oriented_partials(enc, mode, rows, words,
                                               values, factors, **kw)
        ops.segment_merge(partials, rows, w, mp.threads, out=win)
        return out
    contrib = contributions(enc, words, values, factors, mode)
    return contrib.new_zeros((I_n, contrib.shape[-1])).index_add_(
        0, rows.long(), contrib)


def local_phi(plan: plan_mod.ExecutionPlan, mode: int, eps: float, rows,
              words, values, B, factors=None, pi=None,
              window=None) -> torch.Tensor:
    """One rank's CP-APR Φ over its slice: full-width ``(I_n, R)``.

    ``B`` is whole on every rank (the Φ denominator reads ``B[i_n, :]`` at
    global rows); ``pi`` (ALTO-PRE) is the slice's Π rows, ``factors``
    (ALTO-OTF) the whole factors. K5 (carry) or K6 + the split + the
    fix-up on the kernel backend, on the slice's row window of the output
    and of B as in `local_mttkrp`; the sorted segment sum on the
    reference one."""
    enc = plan.meta.enc
    I_n = plan.meta.dims[mode]
    if plan.backend == "cuda":
        mp = plan.modes[mode]
        lo, w = window or _row_window(rows)
        if lo:
            rows = rows - lo
        out, win = _full_width(I_n, B.shape[-1], lo, w, B)
        kw = dict(factors=factors, pi=pi, block_m=mp.block_m,
                  threads=mp.threads, n_rows=w)
        Bw = B[lo:lo + w]
        if mp.traversal is heuristics.Traversal.ORIENTED_CARRY:
            _oriented.phi_oriented_carry(enc, mode, eps, rows, words, values,
                                         Bw, **kw, out=win)
            return out
        partials = _oriented.phi_oriented_partials(enc, mode, eps, rows,
                                                   words, values, Bw, **kw)
        ops.segment_merge(partials, rows, w, mp.threads, out=win)
        return out
    contrib = phi_contributions(enc, mode, words, values, rows, B,
                                factors=factors, pi=pi, eps=eps)
    return contrib.new_zeros((I_n, contrib.shape[-1])).index_add_(
        0, rows.long(), contrib)


def local_gram(A_shard: torch.Tensor) -> torch.Tensor:
    """One rank's Gram over its row slice: AᵀA is a sum of rank-one outer
    products, so the slices combine by addition."""
    return A_shard.T @ A_shard


# ---------------------------------------------------------------------------
# Collective wrappers (what the plan routes a sharded plan to)
# ---------------------------------------------------------------------------

def sharded_mttkrp(plan: plan_mod.ExecutionPlan, at: AltoTensor,
                   views: dict[int, OrientedView] | None, factors,
                   mode: int, group=None) -> torch.Tensor:
    """MTTKRP of one mode with the row-sorted stream cut across the ranks
    of ``group`` (default the world group), which must have
    ``plan.shards`` ranks: this rank's slice through `local_mttkrp`, the
    ranks' outputs summed by ``all_reduce``. `plan.execute_mttkrp` routes
    a sharded plan here."""
    r = _rank(plan, group)
    if not views or mode not in views:
        raise ValueError("a sharded plan orients every mode: build its views "
                         "with repro_torch.core.plan.build_views(at, plan)")
    faults.inject("ops.exec")
    view = views[mode]
    rows, words, values, _ = ops.pad_sorted_stream(
        view.rows, view.words, view.values, _shard_mult(plan, mode))
    sl = _slice(rows.shape[0], plan.shards, r)
    out = local_mttkrp(plan, mode, rows[sl], words[sl], values[sl],
                       list(factors), _window_of(plan, view, rows, r))
    dist.all_reduce(out, group=group)
    return out


def sharded_phi(plan: plan_mod.ExecutionPlan, at: AltoTensor,
                view: OrientedView | None, B: torch.Tensor, mode: int,
                factors=None, pi: torch.Tensor | None = None,
                eps: float = 1e-10, group=None) -> torch.Tensor:
    """CP-APR Φ of one mode, row-range sharded as `sharded_mttkrp`. Under
    ALTO-PRE ``pi`` holds the Π rows of the whole view, in its order: they
    are padded with zero rows and cut with the stream. `plan.execute_phi`
    routes a sharded plan here."""
    r = _rank(plan, group)
    if view is None:
        raise ValueError("a sharded plan orients every mode: pass the mode's "
                         "oriented view")
    if (pi is None) == (factors is None):
        raise ValueError("pass exactly one of pi= / factors=")
    faults.inject("ops.exec")
    rows, words, values, pi = ops.pad_sorted_stream(
        view.rows, view.words, view.values, _shard_mult(plan, mode), pi=pi)
    sl = _slice(rows.shape[0], plan.shards, r)
    out = local_phi(plan, mode, eps, rows[sl], words[sl], values[sl], B,
                    factors=None if factors is None else list(factors),
                    pi=None if pi is None else pi[sl],
                    window=_window_of(plan, view, rows, r))
    dist.all_reduce(out, group=group)
    return out


def _window_of(plan, view, padded_rows, rank):
    """This rank's row window (kernel backend only), memoized per view."""
    if plan.backend != "cuda":
        return None
    return _slice_windows(view.rows, padded_rows.shape[0],
                          plan.shards)[rank]


def sharded_gram(A: torch.Tensor, group=None) -> torch.Tensor:
    """AᵀA with the rows of ``A`` cut across the ranks of ``group``
    (zero rows pad them to a multiple of its size), the ranks' Grams
    summed by ``all_reduce``. At one rank it is ``A.T @ A``."""
    D = _group_size(group)
    pad = (-A.shape[0]) % D
    if pad:
        A = torch.cat([A, A.new_zeros((pad, A.shape[1]))])
    G = local_gram(A[_slice(A.shape[0], D, dist.get_rank(group))])
    dist.all_reduce(G, group=group)
    return G


# ---------------------------------------------------------------------------
# Distributed incremental ingest
# ---------------------------------------------------------------------------

def sharded_append_delta(at: AltoTensor, coords, values, *, group=None,
                         policy: str = "sum", dims=None,
                         n_partitions: int | None = None,
                         compute_reuse: bool | None = None,
                         invalidate_stale: bool = True) -> AltoTensor:
    """`ingest.append_delta` with the delta's linearization cut across the
    ranks of ``group``. Every rank passes the same delta and gets the same
    tensor back.

    The delta is zero-padded to a multiple of the group's size; each rank
    linearizes its slice (`encoding.linearize`, an elementwise bit
    gather), the words are gathered in rank order and cut back to the
    delta's length, and `ingest.append_linearized` runs the merge. Bit
    for bit `append_delta`: the padding never reaches the merge."""
    coords = np.asarray(coords, dtype=np.int32).reshape(-1, len(at.dims))
    new_dims = alto.grown_dims(at.dims, coords, dims)
    n = coords.shape[0]
    kw = dict(policy=policy, n_partitions=n_partitions,
              compute_reuse=compute_reuse, invalidate_stale=invalidate_stale)
    if n == 0:
        return ingest_mod.append_delta(at, coords, values, dims=new_dims,
                                       **kw)
    D = _group_size(group)
    pad = (-n) % D
    if pad:
        coords = np.concatenate([coords,
                                 np.zeros((pad, coords.shape[1]), np.int32)])
    mine = coords[_slice(coords.shape[0], D, dist.get_rank(group))]
    words = enc_mod.linearize(enc_mod.make_encoding(new_dims),
                              torch.from_numpy(mine).to(at.device))
    parts = [torch.empty_like(words) for _ in range(D)]
    dist.all_gather(parts, words, group=group)
    return ingest_mod.append_linearized(at, torch.cat(parts)[:n], values,
                                        new_dims, **kw)


# ---------------------------------------------------------------------------
# Distributed CP-ALS driver
# ---------------------------------------------------------------------------

def distributed_cp_als(x: SparseTensor | AltoTensor, rank: int, *,
                       group=None, n_iters: int = 50, tol: float = 1e-5,
                       seed: int = 0, n_partitions: int | None = None,
                       backend: str | None = None, device=None,
                       tune: str = "off", warm_start=None, factors=None):
    """CP-ALS with the MTTKRPs and Grams cut across the ranks of
    ``group`` (default the world group): data-parallel over the nonzero
    stream, factors replicated. Every rank calls it with the same tensor
    and start. Returns ``(lam, factors, fits)``.

    This is `core.cpals.cp_als` under a plan of ``shards`` = the group's
    size (`plan.make_plan(shards=)`, MTTKRP routed to `sharded_mttkrp`)
    with `sharded_gram` as the sweep's Gram hook: the same sweep and the
    same float64 fit, so the fits differ from one device's only by the
    order of the ranks' sums. A `SparseTensor` is built on ``device``
    (default ``cuda``: the current device) with ``n_partitions``
    (default the group's size). ``tune`` measures the sharded plan
    (`core.autotune`: every rank times the same candidates, rank 0's
    winner holds); ``factors`` or ``warm_start`` give the start as in
    `cp_als`."""
    D = _group_size(group)
    if isinstance(x, AltoTensor):
        at = x
    else:
        at = alto.build_device(x, n_partitions=n_partitions or D,
                               device=device)
    plan = plan_mod.make_plan(at.meta, rank, backend=backend,
                              device=at.device, tune=tune, at=at, shards=D,
                              group=group)
    res = cpals.cp_als(at, rank, n_iters=n_iters, tol=tol, seed=seed,
                       plan=plan, factors=factors, warm_start=warm_start,
                       gram_fn=functools.partial(sharded_gram, group=group),
                       group=group)
    return res.lam, res.factors, res.fits
