"""Public MTTKRP, CP-APR Φ and decode entry points over the hand-written
kernels.

Each MTTKRP entry takes the port's `AltoTensor` / `OrientedView` and
factors and returns the ``(I_n, R)`` MTTKRP; each Φ entry takes B and
either the factors (ALTO-OTF) or the stream's Π rows (ALTO-PRE) and
returns the ``(I_n, R)`` Φ. On CUDA tensors the kernels run; on CPU
tensors their plain versions do (the tests' path). Oriented entries
consume the row-sorted stream padded to the block multiple by
`pad_sorted_stream` (the final row and words replicated, values and Π
rows zero).

`timing_stats` is the measurement primitive: CUDA events on the card, the
host clock on the CPU, one bump of `timing_runs` per call.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from repro_torch.core import mttkrp as core_mttkrp
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.encoding import AltoEncoding
from repro_torch.kernels import cpapr_phi as _phi
from repro_torch.kernels import delinearize as _delin
from repro_torch.kernels import mttkrp as _mttkrp
from repro_torch.kernels import mttkrp_oriented as _oriented

_LOCK = threading.Lock()
_TIMING_RUNS = 0


# ---------------------------------------------------------------------------
# Reductions around the kernels (PyTorch)
# ---------------------------------------------------------------------------

def pull_reduction(partials: torch.Tensor, part_start_mode: torch.Tensor,
                   out_dim: int,
                   threads: int = _oriented.DEFAULT_THREADS) -> torch.Tensor:
    """Merge per-partition Temp buffers (Alg. 4 lines 14-18) in a fixed
    order: each output row adds the partitions covering it in partition
    order, so the recursive routes are bit-repeatable on the card.

    The pieces are `core.mttkrp.pull_pieces` (the ``L·T`` Temp rows
    stably sorted by global row), handed to K1's fix-up with one slot per
    piece; it walks each row's pieces in sorted order. No float atomics.
    """
    L, T, R = partials.shape
    rows, order = core_mttkrp.pull_pieces(part_start_mode, T, out_dim)
    return _oriented.carry_fixup(
        rows.to(torch.int32)[:, None],
        partials.reshape(L * T, R)[order][:, None],
        partials.new_zeros((out_dim, R)), threads=threads)


def segment_merge(partials: torch.Tensor, rows: torch.Tensor,
                  out_dim: int, r_block: int | None = None,
                  threads: int = _oriented.DEFAULT_THREADS) -> torch.Tensor:
    """Scatter per-slice run sums to global rows, merging boundary runs.

    Inner runs are stored to their rows (distinct rows, so the store is
    deterministic); each slice's first and last runs go through K1's
    fix-up, which adds a row's pieces in block order. No PyTorch scatter
    guarantees that order on the card, hence the kernel.
    """
    out, carry_row, carry_val = _oriented.split_block_runs(partials, rows,
                                                           out_dim)
    return _oriented.carry_fixup(carry_row, carry_val, out, r_block, threads)


def pad_sorted_stream(rows, words, values, mult: int, pi=None):
    """Pad the sorted stream to a multiple of ``mult`` elements.

    The final row and words are replicated (the stream stays sorted and
    the padding joins the final run) with zero values and zero Π rows, so
    padded elements contribute nothing. An empty stream pads one full
    block of zero rows and words. ``rows``, ``values`` or ``pi`` may be
    None. Returns ``(rows, words, values, pi)``.
    """
    M = words.shape[0]
    pad = mult if M == 0 else (-M) % mult
    if pad == 0:
        return rows, words, values, pi
    if M == 0:
        pad_rows = None if rows is None else rows.new_zeros(pad)
        pad_words = words.new_zeros((pad, words.shape[1]))
    else:
        pad_rows = None if rows is None else rows[-1:].expand(pad)
        pad_words = words[-1:].expand(pad, words.shape[1])
    if rows is not None:
        rows = torch.cat([rows, pad_rows])
    words = torch.cat([words, pad_words])
    if values is not None:
        values = torch.cat([values, values.new_zeros(pad)])
    if pi is not None:
        pi = torch.cat([pi, pi.new_zeros((pad, pi.shape[1]))])
    return rows, words, values, pi


def delinearize(enc: AltoEncoding, words: torch.Tensor,
                block_m: int = _delin.DEFAULT_BLOCK_M) -> torch.Tensor:
    """ALTO index words -> (M, N) int32 coordinates through K4. The words
    are padded to the block multiple by `pad_sorted_stream` and the tail
    is sliced off the coordinates."""
    _, padded, _, _ = pad_sorted_stream(None, words, None, block_m)
    return _delin.delinearize(enc, padded, block_m)[:words.shape[0]]


# ---------------------------------------------------------------------------
# MTTKRP entry points
# ---------------------------------------------------------------------------

def mttkrp(at: AltoTensor, factors, mode: int, r_block: int | None = None,
           threads: int = _mttkrp.DEFAULT_THREADS) -> torch.Tensor:
    """Recursive-traversal MTTKRP: K3 partials + pull reduction."""
    meta = at.meta
    partials = _mttkrp.recursive_partials(
        meta.enc, mode, meta.temp_rows[mode], at.words, at.values,
        at.part_start, factors, r_block=r_block, threads=threads)
    return pull_reduction(partials, at.part_start[:, mode], meta.dims[mode])


def mttkrp_oriented(view: OrientedView, factors,
                    block_m: int = _oriented.DEFAULT_BLOCK_M,
                    r_block: int | None = None,
                    threads: int = _oriented.DEFAULT_THREADS
                    ) -> torch.Tensor:
    """Output-oriented MTTKRP: K2 partials + `segment_merge`."""
    rows, words, values, _ = pad_sorted_stream(view.rows, view.words,
                                               view.values, block_m)
    partials = _oriented.oriented_partials(
        view.meta.enc, view.mode, rows, words, values, factors,
        block_m=block_m, r_block=r_block, threads=threads)
    return segment_merge(partials, rows, view.meta.dims[view.mode],
                         r_block, threads)


def mttkrp_oriented_carry(view: OrientedView, factors,
                          block_m: int = _oriented.DEFAULT_BLOCK_M,
                          r_block: int | None = None,
                          threads: int = _oriented.DEFAULT_THREADS
                          ) -> torch.Tensor:
    """Carry-oriented MTTKRP: K1 (runs + fix-up), no partials buffer.
    Bit-identical to `mttkrp_oriented` at the same ``block_m``."""
    rows, words, values, _ = pad_sorted_stream(view.rows, view.words,
                                               view.values, block_m)
    return _oriented.mttkrp_oriented_carry(
        view.meta.enc, view.mode, rows, words, values, factors,
        block_m=block_m, r_block=r_block, threads=threads)


# ---------------------------------------------------------------------------
# CP-APR Φ entry points (full rank: no r_block)
# ---------------------------------------------------------------------------

def cpapr_phi(at: AltoTensor, B: torch.Tensor, mode: int, factors=None,
              pi: torch.Tensor | None = None, eps: float = 1e-10,
              threads: int = _mttkrp.DEFAULT_THREADS) -> torch.Tensor:
    """Recursive-traversal Φ: K7 partials + pull reduction. ``pi`` holds
    the Π rows of the ALTO-ordered (padded) stream."""
    meta = at.meta
    partials = _phi.phi_partials(
        meta.enc, mode, meta.temp_rows[mode], eps, at.words, at.values,
        at.part_start, B, factors=factors, pi=pi, threads=threads)
    return pull_reduction(partials, at.part_start[:, mode], meta.dims[mode],
                          threads)


def cpapr_phi_oriented(view: OrientedView, B: torch.Tensor, factors=None,
                       pi: torch.Tensor | None = None, eps: float = 1e-10,
                       block_m: int = _oriented.DEFAULT_BLOCK_M,
                       threads: int = _oriented.DEFAULT_THREADS
                       ) -> torch.Tensor:
    """Output-oriented Φ: K6 partials + `segment_merge`. ``pi`` holds the
    Π rows in the view's order."""
    rows, words, values, pi = pad_sorted_stream(view.rows, view.words,
                                                view.values, block_m, pi=pi)
    partials = _oriented.phi_oriented_partials(
        view.meta.enc, view.mode, eps, rows, words, values, B,
        factors=factors, pi=pi, block_m=block_m, threads=threads)
    return segment_merge(partials, rows, view.meta.dims[view.mode],
                         threads=threads)


def cpapr_phi_oriented_carry(view: OrientedView, B: torch.Tensor,
                             factors=None, pi: torch.Tensor | None = None,
                             eps: float = 1e-10,
                             block_m: int = _oriented.DEFAULT_BLOCK_M,
                             threads: int = _oriented.DEFAULT_THREADS
                             ) -> torch.Tensor:
    """Carry-oriented Φ: K5 (runs + fix-up), no partials buffer.
    Bit-identical to `cpapr_phi_oriented` at the same ``block_m``."""
    rows, words, values, pi = pad_sorted_stream(view.rows, view.words,
                                                view.values, block_m, pi=pi)
    return _oriented.phi_oriented_carry(
        view.meta.enc, view.mode, eps, rows, words, values, B,
        factors=factors, pi=pi, block_m=block_m, threads=threads)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def timing_runs() -> int:
    """Number of `timing_stats` measurements taken in this process."""
    with _LOCK:
        return _TIMING_RUNS


def timing_stats(fn: Callable, *args, warmup: int = 1, iters: int = 3,
                 device="cuda") -> tuple[float, float]:
    """(median, IQR) seconds of ``fn(*args)`` after ``warmup`` untimed
    calls. On a CUDA ``device`` each call is timed by CUDA events around
    it, after a synchronize; on the CPU by the host clock. One call of
    this function is one measurement for `timing_runs`, whatever
    ``warmup`` and ``iters``."""
    global _TIMING_RUNS
    with _LOCK:
        _TIMING_RUNS += 1
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(0, warmup)):
        fn(*args)
    times = []
    for _ in range(max(1, iters)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    median = (times[n // 2] if n % 2
              else 0.5 * (times[n // 2 - 1] + times[n // 2]))
    q1, q3 = times[n // 4], times[min(n - 1, (3 * n) // 4)]
    return median, max(0.0, q3 - q1)
