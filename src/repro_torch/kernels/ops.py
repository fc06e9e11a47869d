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

The chunked entries (`mttkrp_oriented_chunked`,
`cpapr_phi_oriented_chunked`) run the out-of-core tier: a host-resident
stream (`core.stream.HostStream`) flows through the card in chunks, K8 /
K9 carrying the open run from one chunk to the next.

The in-core entries (`mttkrp`, `mttkrp_oriented`, `mttkrp_oriented_carry`,
`cpapr_phi`, `cpapr_phi_oriented`, `cpapr_phi_oriented_carry`,
`segment_merge`, `pull_reduction`, `pi_rows`) also take a bucket of
same-class tenants (`core.batched.stack_tenants`): a stacked view (rows
``(T, M)``, words ``(T, M, W)``, values ``(T, M)``) or a stacked
`AltoTensor` (words ``(T, Mp, W)``, values ``(T, Mp)``, part_start ``(T,
L, N)``), stacked factors ``(T, I_m, R)``, B and Π, and for `mttkrp` and
`cpapr_phi` the members' pull orders stacked (``order=``,
`core.views.stack_pull_orders`); each kernel then launches once for the
whole bucket along its tenant axis (`kernels.mttkrp_oriented`,
`kernels.mttkrp`, `kernels.cpapr_phi`, `kernels.delinearize`) and
returns ``(T, I_n, R)`` (`pi_rows`: Π's ``(T, M, R)``).

`timing_stats` is the measurement primitive: CUDA events on the card, the
host clock on the CPU, one bump of `timing_runs` per call.

Fault sites (`core.faults`): ``ops.exec`` at the top of each in-core
MTTKRP and Φ entry, on every call; ``ops.chunk_oom`` before each chunk's
kernel in the chunked executors; ``stream.chunk_io`` where `_chunks`
starts a chunk's copy.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from repro_torch import trace
from repro_torch.core import faults
from repro_torch.core import mttkrp as core_mttkrp
from repro_torch.core import stream as _stream
from repro_torch.core import views as _views
from repro_torch.core.alto import AltoTensor, OrientedView
from repro_torch.core.encoding import AltoEncoding
from repro_torch.kernels import _build, common
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
                   threads: int = _oriented.DEFAULT_THREADS,
                   order: "_views.PullOrder | None" = None) -> torch.Tensor:
    """Merge per-partition Temp buffers (Alg. 4 lines 14-18) in a fixed
    order: each output row adds the partitions covering it in partition
    order, so the recursive routes are bit-repeatable on the card.

    ``order`` gives the pieces, each a Temp row and its global row, sorted
    by row and then by partition; they go to K1's fix-up with one slot
    per piece, which walks each row's pieces in that order. No float
    atomics. The callers pass the reach order (`core.views.
    get_pull_order`, cached per tensor and mode): only the Temp rows that
    the partition's own nonzeros reach. Without ``order`` it is the dense
    order of all ``L·T`` Temp rows (`core.views.pull_order`), sorted here.
    The rows the reach order leaves out hold exact zeros, so both give
    the same bits; rows no piece reaches keep the zeros of the output.
    On the card a pull through the caller's order adds one launch to the
    counter ``pull_pieces_skipped`` and the Temp rows it left out to its
    elements (`_build.COUNTERS`); a bucket's padding pieces count as
    pulled.

    A bucket's ``(T, L, T_rows, R)`` partials with ``(T, L)`` starts pull
    each tenant in its own order (stacked by `core.views.
    stack_pull_orders`: rows ``(T, P, 1)``, order ``(T, P)``) through the
    fix-up's tenant axis, each with the bits of its solo pull, into ``(T,
    out_dim, R)``.
    """
    lead = tuple(partials.shape[:-3])
    L, T, R = partials.shape[-3:]
    if order is None:
        order = _views.pull_order(part_start_mode, T, out_dim)
    elif common.on_cuda(partials):
        _build.count_launch("pull_pieces_skipped",
                            partials[..., 0].numel() - order.order.numel())
    pieces = torch.take_along_dim(partials.reshape(lead + (L * T, R)),
                                  order.order[..., None], dim=-2)
    return _oriented.carry_fixup(
        order.rows, pieces[..., None, :],
        partials.new_zeros(lead + (out_dim, R)), threads=threads)


def segment_merge(partials: torch.Tensor, rows: torch.Tensor,
                  out_dim: int, threads: int = _oriented.DEFAULT_THREADS,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter per-slice run sums to global rows, merging boundary runs.

    `mttkrp_oriented.segment_split` stores the inner runs to their rows
    (distinct rows, so the store is deterministic) and the zeros of the
    rows the stream skips; each slice's first and last runs go through
    K1's fix-up, which adds a row's pieces in block order and stores the
    row. No PyTorch scatter guarantees that order on the card, hence the
    kernels; between them they write every row of the output once:
    ``out`` (``(out_dim, R)``, new unless given) is the result.
    """
    out, carry_row, carry_val = _oriented.segment_split(
        partials, rows, out_dim, threads, out=out)
    return _oriented.carry_fixup(carry_row, carry_val, out, threads=threads)


def pad_sorted_stream(rows, words, values, mult: int, pi=None):
    """Pad the sorted stream to a multiple of ``mult`` elements.

    The final row and words are replicated (the stream stays sorted and
    the padding joins the final run) with zero values and zero Π rows, so
    padded elements contribute nothing. An empty stream pads one full
    block of zero rows and words. ``rows``, ``values`` or ``pi`` may be
    None. A bucket's stacked streams (words ``(T, M, W)``) pad tenant by
    tenant along their element axis. Returns ``(rows, words, values,
    pi)``.
    """
    lead = tuple(words.shape[:-2])
    M, W = words.shape[-2:]
    pad = mult if M == 0 else (-M) % mult
    if pad == 0:
        return rows, words, values, pi
    if M == 0:
        pad_rows = None if rows is None else rows.new_zeros(lead + (pad,))
        pad_words = words.new_zeros(lead + (pad, W))
    else:
        pad_rows = (None if rows is None
                    else rows[..., -1:].expand(lead + (pad,)))
        pad_words = words[..., -1:, :].expand(lead + (pad, W))
    if rows is not None:
        rows = torch.cat([rows, pad_rows], dim=-1)
    words = torch.cat([words, pad_words], dim=-2)
    if values is not None:
        values = torch.cat([values, values.new_zeros(lead + (pad,))], dim=-1)
    if pi is not None:
        pi = torch.cat([pi, pi.new_zeros(lead + (pad, pi.shape[-1]))],
                       dim=-2)
    return rows, words, values, pi


def delinearize(enc: AltoEncoding, words: torch.Tensor) -> torch.Tensor:
    """ALTO index words -> (M, N) int32 coordinates through K4, at any
    length: the kernel bounds-checks its last tile, so the words are
    neither padded nor copied."""
    return _delin.delinearize(enc, words)


def pi_rows(enc: AltoEncoding, words: torch.Tensor, factors,
            mode: int) -> torch.Tensor:
    """ALTO-PRE Π rows of a word stream, in its order: ``(M, R)``, the
    Khatri-Rao rows of every factor but ``mode``'s, decoded, gathered and
    multiplied by one kernel (`kernels.delinearize.pi_rows`), bit for bit
    `core.mttkrp.krp_rows` on the decoded coordinates; ``(T, M, R)`` for a
    bucket's stacked words and factors, in one launch."""
    return _delin.pi_rows(enc, words, factors, mode)


# ---------------------------------------------------------------------------
# MTTKRP entry points
# ---------------------------------------------------------------------------

def mttkrp(at: AltoTensor, factors, mode: int, r_block: int | None = None,
           threads: int = _mttkrp.DEFAULT_THREADS,
           order: _views.PullOrder | None = None) -> torch.Tensor:
    """Recursive-traversal MTTKRP: K3 partials + pull reduction.
    ``order``: the pull order (`core.views.get_pull_order` of ``at`` by
    default; a bucket's stacked tensor passes its members' orders,
    `core.views.stack_pull_orders`)."""
    faults.inject("ops.exec")
    meta = at.meta
    partials = _mttkrp.recursive_partials(
        meta.enc, mode, meta.temp_rows[mode], at.words, at.values,
        at.part_start, factors, r_block=r_block, threads=threads)
    if order is None:
        order = _views.get_pull_order(at, mode)
    return pull_reduction(partials, at.part_start[..., mode],
                          meta.dims[mode], order=order)


def mttkrp_oriented(view: OrientedView, factors,
                    block_m: int = _oriented.DEFAULT_BLOCK_M,
                    r_block: int | None = None,
                    threads: int = _oriented.DEFAULT_THREADS
                    ) -> torch.Tensor:
    """Output-oriented MTTKRP: K2 partials + `segment_merge`."""
    faults.inject("ops.exec")
    rows, words, values, _ = pad_sorted_stream(view.rows, view.words,
                                               view.values, block_m)
    partials = _oriented.oriented_partials(
        view.meta.enc, view.mode, rows, words, values, factors,
        block_m=block_m, r_block=r_block, threads=threads)
    return segment_merge(partials, rows, view.meta.dims[view.mode],
                         threads)


def mttkrp_oriented_carry(view: OrientedView, factors,
                          block_m: int = _oriented.DEFAULT_BLOCK_M,
                          r_block: int | None = None,
                          threads: int = _oriented.DEFAULT_THREADS
                          ) -> torch.Tensor:
    """Carry-oriented MTTKRP: K1 (runs + fix-up), no partials buffer.
    Bit-identical to `mttkrp_oriented` at the same ``block_m``."""
    faults.inject("ops.exec")
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
              threads: int = _mttkrp.DEFAULT_THREADS,
              order: _views.PullOrder | None = None) -> torch.Tensor:
    """Recursive-traversal Φ: K7 partials + pull reduction, in the spans
    ``repro.phi.partials`` and ``repro.phi.pull``. ``pi`` holds the Π rows
    of the ALTO-ordered (padded) stream; ``order`` as in `mttkrp`."""
    faults.inject("ops.exec")
    meta = at.meta
    with trace.span("phi.partials"):
        partials = _phi.phi_partials(
            meta.enc, mode, meta.temp_rows[mode], eps, at.words, at.values,
            at.part_start, B, factors=factors, pi=pi, threads=threads)
    with trace.span("phi.pull"):
        if order is None:
            order = _views.get_pull_order(at, mode)
        return pull_reduction(partials, at.part_start[..., mode],
                              meta.dims[mode], threads, order)


def cpapr_phi_oriented(view: OrientedView, B: torch.Tensor, factors=None,
                       pi: torch.Tensor | None = None, eps: float = 1e-10,
                       block_m: int = _oriented.DEFAULT_BLOCK_M,
                       threads: int = _oriented.DEFAULT_THREADS
                       ) -> torch.Tensor:
    """Output-oriented Φ: K6 partials + `segment_merge`. ``pi`` holds the
    Π rows in the view's order."""
    faults.inject("ops.exec")
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
    faults.inject("ops.exec")
    rows, words, values, pi = pad_sorted_stream(view.rows, view.words,
                                                view.values, block_m, pi=pi)
    return _oriented.phi_oriented_carry(
        view.meta.enc, view.mode, eps, rows, words, values, B,
        factors=factors, pi=pi, block_m=block_m, threads=threads)


# ---------------------------------------------------------------------------
# Out-of-core chunked executors (host stream -> card, cross-chunk carry)
# ---------------------------------------------------------------------------
#
# The host loop that drives K8 / K9. A `HostStream` is cut at
# block_m-aligned bounds, and (out, carry_row, carry_val) thread from one
# chunk to the next, all on the card: nothing in the loop reads a value
# back or synchronizes the host with the compute stream.
#
# Double buffering on the card: two device chunk buffers, allocated on the
# compute stream; the host-to-device copies run on a side stream
# (`copy_(non_blocking=True)` from pinned memory), which first waits for
# all work already queued on the compute stream. The compute stream waits
# on a buffer's "copied" event before it computes on it; the copy stream
# waits on its "consumed" event before it overwrites it. A stream that is
# not pinned (a spill's memory map) is staged through two pinned buffers,
# one chunk each: the host then waits for the copy that last read the
# staging buffer, two chunks back. On the CPU the chunks are the stream's
# own slices, and the kernels' plain versions run.

_CHUNK_STATS = {"chunks": 0, "prefetches": 0}
_COPY_STREAMS: dict[int, "torch.cuda.Stream"] = {}


def chunk_stats() -> dict[str, int]:
    """Chunk-executor counters: chunks executed, and chunk copies started
    ahead of the compute (each chunk after a stream's first)."""
    with _LOCK:
        return dict(_CHUNK_STATS)


def chunk_stats_clear() -> None:
    with _LOCK:
        for k in _CHUNK_STATS:
            _CHUNK_STATS[k] = 0


def _bump(counter: str, n: int = 1) -> None:
    with _LOCK:
        _CHUNK_STATS[counter] += n


def _chunk_bounds(padded_len: int, chunk_m: int) -> list[tuple[int, int]]:
    """Chunk slice bounds over the padded stream (the last may be
    shorter)."""
    return [(s, min(s + chunk_m, padded_len))
            for s in range(0, padded_len, chunk_m)]


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _LOCK:
        s = _COPY_STREAMS.get(idx)
        if s is None:
            s = _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


def _chunks(hs: _stream.HostStream, bounds, device: torch.device):
    """The chunks ``(rows, words, values)`` of ``hs`` at ``bounds`` on
    ``device``, in order, the next chunk's copy in flight while the caller
    computes on the current one. The caller must enqueue all its work on
    a chunk before asking for the next."""
    if not bounds:
        return
    _bump("prefetches", len(bounds) - 1)
    if device.type != "cuda":
        for s, e in bounds:
            yield _stream.put_chunk(hs, s, e, device)
        return
    compute = torch.cuda.current_stream(device)
    copy = _copy_stream(device)
    # The buffers come from the compute stream's pool, where memory freed
    # by earlier work (an earlier call's chunk buffers) is reused at once:
    # the copy stream starts after everything queued on the compute stream.
    copy.wait_stream(compute)
    cap = max(e - s for s, e in bounds)
    srcs = (hs.rows, hs.words, hs.values)

    def buffers(**kw):
        return tuple(torch.empty((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                                 **kw) for t in srcs)

    bufs = [buffers(device=device) for _ in range(2)]
    for buf in bufs:
        for t in buf:
            t.record_stream(copy)
    staging = (None if hs.pinned
               else [buffers(pin_memory=True) for _ in range(2)])
    copied = [torch.cuda.Event() for _ in range(2)]
    consumed = [torch.cuda.Event() for _ in range(2)]

    def start_copy(i):
        faults.inject("stream.chunk_io")
        s, e = bounds[i]
        k, n = i % 2, e - s
        src = hs.chunk(s, e)
        if staging is not None:
            if i >= 2:
                copied[k].synchronize()     # chunk i-2 left staging[k]
            src = tuple(st[:n].copy_(t) for st, t in zip(staging[k], src))
        with torch.cuda.stream(copy):
            if i >= 2:
                copy.wait_event(consumed[k])
            for dst, t in zip(bufs[k], src):
                dst[:n].copy_(t, non_blocking=True)
            copied[k].record(copy)

    start_copy(0)
    for i, (s, e) in enumerate(bounds):
        if i + 1 < len(bounds):
            start_copy(i + 1)
        k = i % 2
        compute.wait_event(copied[k])
        yield tuple(t[:e - s] for t in bufs[k])
        consumed[k].record(compute)


def _chunk_setup(view, chunk_m: int, block_m: int):
    hs = _stream.ensure_host(view)
    if chunk_m % block_m:
        raise ValueError(f"chunk_m {chunk_m} not a multiple of block_m "
                         f"{block_m}")
    return hs, _chunk_bounds(hs.padded_len(block_m), chunk_m)


def _empty_carry(R: int, device):
    return (torch.full((1,), -1, dtype=torch.int32, device=device),
            torch.zeros((1, R), dtype=torch.float32, device=device))


def mttkrp_oriented_chunked(view, factors, *, chunk_m: int,
                            block_m: int = _oriented.DEFAULT_BLOCK_M,
                            r_block: int | None = None,
                            threads: int = _oriented.DEFAULT_THREADS
                            ) -> torch.Tensor:
    """Out-of-core carry MTTKRP: host stream -> (I_n, R) on the factors'
    device, one K8 per chunk.

    ``view`` is a `core.stream.HostStream` (or an in-core `OrientedView`,
    adapted). Bit-identical to `mttkrp_oriented_carry` at equal tiling:
    chunk bounds are block bounds of the same padded stream and the open
    run rides the carry across them.
    """
    hs, bounds = _chunk_setup(view, chunk_m, block_m)
    factors = list(factors)
    dev, R = factors[0].device, factors[0].shape[1]
    out = torch.zeros((hs.meta.dims[hs.mode], R), dtype=torch.float32,
                      device=dev)
    crow, cval = _empty_carry(R, dev)
    last = len(bounds) - 1
    for i, (rows, words, values) in enumerate(_chunks(hs, bounds, dev)):
        faults.inject("ops.chunk_oom")
        out, crow, cval = _oriented.carry_chunk(
            hs.meta.enc, hs.mode, rows, words, values, factors, out, crow,
            cval, block_m=block_m, r_block=r_block, threads=threads,
            final=i == last)
        _bump("chunks")
    return out


def cpapr_phi_oriented_chunked(view, B: torch.Tensor, factors, *,
                               pre: bool, eps: float = 1e-10, chunk_m: int,
                               block_m: int = _oriented.DEFAULT_BLOCK_M,
                               threads: int = _oriented.DEFAULT_THREADS
                               ) -> torch.Tensor:
    """Out-of-core carry Φ: host stream -> (I_n, R), one K9 per chunk.

    Takes ``factors`` under both Π policies. Under ``pre=True`` each
    chunk's Π rows are built on the device from the chunk's words
    (`pi_rows`), element for element the rows of a full-stream
    Π: bit-identical to the in-core ALTO-PRE carry path. (A padded
    element's Π row is not zero here but its value is, so its term is
    +0.0 as in core, for the non-negative factors of CP-APR.) Under
    ``pre=False`` K9 gathers the factors itself (ALTO-OTF).
    """
    hs, bounds = _chunk_setup(view, chunk_m, block_m)
    factors = list(factors)
    enc, mode = hs.meta.enc, hs.mode
    R = B.shape[1]
    out = torch.zeros((enc.dims[mode], R), dtype=torch.float32,
                      device=B.device)
    crow, cval = _empty_carry(R, B.device)
    last = len(bounds) - 1
    for i, (rows, words, values) in enumerate(_chunks(hs, bounds,
                                                      B.device)):
        faults.inject("ops.chunk_oom")
        if pre:
            kw = dict(pi=pi_rows(enc, words, factors, mode))
        else:
            kw = dict(factors=factors)
        out, crow, cval = _oriented.phi_carry_chunk(
            enc, mode, eps, rows, words, values, B, out, crow, cval,
            block_m=block_m, threads=threads, final=i == last, **kw)
        _bump("chunks")
    return out


def mttkrp_oriented_chunked_reference(view, factors, *,
                                      chunk_m: int) -> torch.Tensor:
    """Reference-backend chunked MTTKRP: the same chunk loop over the
    unpadded stream, each chunk a plain decode + Khatri-Rao +
    ``index_add_``. Within float tolerance of the in-core reference (the
    sums associate differently)."""
    hs = _stream.ensure_host(view)
    factors = list(factors)
    dev, R = factors[0].device, factors[0].shape[1]
    enc, mode = hs.meta.enc, hs.mode
    out = torch.zeros((enc.dims[mode], R), dtype=torch.float32, device=dev)
    for rows, words, values in _chunks(
            hs, _chunk_bounds(hs.length, chunk_m), dev):
        faults.inject("ops.chunk_oom")
        out.index_add_(0, rows.long(), core_mttkrp.contributions(
            enc, words, values, factors, mode))
        _bump("chunks")
    return out


def cpapr_phi_oriented_chunked_reference(view, B: torch.Tensor, factors, *,
                                         pre: bool, eps: float = 1e-10,
                                         chunk_m: int) -> torch.Tensor:
    """Reference-backend chunked Φ: per chunk the plain Φ terms
    (`core.mttkrp.phi_contributions`, Π rows rebuilt under ``pre``) and an
    ``index_add_``. Within float tolerance of the in-core path."""
    hs = _stream.ensure_host(view)
    factors = list(factors)
    enc, mode = hs.meta.enc, hs.mode
    out = torch.zeros((enc.dims[mode], B.shape[1]), dtype=torch.float32,
                      device=B.device)
    for rows, words, values in _chunks(
            hs, _chunk_bounds(hs.length, chunk_m), B.device):
        faults.inject("ops.chunk_oom")
        if pre:
            kw = dict(pi=core_mttkrp.krp_rows(
                core_mttkrp.delinearize(enc, words), factors, mode))
        else:
            kw = dict(factors=factors)
        out.index_add_(0, rows.long(), core_mttkrp.phi_contributions(
            enc, mode, words, values, rows, B, eps=eps, **kw))
        _bump("chunks")
    return out


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
