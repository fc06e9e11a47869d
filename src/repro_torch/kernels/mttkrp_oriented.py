"""Output-oriented MTTKRP kernels (K1 carry, K2 partials), their fix-up,
the CP-APR Φ kernels of the same traversals (K5 carry, K6 partials), and
the out-of-core chunk kernels of the carry route (K8 MTTKRP, K9 Φ).

Wrappers around the CUDA kernels of ``csrc/mttkrp_oriented.cu`` and
``csrc/phi_oriented.cu``, each with its plain PyTorch version beside it.
The input is the row-sorted stream of one mode (`core.alto.OrientedView`)
padded to a multiple of ``block_m`` (`ops.pad_sorted_stream`). Slice
``b`` of the stream is elements ``[b·block_m, (b+1)·block_m)``; a *run* is
a maximal stretch of equal rows inside one slice.

* `carry_runs` (K1, first pass): per slice, every run that begins and
  ends inside it goes straight to ``out``; the first and last runs go to
  the carries ``(n_blocks, 2)`` rows / ``(n_blocks, 2, R)`` values (row
  -1 where a slice holds a single run). On the card a sub-warp of lanes
  owns a slice, about four rank columns a lane (`lane_map`), and the pass
  also stores zeros to the rows the stream skips, so ``out`` needs no
  zeroing first.
* `carry_fixup` (K1, second pass): adds each row's carried pieces in
  block order and stores the sum to the row of ``out`` (on the card a
  warp per tile of 32 pieces, staged in shared memory, a chain that
  leaves the tile walked on a window of 32 steps at a time;
  ``csrc/carry_fixup.cuh``). With the runs pass, every row of K1's
  ``out`` is written exactly once.
* `oriented_partials` (K2): slot ``j`` of slice ``b`` holds the sum of the
  slice's ``j``-th run, zeros elsewhere — the JAX partials layout. On the
  card it is K1's runs pass storing each finished run to the slice's next
  slot (K1's lane map and loads), every slot written.
* `segment_split`: the first half of `ops.segment_merge` — slots -> the
  inner runs in ``out`` and the first and last runs in K1's carries, for
  `carry_fixup`. On the card a warp per slice stores, as K1's runs pass
  does, every row but the carried ones (inner runs and the zeros of the
  rows the stream skips), so ``out`` needs no zeroing first; its plain
  version is `split_block_runs`.
* `phi_carry_runs` (K5) and `phi_oriented_partials` (K6): the same two
  traversals summing the Φ term (`core.mttkrp.phi_contributions`) in
  place of the MTTKRP term, over the whole rank (``r_block == R``). On
  the card K5, K6 and K9 share one runs pass: each slice a sub-warp whose
  lanes hold the rank columns and share the denominator through shuffles;
  ``threads`` is then the CTA size (whole warps). K5's pass, as K1's,
  stores zeros to the rows the stream skips, so its ``out`` needs no
  zeroing first.
* `carry_chunk` (K8) and `phi_carry_chunk` (K9): K1 / K5 over one chunk
  of a longer stream (``csrc/carry_chunk.cuh``). They take the running
  ``out`` and the open run so far, ``(carry_row (1,) int32, carry_val
  (1, R))`` with row -1 for none, and return ``(out, carry_row,
  carry_val)``: the run still open at the chunk's end, or (-1, zeros)
  after the ``final`` chunk. ``out`` is updated in place.

A row window. `carry_runs`, `phi_carry_runs` and the K1 / K5 ops on them
take ``n_rows``: the output (and Φ's B) is then the ``(n_rows, R)``
window of rows ``[lo, lo + n_rows)`` of the mode, and the stream's rows
are given relative to ``lo``. A slice of the stream whose rows span only
part of the mode (`repro_torch.dist.cpd`) runs on its window: the runs
pass stores the zeros of the rows it skips serially, one sub-warp per
gap, so the gaps below and above a slice would otherwise be written row
by row by a single sub-warp.

The tenant axis. `carry_runs`, `carry_fixup`, `oriented_partials`,
`segment_split`, `phi_carry_runs` and `phi_oriented_partials` (and the
ops built on them) also take a bucket of T tenants of one shape class
(`core.batched`): every operand stacked with a leading tenant axis —
rows ``(T, M)``, words ``(T, M, W)``, factors ``(T, I_m, R)``, B and Π
``(T, ...)``, out ``(T, I_n, R)``, carries ``(T, n_blocks, 2[, R])``,
slots ``(T, n_blocks, block_m, R)`` — in one launch whose grid holds the
tenants (``blockIdx.z``). Inside a tenant every tiling, lane and sum is
the solo launch's, so each tenant gets the bits of its solo launch; the
plain versions loop over the tenants.

Accumulation order, shared by every kernel and plain version: a run sums
its terms in stream order starting from 0.0, and a row's pieces add in
block order. So K1 equals K2 + `ops.segment_merge` bit for bit, K5 equals
K6 + `ops.segment_merge`, and K1 (K5) equals K8 (K9) chained over the
chunks of the same stream, on the CPU through the plain versions and on
the card through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding
from repro_torch.core.mttkrp import contributions, phi_contributions
from repro_torch.kernels import _build, common

DEFAULT_BLOCK_M = 256
DEFAULT_THREADS = 128

# K1's lane maps, (lanes per slice, columns per lane), smallest first: the
# runs pass takes the first whose lanes × columns cover r_block (the
# `launch_mttkrp_carry_runs` dispatch in csrc/mttkrp_oriented.cu builds
# these and no other).
LANE_MAPS = ((2, 4), (4, 4), (8, 4), (32, 4))


def lane_map(r_block: int) -> tuple[int, int]:
    """K1's lane map for a rank tile of ``r_block`` columns: about four
    columns a lane, as K5's (``phi_dispatch``)."""
    for lanes, cols in LANE_MAPS:
        if lanes * cols >= r_block:
            return lanes, cols
    raise ValueError(f"r_block {r_block} exceeds the widest lane map "
                     f"{LANE_MAPS[-1]}")


def run_rank_segments(rows: torch.Tensor) -> torch.Tensor:
    """Run-rank segment ids along the last axis of a sorted row array:
    slot of each element's run inside its slice (int64)."""
    is_new = torch.zeros(rows.shape, dtype=torch.int64, device=rows.device)
    is_new[..., 1:] = (rows[..., 1:] != rows[..., :-1]).long()
    return is_new.cumsum(-1)


def _check_rows(enc, rows, words, values, block_m):
    """The stream's checks; returns its length per tenant and the tenant
    axis (`common.tenant_lead`)."""
    lead = common.tenant_lead(rows)
    M = rows.shape[-1]
    if M % block_m:
        raise ValueError(f"stream length {M} not a multiple of block_m "
                         f"{block_m}")
    common.check_tensor(rows, "rows", torch.int32, lead + (M,))
    common.check_tensor(words, "words", torch.int32,
                        lead + (M, enc.n_words))
    common.check_tensor(values, "values", torch.float32, lead + (M,))
    return M, lead


def _check_stream(enc, rows, words, values, factors, block_m, r_block):
    M, lead = _check_rows(enc, rows, words, values, block_m)
    R = factors[0].shape[-1]
    if R % r_block:
        raise ValueError(f"rank {R} not a multiple of r_block {r_block}")
    common.check_factors(enc, factors, R, lead)
    return M, R, lead


def tenant_loop(fn, lead, *args):
    """A plain version over a bucket: ``fn`` on each tenant's operands
    (`common.at_tenant`), the results stacked (tuples part by part); one
    call for a single tensor."""
    if not lead:
        return fn(*args)
    parts = [fn(*(common.at_tenant(a, t) for a in args))
             for t in range(lead[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.stack(z) for z in zip(*parts))
    return torch.stack(parts)


# ---------------------------------------------------------------------------
# Plain versions (PyTorch, any device)
# ---------------------------------------------------------------------------

def block_run_sums(contrib: torch.Tensor, rows: torch.Tensor,
                   block_m: int) -> torch.Tensor:
    """(n_blocks, block_m, R) run sums of the (M, R) terms, in stream
    order."""
    M, R = contrib.shape
    nb = M // block_m
    seg = run_rank_segments(rows.reshape(nb, block_m))
    slot = torch.arange(nb, device=rows.device)[:, None] * block_m + seg
    sums = contrib.new_zeros((M, R)).index_add_(0, slot.reshape(-1), contrib)
    return sums.reshape(nb, block_m, R)


def split_block_runs(partials: torch.Tensor, rows: torch.Tensor,
                     out_dim: int, out: torch.Tensor | None = None):
    """Per-slice run sums -> (out holding every inner run, carry rows,
    carry values): the hand-off from K1's first pass or K2 to
    `carry_fixup`. Deterministic: inner runs go to distinct rows. The
    inner runs are stored into ``out`` when given (a chunk's running
    output), else into zeros."""
    nb, bm, R = partials.shape
    rows_b = rows.reshape(nb, bm)
    seg = run_rank_segments(rows_b)
    last = seg[:, -1]                                   # runs - 1 per slice
    seg_rows = torch.zeros_like(rows_b).scatter_(1, seg, rows_b)
    j = torch.arange(bm, device=rows.device)[None, :]
    inner = (j > 0) & (j < last[:, None])
    if out is None:
        out = partials.new_zeros((out_dim, R))
    out[seg_rows[inner].long()] = partials[inner]
    b = torch.arange(nb, device=rows.device)
    many = last > 0
    carry_row = torch.stack(
        [seg_rows[:, 0], torch.where(many, seg_rows[b, last], -1)], dim=1)
    carry_val = torch.stack(
        [partials[:, 0], torch.where(many[:, None], partials[b, last], 0.0)],
        dim=1)
    return out, carry_row.contiguous(), carry_val.contiguous()


def segment_split_plain(partials: torch.Tensor, rows: torch.Tensor,
                        out_dim: int):
    """Plain version of the split kernel: `split_block_runs` into zeros."""
    _build.count_plain("segment_split", rows)
    return split_block_runs(partials, rows, out_dim)


def carry_runs_plain(enc: AltoEncoding, mode: int, rows, words, values,
                     factors, block_m: int, n_rows: int | None = None):
    """Plain version of K1's first pass: (out, carry_row, carry_val)."""
    _build.count_plain("carry_runs", rows)
    sums = block_run_sums(contributions(enc, words, values, factors, mode),
                          rows, block_m)
    return split_block_runs(sums, rows, n_rows or enc.dims[mode])


def carry_fixup_plain(carry_row, carry_val, out):
    """Plain version of the fix-up: store to each carried row the sum of
    its pieces, added in piece order from 0.0."""
    _build.count_plain("carry_fixup", out)
    rows = carry_row.reshape(-1)
    keep = rows >= 0
    dst = rows[keep].long()
    return out.index_fill_(0, dst, 0.0).index_add_(
        0, dst, carry_val.reshape(rows.shape[0], -1)[keep])


def carry_fixup_chunk_plain(pieces_row, pieces_val, out, carry_row,
                            carry_val, final: bool):
    """Plain version of the chunk fix-up (K8, K9): the carry-in is the
    first piece, every row's pieces add in piece order into ``out``, and
    in a non-final chunk the last row's sum is handed on instead.
    Returns ``(out, carry_row, carry_val)``."""
    R = out.shape[1]
    rows = torch.cat([carry_row.reshape(-1), pieces_row.reshape(-1)])
    vals = torch.cat([carry_val.reshape(-1, R), pieces_val.reshape(-1, R)])
    keep = rows >= 0
    rows, vals = rows[keep].long(), vals[keep]
    if final:
        return (out.index_add_(0, rows, vals), carry_row.new_full((1,), -1),
                carry_val.new_zeros((1, R)))
    tail = rows == rows[-1]
    out.index_add_(0, rows[~tail], vals[~tail])
    cout = vals.new_zeros((1, R)).index_add_(
        0, torch.zeros_like(rows[tail]), vals[tail])
    return out, rows[-1:].to(torch.int32), cout


def carry_chunk_plain(enc: AltoEncoding, mode: int, rows, words, values,
                      factors, out, carry_row, carry_val, block_m: int,
                      final: bool):
    """Plain version of K8: ``(out, carry_row, carry_val)``."""
    _build.count_plain("carry_chunk", rows)
    sums = block_run_sums(contributions(enc, words, values, factors, mode),
                          rows, block_m)
    _, p_row, p_val = split_block_runs(sums, rows, enc.dims[mode], out=out)
    return carry_fixup_chunk_plain(p_row, p_val, out, carry_row, carry_val,
                                   final)


def phi_carry_chunk_plain(enc: AltoEncoding, mode: int, eps: float, rows,
                          words, values, B, out, carry_row, carry_val,
                          factors=None, pi=None,
                          block_m: int = DEFAULT_BLOCK_M,
                          final: bool = True):
    """Plain version of K9: ``(out, carry_row, carry_val)``."""
    _build.count_plain("phi_carry_chunk", rows)
    contrib = phi_contributions(enc, mode, words, values, rows, B,
                                factors=factors, pi=pi, eps=eps)
    _, p_row, p_val = split_block_runs(block_run_sums(contrib, rows,
                                                      block_m),
                                       rows, enc.dims[mode], out=out)
    return carry_fixup_chunk_plain(p_row, p_val, out, carry_row, carry_val,
                                   final)


def oriented_partials_plain(enc: AltoEncoding, mode: int, rows, words,
                            values, factors, block_m: int) -> torch.Tensor:
    """Plain version of K2: (n_blocks, block_m, R) run sums."""
    _build.count_plain("oriented_partials", rows)
    return block_run_sums(contributions(enc, words, values, factors, mode),
                          rows, block_m)


def phi_carry_runs_plain(enc: AltoEncoding, mode: int, eps: float, rows,
                         words, values, B, factors=None, pi=None,
                         block_m: int = DEFAULT_BLOCK_M,
                         n_rows: int | None = None):
    """Plain version of K5's first pass: (out, carry_row, carry_val)."""
    _build.count_plain("phi_carry_runs", rows)
    contrib = phi_contributions(enc, mode, words, values, rows, B,
                                factors=factors, pi=pi, eps=eps)
    return split_block_runs(block_run_sums(contrib, rows, block_m), rows,
                            n_rows or enc.dims[mode])


def phi_oriented_partials_plain(enc: AltoEncoding, mode: int, eps: float,
                                rows, words, values, B, factors=None,
                                pi=None, block_m: int = DEFAULT_BLOCK_M
                                ) -> torch.Tensor:
    """Plain version of K6: (n_blocks, block_m, R) Φ run sums."""
    _build.count_plain("phi_oriented_partials", rows)
    contrib = phi_contributions(enc, mode, words, values, rows, B,
                                factors=factors, pi=pi, eps=eps)
    return block_run_sums(contrib, rows, block_m)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _runs_into(plain, out):
    """A runs pass's plain result ``(out, carry_row, carry_val)`` with its
    kernel's write set into ``out`` when given: every row but the carried
    pieces' rows, which the fix-up stores (tenant by tenant for a
    bucket)."""
    if out is None:
        return plain
    if out.dim() == 3:
        for t in range(out.shape[0]):
            _runs_into(tuple(x[t] for x in plain), out[t])
        return (out,) + plain[1:]
    written = torch.ones(out.shape[0], dtype=torch.bool)
    written[plain[1][plain[1] >= 0].long()] = False
    out[written] = plain[0][written]
    return (out,) + plain[1:]


def _window(enc, mode, lead, n_rows) -> int:
    """The output's rows: the mode's extent, or a row window's (one
    tensor only: a bucket's strides are the extents')."""
    if n_rows is None:
        return enc.dims[mode]
    if lead or not 0 < n_rows <= enc.dims[mode]:
        raise ValueError(f"row window of {n_rows} rows for mode extent "
                         f"{enc.dims[mode]}" + (" in a bucket" if lead
                                                else ""))
    return n_rows


def carry_runs(enc: AltoEncoding, mode: int, rows, words, values, factors,
               block_m: int = DEFAULT_BLOCK_M, r_block: int | None = None,
               threads: int = DEFAULT_THREADS, out=None,
               n_rows: int | None = None):
    """K1, first pass: (out with inner runs, carry_row, carry_val). On the
    card ``out`` (``torch.empty`` unless given) gets every row except the
    carried pieces' rows, which `carry_fixup` stores. ``n_rows``: a row
    window (module docstring)."""
    factors = list(factors)
    rb = r_block or common.rank_tile(factors[0].shape[-1])
    M, R, lead = _check_stream(enc, rows, words, values, factors, block_m,
                               rb)
    lanes, cols = lane_map(rb)
    I_out = _window(enc, mode, lead, n_rows)
    if out is not None:
        common.check_tensor(out, "out", torch.float32, lead + (I_out, R))
    if not common.on_cuda(rows, words, values, *factors,
                          *([] if out is None else [out])):
        return _runs_into(tenant_loop(
            lambda *a: carry_runs_plain(enc, mode, *a, block_m, n_rows),
            lead, rows, words, values, factors), out)
    nb = M // block_m
    if out is None:
        out = torch.empty(lead + (I_out, R), dtype=torch.float32,
                          device=rows.device)
    carry_row = torch.empty(lead + (nb, 2), dtype=torch.int32,
                            device=rows.device)
    carry_val = torch.empty(lead + (nb, 2, R), dtype=torch.float32,
                            device=rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("mttkrp_oriented")
    status = lib.alto_carry_runs(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb, rb,
        lanes, cols, common.cta_threads(threads), I_out,
        out.data_ptr(), carry_row.data_ptr(), carry_val.data_ptr(),
        *tenants, common.stream_ptr(rows))
    del keep, strides
    _build.check(status, "alto_carry_runs")
    _build.count_launch("carry_runs", rows.numel())
    return out, carry_row, carry_val


def carry_fixup(carry_row, carry_val, out, r_block: int | None = None,
                threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """K1, second pass: stores each row's carried pieces, added in piece
    order, to its row of ``out`` (in place) and returns it.

    ``carry_row`` is ``(n, slots)``: two slots per block for K1's carries
    (first and last run, row -1 when absent), or one slot per piece, every
    piece present and sorted by row (the pull reduction). ``r_block`` is
    the launch's rank tile (default `common.rank_tile`; it changes no
    bit); ``threads`` its CTA size. A bucket's carries ``(T, n, slots)``
    and out ``(T, I_n, R)`` walk tenant by tenant: rows are tenant-local,
    so one tenant's chain never continues into the next's."""
    if carry_row.dim() not in (2, 3):
        raise ValueError(f"carry_row of shape {tuple(carry_row.shape)}")
    lead = tuple(carry_row.shape[:-2])
    nb, slots = carry_row.shape[-2:]
    R = out.shape[-1]
    rb = r_block or common.rank_tile(R)
    if R % rb or rb > common.MAX_RANK_TILE:
        raise ValueError(f"rank {R}: r_block {rb} does not divide it or "
                         f"exceeds {common.MAX_RANK_TILE}")
    if slots not in (1, 2):
        raise ValueError(f"carry_row has {slots} slots, not 1 or 2")
    common.check_tensor(carry_row, "carry_row", torch.int32,
                        lead + (nb, slots))
    common.check_tensor(carry_val, "carry_val", torch.float32,
                        lead + (nb, slots, R))
    common.check_tensor(out, "out", torch.float32,
                        lead + tuple(out.shape[-2:]))
    if not common.on_cuda(carry_row, carry_val, out):
        tenant_loop(carry_fixup_plain, lead, carry_row, carry_val, out)
        return out                     # updated in place, tenant by tenant
    lib = _build.library("mttkrp_oriented")
    status = lib.alto_carry_fixup(
        carry_row.data_ptr(), carry_val.data_ptr(), slots * nb, slots, R,
        rb, common.cta_threads(threads), out.data_ptr(),
        lead[0] if lead else 1, out[0].numel() if lead else 0,
        common.stream_ptr(out))
    _build.check(status, "alto_carry_fixup")
    _build.count_launch("carry_fixup", carry_row.numel())
    return out


def mttkrp_oriented_carry(enc: AltoEncoding, mode: int, rows, words, values,
                          factors, block_m: int = DEFAULT_BLOCK_M,
                          r_block: int | None = None,
                          threads: int = DEFAULT_THREADS,
                          out=None, n_rows: int | None = None
                          ) -> torch.Tensor:
    """K1: sorted stream -> final (I_n, R) MTTKRP (both passes), into
    ``out`` when given (every row is overwritten); ``n_rows``: a row
    window (module docstring)."""
    out, carry_row, carry_val = carry_runs(enc, mode, rows, words, values,
                                           factors, block_m, r_block,
                                           threads, out, n_rows)
    return carry_fixup(carry_row, carry_val, out, threads=threads)


def oriented_partials(enc: AltoEncoding, mode: int, rows, words, values,
                      factors, block_m: int = DEFAULT_BLOCK_M,
                      r_block: int | None = None,
                      threads: int = DEFAULT_THREADS,
                      out=None) -> torch.Tensor:
    """K2: per-slice run sums (n_blocks, block_m, R), into ``out`` when
    given (every slot is overwritten). On the card K1's runs pass in rank
    tiles of ``r_block`` (default `common.rank_tile`) stores the slice's
    j-th run sum to slot j and zeros to the unused slots; ``threads`` is
    the CTA size."""
    factors = list(factors)
    rb = r_block or common.rank_tile(factors[0].shape[-1])
    M, R, lead = _check_stream(enc, rows, words, values, factors, block_m,
                               rb)
    lanes, cols = lane_map(rb)
    nb = M // block_m
    if out is not None:
        common.check_tensor(out, "out", torch.float32,
                            lead + (nb, block_m, R))
    if not common.on_cuda(rows, words, values, *factors,
                          *([] if out is None else [out])):
        plain = tenant_loop(
            lambda *a: oriented_partials_plain(enc, mode, *a, block_m),
            lead, rows, words, values, factors)
        return plain if out is None else out.copy_(plain)
    if out is None:
        out = torch.empty(lead + (nb, block_m, R), dtype=torch.float32,
                          device=rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("mttkrp_oriented")
    status = lib.alto_oriented_partials(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb, rb,
        lanes, cols, common.cta_threads(threads), out.data_ptr(), *tenants,
        common.stream_ptr(rows))
    del keep, strides
    _build.check(status, "alto_oriented_partials")
    _build.count_launch("oriented_partials", rows.numel())
    return out


def segment_split(partials, rows, out_dim: int,
                  threads: int = DEFAULT_THREADS, out=None):
    """Per-slice run sums -> ``(out with the inner runs, carry_row,
    carry_val)``, the hand-off to `carry_fixup` (K1's carries layout). On
    the card ``out`` (``torch.empty`` unless given) gets every row except
    the carried pieces' rows, which `carry_fixup` stores; ``threads`` is
    the CTA size (a warp per slice)."""
    lead = common.tenant_lead(rows)
    if partials.dim() != len(lead) + 3:
        raise ValueError(f"partials of shape {tuple(partials.shape)} for "
                         f"rows of shape {tuple(rows.shape)}")
    nb, bm, R = partials.shape[-3:]
    common.check_tensor(partials, "partials", torch.float32,
                        lead + (nb, bm, R))
    common.check_tensor(rows, "rows", torch.int32, lead + (nb * bm,))
    if out is not None:
        common.check_tensor(out, "out", torch.float32, lead + (out_dim, R))
    if not common.on_cuda(partials, rows, *([] if out is None else [out])):
        return _runs_into(tenant_loop(
            lambda p, r: segment_split_plain(p, r, out_dim), lead,
            partials, rows), out)
    if out is None:
        out = torch.empty(lead + (out_dim, R), dtype=torch.float32,
                          device=rows.device)
    carry_row = torch.empty(lead + (nb, 2), dtype=torch.int32,
                            device=rows.device)
    carry_val = torch.empty(lead + (nb, 2, R), dtype=torch.float32,
                            device=rows.device)
    lanes, cols = lane_map(common.rank_tile(R))
    status = _build.library("mttkrp_oriented").alto_segment_split(
        partials.data_ptr(), rows.data_ptr(), bm, nb, R, lanes, cols,
        common.cta_threads(threads), out_dim, out.data_ptr(),
        carry_row.data_ptr(), carry_val.data_ptr(),
        lead[0] if lead else 1, common.stream_ptr(rows))
    _build.check(status, "alto_segment_split")
    _build.count_launch("segment_split", rows.numel())
    return out, carry_row, carry_val


def phi_carry_runs(enc: AltoEncoding, mode: int, eps: float, rows, words,
                   values, B, factors=None, pi=None,
                   block_m: int = DEFAULT_BLOCK_M,
                   r_block: int | None = None,
                   threads: int = DEFAULT_THREADS, out=None,
                   n_rows: int | None = None):
    """K5, first pass: (out with inner runs, carry_row, carry_val). Pass
    ``pi`` (the stream's Π rows, ALTO-PRE) or ``factors`` (ALTO-OTF). As
    K1's, the pass stores zeros to the rows the stream skips, so ``out``
    (``torch.empty`` unless given) gets every row except the carried
    pieces' rows, which `carry_fixup` stores. ``n_rows``: a row window
    of out and B (module docstring)."""
    M, lead = _check_rows(enc, rows, words, values, block_m)
    I_out = _window(enc, mode, lead, n_rows)
    factors, R = common.check_phi_operands(enc, mode, M, B, factors, pi,
                                           r_block, lead, I_out)
    if out is not None:
        common.check_tensor(out, "out", torch.float32, lead + (I_out, R))
    tensors = [rows, words, values, B] + (factors or [pi]) + (
        [] if out is None else [out])
    if not common.on_cuda(*tensors):
        return _runs_into(tenant_loop(
            lambda r, w, v, b, f, p: phi_carry_runs_plain(
                enc, mode, eps, r, w, v, b, f, p, block_m, n_rows),
            lead, rows, words, values, B, factors, pi), out)
    nb = M // block_m
    if out is None:
        out = torch.empty(lead + (I_out, R), dtype=torch.float32,
                          device=rows.device)
    carry_row = torch.empty(lead + (nb, 2), dtype=torch.int32,
                            device=rows.device)
    carry_val = torch.empty(lead + (nb, 2, R), dtype=torch.float32,
                            device=rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("phi_oriented")
    status = lib.alto_phi_carry_runs(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        B.data_ptr(), None if pi is None else pi.data_ptr(), eps,
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb,
        threads, I_out, out.data_ptr(), carry_row.data_ptr(),
        carry_val.data_ptr(), *tenants, common.stream_ptr(rows))
    del keep, strides
    _build.check(status, "alto_phi_carry_runs")
    _build.count_launch("phi_carry_runs", rows.numel())
    return out, carry_row, carry_val


def phi_oriented_carry(enc: AltoEncoding, mode: int, eps: float, rows,
                       words, values, B, factors=None, pi=None,
                       block_m: int = DEFAULT_BLOCK_M,
                       threads: int = DEFAULT_THREADS,
                       out=None, n_rows: int | None = None) -> torch.Tensor:
    """K5: sorted stream -> final (I_n, R) Φ (runs, then K1's fix-up),
    into ``out`` when given (every row is overwritten); ``n_rows``: a row
    window of out and B (module docstring)."""
    out, carry_row, carry_val = phi_carry_runs(
        enc, mode, eps, rows, words, values, B, factors, pi, block_m,
        threads=threads, out=out, n_rows=n_rows)
    return carry_fixup(carry_row, carry_val, out, threads=threads)


def phi_oriented_partials(enc: AltoEncoding, mode: int, eps: float, rows,
                          words, values, B, factors=None, pi=None,
                          block_m: int = DEFAULT_BLOCK_M,
                          r_block: int | None = None,
                          threads: int = DEFAULT_THREADS,
                          n_rows: int | None = None) -> torch.Tensor:
    """K6: per-slice Φ run sums (n_blocks, block_m, R). On the card K5's
    runs pass (a sub-warp per slice) stores the slice's j-th run sum to
    slot j and zeros to the unused slots; ``threads`` is the CTA size.
    ``n_rows``: B is a row window (module docstring)."""
    M, lead = _check_rows(enc, rows, words, values, block_m)
    factors, R = common.check_phi_operands(
        enc, mode, M, B, factors, pi, r_block, lead,
        _window(enc, mode, lead, n_rows))
    tensors = [rows, words, values, B] + (factors or [pi])
    if not common.on_cuda(*tensors):
        return tenant_loop(
            lambda r, w, v, b, f, p: phi_oriented_partials_plain(
                enc, mode, eps, r, w, v, b, f, p, block_m),
            lead, rows, words, values, B, factors, pi)
    nb = M // block_m
    partials = torch.empty(lead + (nb, block_m, R), dtype=torch.float32,
                           device=rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("phi_oriented")
    status = lib.alto_phi_oriented_partials(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        B.data_ptr(), None if pi is None else pi.data_ptr(), eps,
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb,
        threads, partials.data_ptr(), *tenants, common.stream_ptr(rows))
    del keep, strides
    _build.check(status, "alto_phi_oriented_partials")
    _build.count_launch("phi_oriented_partials", rows.numel())
    return partials


# ---------------------------------------------------------------------------
# Out-of-core chunk kernels (K8, K9)
# ---------------------------------------------------------------------------

def _check_chunk_state(enc, mode, M, out, carry_row, carry_val, R, lead):
    if lead:
        raise ValueError("the chunk kernels take one tensor, not a bucket")
    if M == 0:
        raise ValueError("empty chunk: a chunk holds at least one block")
    common.check_tensor(out, "out", torch.float32, (enc.dims[mode], R))
    common.check_tensor(carry_row, "carry_row", torch.int32, (1,))
    common.check_tensor(carry_val, "carry_val", torch.float32, (1, R))


def _chunk_scratch(nb: int, R: int, device):
    """Pieces (n_blocks, 2) rows and (n_blocks, 2, R) values, and the
    carry handed on: one (1,) row and one (1, R) value."""
    return (torch.empty((nb, 2), dtype=torch.int32, device=device),
            torch.empty((nb, 2, R), dtype=torch.float32, device=device),
            torch.empty((1,), dtype=torch.int32, device=device),
            torch.empty((1, R), dtype=torch.float32, device=device))


def carry_chunk(enc: AltoEncoding, mode: int, rows, words, values, factors,
                out, carry_row, carry_val, block_m: int = DEFAULT_BLOCK_M,
                r_block: int | None = None, threads: int = DEFAULT_THREADS,
                final: bool = True):
    """K8: one chunk of the carry MTTKRP -> ``(out, carry_row,
    carry_val)``. ``out`` is updated in place."""
    factors = list(factors)
    rb = r_block or common.rank_tile(factors[0].shape[1])
    M, R, lead = _check_stream(enc, rows, words, values, factors, block_m,
                               rb)
    _check_chunk_state(enc, mode, M, out, carry_row, carry_val, R, lead)
    if not common.on_cuda(rows, words, values, *factors, out, carry_row,
                          carry_val):
        return carry_chunk_plain(enc, mode, rows, words, values, factors,
                                 out, carry_row, carry_val, block_m, final)
    nb = M // block_m
    lanes, cols = lane_map(rb)
    p_row, p_val, c_row, c_val = _chunk_scratch(nb, R, rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    lib = _build.library("mttkrp_oriented")
    status = lib.alto_carry_chunk(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb, rb,
        lanes, cols, common.cta_threads(threads), out.data_ptr(),
        p_row.data_ptr(), p_val.data_ptr(), carry_row.data_ptr(),
        carry_val.data_ptr(), int(final), c_row.data_ptr(), c_val.data_ptr(),
        common.stream_ptr(rows))
    del keep
    _build.check(status, "alto_carry_chunk")
    _build.count_launch("carry_chunk", M)
    return out, c_row, c_val


def phi_carry_chunk(enc: AltoEncoding, mode: int, eps: float, rows, words,
                    values, B, out, carry_row, carry_val, factors=None,
                    pi=None, block_m: int = DEFAULT_BLOCK_M,
                    threads: int = DEFAULT_THREADS, final: bool = True):
    """K9: one chunk of the carry Φ -> ``(out, carry_row, carry_val)``.
    Pass ``pi`` (the chunk's Π rows, ALTO-PRE) or ``factors`` (ALTO-OTF).
    ``out`` is updated in place."""
    M, lead = _check_rows(enc, rows, words, values, block_m)
    factors, R = common.check_phi_operands(enc, mode, M, B, factors, pi,
                                           None)
    _check_chunk_state(enc, mode, M, out, carry_row, carry_val, R, lead)
    tensors = [rows, words, values, B, out, carry_row, carry_val] + (
        factors or [pi])
    if not common.on_cuda(*tensors):
        return phi_carry_chunk_plain(enc, mode, eps, rows, words, values, B,
                                     out, carry_row, carry_val, factors, pi,
                                     block_m, final)
    nb = M // block_m
    p_row, p_val, c_row, c_val = _chunk_scratch(nb, R, rows.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    lib = _build.library("phi_oriented")
    status = lib.alto_phi_carry_chunk(
        *args, rows.data_ptr(), words.data_ptr(), values.data_ptr(),
        B.data_ptr(), None if pi is None else pi.data_ptr(), eps,
        common.decode_table(enc, rows.device).data_ptr(), block_m, nb,
        threads, common.rank_tile(R), out.data_ptr(),
        p_row.data_ptr(), p_val.data_ptr(),
        carry_row.data_ptr(), carry_val.data_ptr(), int(final),
        c_row.data_ptr(), c_val.data_ptr(), common.stream_ptr(rows))
    del keep
    _build.check(status, "alto_phi_carry_chunk")
    _build.count_launch("phi_carry_chunk", M)
    return out, c_row, c_val
