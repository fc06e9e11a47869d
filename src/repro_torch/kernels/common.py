"""Argument checks and C-argument packing shared by the kernel wrappers.

A wrapper takes a kernel's plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises (`on_cuda`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.encoding import AltoEncoding
from repro_torch.kernels import _build

MAX_MODES = 8      # ALTO_MAX_MODES in csrc/alto_decode.cuh
MAX_RUNS = 128     # ALTO_MAX_RUNS


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel, False to run the plain version.

    All tensors must share one device, CPU or CUDA; anything else raises.
    """
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_factors(enc: AltoEncoding, factors, rank: int,
                  lead: tuple = ()) -> None:
    """Factor m is ``lead + (I_m, rank)``: ``lead`` is ``(T,)`` for a
    bucket of T tenants (`tenant_lead`), else empty."""
    if len(factors) != enc.ndim:
        raise ValueError(f"{len(factors)} factors for {enc.ndim} modes")
    for m, f in enumerate(factors):
        check_tensor(f, f"factor {m}", torch.float32,
                     lead + (enc.dims[m], rank))


def tenant_lead(rows: torch.Tensor) -> tuple:
    """The tenant axis of a stream: ``()`` for one tensor's ``(M,)`` rows,
    ``(T,)`` for a bucket's stacked ``(T, M)``."""
    if rows.dim() not in (1, 2):
        raise ValueError(f"rows of shape {tuple(rows.shape)}: expected "
                         f"(M,) or (T, M)")
    return tuple(rows.shape[:-1])


def tenant_args(enc: AltoEncoding, mode: int, rank: int, lead: tuple):
    """The C entries' tenant arguments: the count and the host strides
    (elements between two tenants' factor m, then their out and B), or
    ``(1, None)`` for one tensor. The strides array comes first, for the
    caller to keep alive across the call."""
    if not lead:
        return None, [1, None]
    strides = np.array([I * rank for I in enc.dims]
                       + [enc.dims[mode] * rank], dtype=np.int64)
    return strides, [lead[0], strides.ctypes.data_as(ctypes.c_void_p)]


def at_tenant(x, t: int):
    """Tenant ``t`` of a stacked operand: a tensor's row t, a list's
    tensors' rows t; None and scalars as they are."""
    if isinstance(x, torch.Tensor):
        return x[t]
    if isinstance(x, (list, tuple)):
        return [a[t] for a in x]
    return x


def check_phi_operands(enc, mode: int, M: int, B, factors, pi,
                       r_block: int | None, lead: tuple = (),
                       n_rows: int | None = None):
    """Checks shared by the Φ wrappers: exactly one of ``factors`` (OTF)
    and ``pi`` (PRE), B ``(I_n, R)`` (``(n_rows, R)`` for a row window),
    and no rank tiles; each with the leading tenant axis ``lead`` of a
    bucket. Returns the factors as a list (or None) and R."""
    if (pi is None) == (factors is None):
        raise ValueError("pass exactly one of pi= / factors=")
    R = B.shape[-1]
    if r_block not in (None, R):
        raise ValueError(f"the Φ kernels take the whole rank: r_block "
                         f"{r_block} != R {R}")
    if R > 1024:
        raise ValueError(f"rank {R} exceeds one CTA's 1024 threads")
    check_tensor(B, "B", torch.float32,
                 lead + (n_rows or enc.dims[mode], R))
    if pi is not None:
        check_tensor(pi, "pi", torch.float32, lead + (M, R))
        return None, R
    factors = list(factors)
    check_factors(enc, factors, R, lead)
    return factors, R


@functools.lru_cache(maxsize=256)
def _runs_table(enc: AltoEncoding) -> np.ndarray:
    """(n_runs, 5) int32 rows (word, mode, src, dst, length), by mode."""
    runs = sorted(enc.runs, key=lambda r: r.mode)     # stable: keeps order
    table = np.array([(r.word, r.mode, r.src_shift, r.dst_shift, r.length)
                      for r in runs], dtype=np.int32).reshape(-1, 5)
    table.setflags(write=False)
    return table


def runs_table(enc: AltoEncoding) -> np.ndarray:
    """The encoding's BitRun table for the C entries, checked against the
    kernels' limits."""
    if not 2 <= enc.ndim <= MAX_MODES or len(enc.runs) > MAX_RUNS:
        raise ValueError(f"encoding of {enc.dims} exceeds the kernel's "
                         f"{MAX_MODES} modes / {MAX_RUNS} runs")
    return _runs_table(enc)


def decode_table_np(enc: AltoEncoding) -> np.ndarray:
    """Byte decode tables of an encoding, ``(ndim, n_words, 4, 256)``
    uint32: entry ``[m, k, j, v]`` holds the bits of mode m's coordinate
    that byte j of word k carries when it equals v, in place. A
    coordinate is the OR of its words' four lookups, since shifts and
    masks distribute over OR (``alto_coord_table`` in
    ``csrc/alto_decode.cuh``)."""
    table = np.zeros((enc.ndim, enc.n_words, 4, 256), dtype=np.uint64)
    v = np.arange(256, dtype=np.uint64)
    for r in enc.runs:
        mask = np.uint64((1 << r.length) - 1)
        for j in range(4):
            x = v << np.uint64(8 * j)
            table[r.mode, r.word, j] |= (((x >> np.uint64(r.dst_shift))
                                          & mask)
                                         << np.uint64(r.src_shift))
    return table.astype(np.uint32)


_DECODE_TABLES: dict[tuple, torch.Tensor] = {}


def decode_table(enc: AltoEncoding, device) -> torch.Tensor:
    """`decode_table_np` as an int32 tensor on ``device``, cached."""
    key = (enc, str(device))
    table = _DECODE_TABLES.get(key)
    if table is None:
        table = torch.from_numpy(decode_table_np(enc).view(np.int32)).to(
            device)
        _DECODE_TABLES[key] = table
    return table


_SMEM_LIMIT: dict[int, int] = {}


def smem_limit(device: torch.device) -> int:
    """The shared memory one CTA may opt in to on ``device`` (bytes), as
    the CUDA runtime reports it."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMEM_LIMIT:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _build.check(_build.library("cpapr_phi").alto_phi_smem_limit(
                ctypes.byref(out)), "alto_phi_smem_limit")
        _SMEM_LIMIT[idx] = out.value
    return _SMEM_LIMIT[idx]


_K7_MAX_THREADS: dict[tuple[int, int], int] = {}


def k7_max_threads(rank: int, device: torch.device) -> int:
    """The most threads a K7 CTA may have at ``rank`` on ``device``, as
    its kernel's registers allow (the CUDA runtime's
    ``maxThreadsPerBlock``)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if (idx, rank) not in _K7_MAX_THREADS:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _build.check(_build.library(
                "cpapr_phi").alto_phi_partials_max_threads(
                    rank, ctypes.byref(out)), "alto_phi_partials_max_threads")
        _K7_MAX_THREADS[idx, rank] = out.value
    return _K7_MAX_THREADS[idx, rank]


def alto_args(enc: AltoEncoding, mode: int, factors, rank: int):
    """The leading C arguments of every MTTKRP and Φ entry: factor
    addresses (null under ALTO-PRE, ``factors=None``), the BitRun table,
    and the encoding's sizes. The two numpy arrays are returned first so
    the caller keeps them alive across the call."""
    ptrs = np.array([0] * enc.ndim if factors is None
                    else [f.data_ptr() for f in factors], dtype=np.int64)
    table = runs_table(enc)
    keep = (ptrs, table)
    args = [ptrs.ctypes.data_as(ctypes.c_void_p),
            table.ctypes.data_as(ctypes.c_void_p), len(table), enc.ndim,
            enc.n_words, mode, rank]
    return keep, args


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def cta_threads(threads: int) -> int:
    """``threads`` rounded up to whole warps, at least one, at most 1024."""
    return min(1024, max(32, -(-threads // 32) * 32))


MAX_RANK_TILE = 128   # 32 · FIX_MAX_COLS in csrc/carry_fixup.cuh; the
                      # widest lane map of K1


def rank_tile(rank: int) -> int:
    """Largest divisor of ``rank`` up to `MAX_RANK_TILE`: a launch's rank
    tile where the caller gives none."""
    return max(d for d in range(1, min(rank, MAX_RANK_TILE) + 1)
               if rank % d == 0)


# ---------------------------------------------------------------------------
# The recursive kernels' shared memory (K3 and K7)
# ---------------------------------------------------------------------------

TILE_BYTES = 16 * 1024        # the staging tile of terms, about


def tile_nnz(cols: int) -> int:
    """Nonzeros per staging tile of K3 and K7 for ``cols`` columns (K7:
    the rank; K3: the rank tile): 128 up to 32 columns, fewer above so the
    tile stays about `TILE_BYTES`, and at least 8."""
    return max(8, min(128, TILE_BYTES // (4 * cols) // 8 * 8))


def smem_bytes(window: int, cols: int, tile: int, b_rows: bool) -> int:
    """Shared memory of one K3 or K7 CTA: the Temp window (``window ×
    cols`` floats) and, with ``b_rows`` (K7), the window's B rows as
    many; the staging tile's terms (``tile × cols`` floats) and its rows
    (``tile`` ints). ``partials_smem_bytes`` in csrc/alto_scan.cuh is the
    same rule."""
    return (((2 if b_rows else 1) * window + tile) * cols + tile) * 4


def window_rows(temp_rows: int, cols: int, limit_bytes: int,
                b_rows: bool, tile: int | None = None) -> int:
    """Temp rows K3 (``b_rows`` False) or K7 (True) holds in shared memory
    at once beside a staging tile of ``tile`` nonzeros (default
    `tile_nnz`): all ``temp_rows`` where they fit under ``limit_bytes``
    (one CTA's shared memory), else the most that do. Raises when not even
    one row fits."""
    tile = tile_nnz(cols) if tile is None else tile
    per_row = smem_bytes(1, cols, tile, b_rows) - smem_bytes(0, cols, tile,
                                                              b_rows)
    h = (limit_bytes - smem_bytes(0, cols, tile, b_rows)) // per_row
    if h < 1:
        raise ValueError(f"{cols} columns: one Temp row and the staging "
                         f"tile need {smem_bytes(1, cols, tile, b_rows)} "
                         f"bytes of shared memory, the card has "
                         f"{limit_bytes}")
    return int(min(temp_rows, h))


# K7's CTA from its occupancy. A Temp window that fills a CTA's shared
# memory leaves one CTA an SM; a CTA of the plan's 128 threads then gives
# the SM 4 warps, too few gathers in flight to hide the factor rows' L2
# latency. `k7_launch` widens such a CTA until the SM holds `K7_SM_WARPS`
# warps, with a staging tile scaled to its warps (`k7_tile`).
K7_SM_WARPS = 16
K7_WIDE_THREADS = (256, 512)        # the widths k7_launch may give a CTA
CTA_SMEM_RESERVED = 1024            # shared memory the runtime keeps a
                                    # CTA; an SM holds one CTA at the
                                    # opt-in limit and this


def ctas_per_sm(smem: int, limit_bytes: int) -> int:
    """CTAs of ``smem`` bytes one SM's shared memory holds, on a card whose
    CTA may opt in to ``limit_bytes`` (the SM has that and one CTA's
    reserve). The SM's caps on threads (2,048) and CTAs (32) bind only
    where they leave 16 warps or more, so `k7_launch` needs neither."""
    return (limit_bytes + CTA_SMEM_RESERVED) // (smem + CTA_SMEM_RESERVED)


def k7_tile(cols: int, threads: int) -> int:
    """K7's staging tile in a CTA of ``threads``: `tile_nnz`, sized for
    the plan's 128 threads, times the CTA's multiple of 128 threads, so
    each sub-warp keeps its share of a tile in a wider CTA."""
    return tile_nnz(cols) * max(1, cta_threads(threads) // 128)


def k7_launch(temp_rows: int, rank: int, limit_bytes: int, threads: int,
              max_threads: int = 1024) -> tuple[int, int, int]:
    """K7's ``(threads, tile, window)`` for a Temp of ``temp_rows`` rows at
    ``rank`` under ``limit_bytes`` of shared memory a CTA, from the plan's
    ``threads``, in CTAs of at most ``max_threads`` (`k7_max_threads`).

    Where the plan's CTA with `tile_nnz` and `window_rows` leaves an SM
    `K7_SM_WARPS` warps or more, that launch, as it always was. Else the
    fewest of `K7_WIDE_THREADS` that reach them, with its `k7_tile` and
    the window that leaves; where none reaches them, the shape with the
    most warps an SM (the plan's on a tie). The bits do not depend on the
    shape (csrc/phi_scan.cuh)."""
    t0 = cta_threads(threads)
    best = (t0, tile_nnz(rank), window_rows(temp_rows, rank, limit_bytes,
                                            True))

    def warps(t, tile, window):
        return ctas_per_sm(smem_bytes(window, rank, tile, True),
                           limit_bytes) * t // 32

    most = warps(*best)
    for t in K7_WIDE_THREADS:
        if most >= K7_SM_WARPS:
            break
        if t <= t0 or t > max_threads:
            continue
        tile = k7_tile(rank, t)
        try:
            shape = (t, tile, window_rows(temp_rows, rank, limit_bytes,
                                          True, tile))
        except ValueError:
            break
        if warps(*shape) > most:
            best, most = shape, warps(*shape)
    return best
