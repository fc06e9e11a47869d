"""Recursive-traversal CP-APR Φ kernel (K7): per-partition Temp buffers.

Wrapper around ``csrc/cpapr_phi.cu`` with its plain PyTorch version beside
it. Partition ``l`` adds each of its elements' Φ terms
(`core.mttkrp.phi_contributions`) at ``Temp_l[row - part_start[l, mode]]``
of the ``(L, temp_rows, R)`` output, in stream order from 0.0, where
``row`` is the decoded target coordinate, which also selects the B row.
No rank tiles: the denominator needs the whole rank. The pull into
``(I_n, R)`` is `ops.pull_reduction`.

On the card one CTA of ``threads`` (whole warps) runs each partition with
its Temp and the window's B rows in shared memory, ``window`` rows at a
time (`common.window_rows` with B rows, from the card's shared memory per
CTA): a Temp taller than one window is covered in several passes over the
partition, and any window height gives the same bits
(`phi_partials_windowed`).
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding, extract_mode
from repro_torch.core.mttkrp import phi_contributions
from repro_torch.kernels import _build, common
from repro_torch.kernels.mttkrp import DEFAULT_THREADS


def phi_partials_plain(enc: AltoEncoding, mode: int, temp_rows: int,
                       eps: float, words, values, part_start, B,
                       factors=None, pi=None) -> torch.Tensor:
    """Plain version of K7: (L, temp_rows, R) Φ Temp buffers."""
    _build.count_plain("phi_partials", words)
    L = part_start.shape[0]
    chunk = words.shape[0] // L
    R = B.shape[1]
    rows = extract_mode(enc, words, mode)
    contrib = phi_contributions(enc, mode, words, values, rows, B,
                                factors=factors, pi=pi, eps=eps)
    local = (rows.long().reshape(L, chunk)
             - part_start[:, mode].long()[:, None])
    part = torch.arange(L, device=words.device)[:, None]
    temp = contrib.new_zeros((L * temp_rows, R))
    temp.index_add_(0, (part * temp_rows + local).reshape(-1), contrib)
    return temp.reshape(L, temp_rows, R)


def phi_partials(enc: AltoEncoding, mode: int, temp_rows: int, eps: float,
                 words, values, part_start, B, factors=None, pi=None,
                 r_block: int | None = None,
                 threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """K7: per-partition Φ Temp buffers (L, temp_rows, R). Pass ``pi``
    (Π rows in ALTO order, ALTO-PRE) or ``factors`` (ALTO-OTF)."""
    return phi_partials_windowed(enc, mode, temp_rows, eps, words, values,
                                 part_start, B, factors, pi, r_block,
                                 threads, window=None)


def phi_partials_windowed(enc: AltoEncoding, mode: int, temp_rows: int,
                          eps: float, words, values, part_start, B,
                          factors=None, pi=None, r_block: int | None = None,
                          threads: int = DEFAULT_THREADS,
                          window: int | None = None) -> torch.Tensor:
    """K7 with its Temp window height given (``None``: `common.
    window_rows` of the card's shared memory). On the CPU the window
    changes nothing."""
    L = part_start.shape[0]
    Mp = words.shape[0]
    if Mp % L:
        raise ValueError(f"stream length {Mp} not a multiple of the "
                         f"{L} partitions")
    common.check_tensor(words, "words", torch.int32, (Mp, enc.n_words))
    common.check_tensor(values, "values", torch.float32, (Mp,))
    common.check_tensor(part_start, "part_start", torch.int32,
                        (L, enc.ndim))
    factors, R = common.check_phi_operands(enc, mode, Mp, B, factors, pi,
                                           r_block)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    tensors = [words, values, part_start, B] + (factors or [pi])
    if not common.on_cuda(*tensors):
        return phi_partials_plain(enc, mode, temp_rows, eps, words, values,
                                  part_start, B, factors, pi)
    tile = common.tile_nnz(R)
    if window is None:
        window = common.window_rows(temp_rows, R,
                                    common.smem_limit(words.device), True)
    window = min(window, temp_rows)
    temp = torch.empty((L, temp_rows, R), dtype=torch.float32,
                       device=words.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    lib = _build.library("cpapr_phi")
    status = lib.alto_phi_partials(
        *args, words.data_ptr(), values.data_ptr(), part_start.data_ptr(),
        B.data_ptr(), None if pi is None else pi.data_ptr(), eps,
        common.decode_table(enc, words.device).data_ptr(), L,
        Mp // L, temp_rows, enc.dims[mode], window, tile, threads,
        temp.data_ptr(), common.stream_ptr(words))
    del keep
    _build.check(status, "alto_phi_partials")
    _build.count_launch("phi_partials", Mp)
    return temp
