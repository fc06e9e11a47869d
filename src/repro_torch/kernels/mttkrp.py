"""Recursive-traversal MTTKRP kernel (K3): per-partition Temp buffers.

Wrapper around ``csrc/mttkrp.cu`` with its plain PyTorch version beside
it. Partition ``l`` of the ALTO-ordered stream is its ``chunk`` elements;
each contributes ``values · krp`` at ``Temp_l[row - part_start[l, mode]]``
of the ``(L, temp_rows, R)`` output, summed in stream order from 0.0. The
pull reduction into ``(I_n, R)`` is `ops.pull_reduction`.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding, delinearize
from repro_torch.core.mttkrp import krp_rows
from repro_torch.kernels import _build, common

DEFAULT_THREADS = 128


def recursive_partials_plain(enc: AltoEncoding, mode: int, temp_rows: int,
                             words, values, part_start,
                             factors) -> torch.Tensor:
    """Plain version of K3: (L, temp_rows, R) Temp buffers."""
    _build.count_plain("recursive_partials", words)
    L = part_start.shape[0]
    chunk = words.shape[0] // L
    R = factors[0].shape[1]
    coords = delinearize(enc, words)
    contrib = values[:, None] * krp_rows(coords, factors, mode)
    local = (coords[:, mode].long().reshape(L, chunk)
             - part_start[:, mode].long()[:, None])
    part = torch.arange(L, device=words.device)[:, None]
    temp = contrib.new_zeros((L * temp_rows, R))
    temp.index_add_(0, (part * temp_rows + local).reshape(-1), contrib)
    return temp.reshape(L, temp_rows, R)


def recursive_partials(enc: AltoEncoding, mode: int, temp_rows: int, words,
                       values, part_start, factors,
                       r_block: int | None = None,
                       threads: int = DEFAULT_THREADS) -> torch.Tensor:
    """K3: per-partition Temp buffers (L, temp_rows, R)."""
    factors = list(factors)
    R = factors[0].shape[1]
    rb = r_block or R
    if R % rb:
        raise ValueError(f"rank {R} not a multiple of r_block {rb}")
    L = part_start.shape[0]
    Mp = words.shape[0]
    if Mp % L:
        raise ValueError(f"stream length {Mp} not a multiple of the "
                         f"{L} partitions")
    common.check_tensor(words, "words", torch.int32, (Mp, enc.n_words))
    common.check_tensor(values, "values", torch.float32, (Mp,))
    common.check_tensor(part_start, "part_start", torch.int32,
                        (L, enc.ndim))
    common.check_factors(enc, factors, R)
    if not common.on_cuda(words, values, part_start, *factors):
        return recursive_partials_plain(enc, mode, temp_rows, words, values,
                                        part_start, factors)
    temp = torch.zeros((L, temp_rows, R), dtype=torch.float32,
                       device=words.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    lib = _build.library("mttkrp")
    status = lib.alto_recursive_partials(
        *args, words.data_ptr(), values.data_ptr(), part_start.data_ptr(),
        L, Mp // L, temp_rows, rb, common.slices_per_cta(threads, rb),
        temp.data_ptr(), common.stream_ptr(words))
    del keep
    _build.check(status, "alto_recursive_partials")
    _build.count_launch("recursive_partials", Mp)
    return temp
