"""Recursive-traversal MTTKRP kernel (K3): per-partition Temp buffers.

Wrapper around ``csrc/mttkrp.cu`` with its plain PyTorch version beside
it. Partition ``l`` of the ALTO-ordered stream is its ``chunk`` elements;
each contributes ``values · krp`` at ``Temp_l[row - part_start[l, mode]]``
of the ``(L, temp_rows, R)`` output, summed in stream order from 0.0. The
pull reduction into ``(I_n, R)`` is `ops.pull_reduction`.

On the card one CTA of ``threads`` (whole warps) runs each partition and
rank tile with its Temp in shared memory, ``window`` rows at a time
(`common.window_rows` without B rows, from the card's shared memory per
CTA); its sub-warps use K1's lane map (`mttkrp_oriented.lane_map`). A Temp
taller than one window is covered in several passes over the partition,
any window height gives the same bits (`recursive_partials_windowed`),
and every Temp entry is written once, so Temp is not zeroed first.

The tenant axis. The wrappers also take a bucket of T tenants of one
shape class (`core.batched`): words ``(T, Mp, W)``, values ``(T, Mp)``,
part_start ``(T, L, N)``, factors ``(T, I_m, R)`` and Temp ``(T, L,
temp_rows, R)``, in one launch whose grid holds the tenants
(``blockIdx.z``). Inside a tenant every tile, lane, window and sum is the
solo launch's, so each tenant gets the bits of its solo launch; the plain
version loops over the tenants (`mttkrp_oriented.tenant_loop`).
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding, delinearize
from repro_torch.core.mttkrp import krp_rows
from repro_torch.kernels import _build, common
from repro_torch.kernels.mttkrp_oriented import lane_map, tenant_loop

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
                       threads: int = DEFAULT_THREADS,
                       out=None, window: int | None = None) -> torch.Tensor:
    """K3: per-partition Temp buffers (L, temp_rows, R), or a bucket's
    (T, L, temp_rows, R), into ``out`` when given (every entry is
    overwritten); ``window`` as `recursive_partials_windowed`."""
    return recursive_partials_windowed(enc, mode, temp_rows, words, values,
                                       part_start, factors, r_block,
                                       threads, out=out, window=window)


def recursive_partials_windowed(enc: AltoEncoding, mode: int,
                                temp_rows: int, words, values, part_start,
                                factors, r_block: int | None = None,
                                threads: int = DEFAULT_THREADS, out=None,
                                window: int | None = None) -> torch.Tensor:
    """K3 with its Temp window height given (``None``: `common.
    window_rows` of the card's shared memory). On the CPU the window
    changes nothing."""
    factors = list(factors)
    R = factors[0].shape[-1]
    rb = r_block or common.rank_tile(R)
    if R % rb:
        raise ValueError(f"rank {R} not a multiple of r_block {rb}")
    lanes, cols = lane_map(rb)
    lead = common.tenant_lead(values)
    L = part_start.shape[-2]
    Mp = values.shape[-1]
    if Mp % L:
        raise ValueError(f"stream length {Mp} not a multiple of the "
                         f"{L} partitions")
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    common.check_tensor(words, "words", torch.int32,
                        lead + (Mp, enc.n_words))
    common.check_tensor(values, "values", torch.float32, lead + (Mp,))
    common.check_tensor(part_start, "part_start", torch.int32,
                        lead + (L, enc.ndim))
    common.check_factors(enc, factors, R, lead)
    if out is not None:
        common.check_tensor(out, "out", torch.float32,
                            lead + (L, temp_rows, R))
    tensors = [words, values, part_start, *factors] + (
        [] if out is None else [out])
    if not common.on_cuda(*tensors):
        temp = tenant_loop(
            lambda w, v, p, f: recursive_partials_plain(
                enc, mode, temp_rows, w, v, p, f),
            lead, words, values, part_start, factors)
        return temp if out is None else out.copy_(temp)
    tile = common.tile_nnz(rb)
    if window is None:
        window = common.window_rows(temp_rows, rb,
                                    common.smem_limit(words.device), False)
    window = min(window, temp_rows)
    temp = out if out is not None else torch.empty(
        lead + (L, temp_rows, R), dtype=torch.float32, device=words.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("mttkrp")
    status = lib.alto_recursive_partials(
        *args, words.data_ptr(), values.data_ptr(), part_start.data_ptr(),
        common.decode_table(enc, words.device).data_ptr(), L, Mp // L,
        temp_rows, rb, lanes, cols, window, tile,
        common.cta_threads(threads), temp.data_ptr(), *tenants,
        common.stream_ptr(words))
    del keep, strides
    _build.check(status, "alto_recursive_partials")
    _build.count_launch("recursive_partials", values.numel())
    return temp
