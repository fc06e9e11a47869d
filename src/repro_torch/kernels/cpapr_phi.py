"""Recursive-traversal CP-APR Φ kernel (K7): per-partition Temp buffers.

Wrapper around ``csrc/cpapr_phi.cu`` with its plain PyTorch version beside
it. Partition ``l`` adds each of its elements' Φ terms
(`core.mttkrp.phi_contributions`) at ``Temp_l[row - part_start[l, mode]]``
of the ``(L, temp_rows, R)`` output, in stream order from 0.0, where
``row`` is the decoded target coordinate, which also selects the B row.
No rank tiles: the denominator needs the whole rank. The pull into
``(I_n, R)`` is `ops.pull_reduction`.

On the card one CTA runs each partition with its Temp and the window's B
rows in shared memory, ``window`` rows at a time: a Temp taller than one
window is covered in several passes over the partition. The CTA's
threads, its staging tile and the window come from `common.k7_launch`:
the plan's ``threads`` (whole warps) and `common.window_rows` where they
leave an SM 16 warps or more, else a wider CTA, a larger tile and the
window that remains. Any shape gives the same bits
(`phi_partials_windowed`). ``temp_rows`` is the tallest partition's row
interval: a partition walks only the windows its own rows reach (found
first by a walk that only decodes) and stores zeros in the others. Each launch adds the
windows of its Temp (`window_passes`, the most walks a partition makes)
to the counter ``phi_partials_passes`` (`_build.COUNTERS`), and a launch
in a CTA wider than the plan's its threads to ``phi_partials_wide``.

The tenant axis, as K3's (`kernels.mttkrp`): a bucket's stacked words,
values, part_start, B ``(T, I_n, R)`` and Π ``(T, Mp, R)`` or factors
``(T, I_m, R)`` go in one launch whose grid holds the tenants, each
tenant with the bits of its solo launch; Temp is ``(T, L, temp_rows,
R)``. The plain version loops over the tenants.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding, extract_mode
from repro_torch.core.mttkrp import phi_contributions
from repro_torch.kernels import _build, common
from repro_torch.kernels.mttkrp import DEFAULT_THREADS
from repro_torch.kernels.mttkrp_oriented import tenant_loop


def window_passes(temp_rows: int, window: int) -> int:
    """Windows of ``window`` rows that cover a Temp of ``temp_rows``:
    ⌈temp_rows / window⌉, the most walks K7 makes over a partition."""
    return -(-temp_rows // window)


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
                 threads: int = DEFAULT_THREADS,
                 window: int | None = None) -> torch.Tensor:
    """K7: per-partition Φ Temp buffers (L, temp_rows, R), or a bucket's
    (T, L, temp_rows, R). Pass ``pi`` (Π rows in ALTO order, ALTO-PRE) or
    ``factors`` (ALTO-OTF); ``window`` as `phi_partials_windowed`."""
    return phi_partials_windowed(enc, mode, temp_rows, eps, words, values,
                                 part_start, B, factors, pi, r_block,
                                 threads, window=window)


def phi_partials_windowed(enc: AltoEncoding, mode: int, temp_rows: int,
                          eps: float, words, values, part_start, B,
                          factors=None, pi=None, r_block: int | None = None,
                          threads: int = DEFAULT_THREADS,
                          window: int | None = None) -> torch.Tensor:
    """K7 with its Temp window height given: ``window`` None takes `common.
    k7_launch` of the card's shared memory from the plan's ``threads`` (a
    CTA widened there counts in ``phi_partials_wide``); else CTAs of
    ``threads`` with staging tiles of `common.k7_tile` nonzeros and Temp
    windows of ``window`` rows. On the CPU the shape changes nothing."""
    lead = common.tenant_lead(values)
    L = part_start.shape[-2]
    Mp = values.shape[-1]
    if Mp % L:
        raise ValueError(f"stream length {Mp} not a multiple of the "
                         f"{L} partitions")
    common.check_tensor(words, "words", torch.int32,
                        lead + (Mp, enc.n_words))
    common.check_tensor(values, "values", torch.float32, lead + (Mp,))
    common.check_tensor(part_start, "part_start", torch.int32,
                        lead + (L, enc.ndim))
    factors, R = common.check_phi_operands(enc, mode, Mp, B, factors, pi,
                                           r_block, lead)
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1")
    tensors = [words, values, part_start, B] + (factors or [pi])
    if not common.on_cuda(*tensors):
        return tenant_loop(
            lambda w, v, p, b, f, pi_: phi_partials_plain(
                enc, mode, temp_rows, eps, w, v, p, b, f, pi_),
            lead, words, values, part_start, B, factors, pi)
    plan_threads = threads
    if window is None:
        threads, tile, window = common.k7_launch(
            temp_rows, R, common.smem_limit(words.device), threads,
            common.k7_max_threads(R, words.device))
    else:
        tile = common.k7_tile(R, threads)
    window = min(window, temp_rows)
    temp = torch.empty(lead + (L, temp_rows, R), dtype=torch.float32,
                       device=words.device)
    keep, args = common.alto_args(enc, mode, factors, R)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    lib = _build.library("cpapr_phi")
    status = lib.alto_phi_partials(
        *args, words.data_ptr(), values.data_ptr(), part_start.data_ptr(),
        B.data_ptr(), None if pi is None else pi.data_ptr(), eps,
        common.decode_table(enc, words.device).data_ptr(), L,
        Mp // L, temp_rows, enc.dims[mode], window, tile, threads,
        temp.data_ptr(), *tenants, common.stream_ptr(words))
    del keep, strides
    _build.check(status, "alto_phi_partials")
    _build.count_launch("phi_partials", values.numel())
    _build.count_launch("phi_partials_passes", window_passes(temp_rows,
                                                             window))
    if threads > common.cta_threads(plan_threads):
        _build.count_launch("phi_partials_wide", threads)
    return temp
