"""ALTO delinearization kernel (K4): (M, W) index words -> (M, N) int32
coordinates.

Wrapper around ``csrc/delinearize.cu`` with its plain PyTorch version
beside it (`core.encoding.delinearize`). One thread per nonzero, one CTA
per ``block_m`` slice; the stream must be a multiple of ``block_m``
(`ops.delinearize` pads it and slices the tail off).
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import AltoEncoding
from repro_torch.kernels import _build, common

DEFAULT_BLOCK_M = 1024     # threads per CTA; at most 1024


def delinearize_plain(enc: AltoEncoding, words) -> torch.Tensor:
    """Plain version of K4."""
    _build.count_plain("delinearize", words)
    return encoding.delinearize(enc, words)


def delinearize(enc: AltoEncoding, words,
                block_m: int = DEFAULT_BLOCK_M) -> torch.Tensor:
    """K4: (M, n_words) int32 words -> (M, N) int32 coordinates."""
    M = words.shape[0]
    if not 1 <= block_m <= 1024:
        raise ValueError(f"block_m {block_m} outside [1, 1024]")
    if M % block_m:
        raise ValueError(f"stream length {M} not a multiple of block_m "
                         f"{block_m}")
    common.check_tensor(words, "words", torch.int32, (M, enc.n_words))
    if not common.on_cuda(words):
        return delinearize_plain(enc, words)
    table = common.runs_table(enc)
    coords = torch.empty((M, enc.ndim), dtype=torch.int32,
                         device=words.device)
    lib = _build.library("delinearize")
    status = lib.alto_delinearize(
        table.ctypes.data, len(table), enc.ndim, enc.n_words,
        words.data_ptr(), block_m, M // block_m, coords.data_ptr(),
        common.stream_ptr(words))
    _build.check(status, "alto_delinearize")
    _build.count_launch("delinearize")
    return coords
