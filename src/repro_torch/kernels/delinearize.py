"""ALTO delinearization kernel (K4): (M, W) index words -> (M, N) int32
coordinates; and the ALTO-PRE Π rows (`pi_rows`), decoded, gathered and
multiplied in one pass.

Wrapper around ``csrc/delinearize.cu`` with its plain PyTorch version
beside it (`core.encoding.delinearize`). A persistent grid walks the
stream in tiles of `TILE` nonzeros, several per thread, and stores each
tile's coordinates as 16-byte vectors; a ragged last tile is
bounds-checked, so the stream may have any length and nothing is padded.

Decode routes (`ROUTES`): ``"smem"`` — the byte decode tables
(`common.decode_table`) in shared memory; ``"l1"`` — the same tables read
through L1, where a CTA cannot hold them. `choose_route` picks ``"smem"``
where the tables and the staging tile fit one CTA's shared memory, else
``"l1"``; a caller may name a route, and a named route that cannot run
raises.

`pi_rows` (``csrc/delinearize.cu``, beside K4, sharing its word loads,
byte tables and routes): (M, W) words -> (M, R) float32 Khatri-Rao rows
of every factor but ``mode``'s, the ALTO-PRE Π, with no coordinates in
device memory. Its plain version is `core.mttkrp.krp_rows` on the plain
decode; the kernel multiplies in the same order with no FMA, so the two
agree bit for bit. Like every in-core kernel it takes a bucket's tenant
axis (`core.batched`): stacked ``(T, M, W)`` words and ``(T, I_m, R)``
factors give ``(T, M, R)`` in one launch, each tenant the bits of its
solo launch; its plain version then loops over the tenants
(`mttkrp_oriented.tenant_loop`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import AltoEncoding
from repro_torch.core.mttkrp import krp_rows
from repro_torch.kernels import _build, common
from repro_torch.kernels.mttkrp_oriented import tenant_loop

TILE = 1024                # nonzeros per CTA tile: four per thread
ROUTES = {"smem": 0, "l1": 1}     # ROUTE_* in delinearize.cu


def delinearize_plain(enc: AltoEncoding, words) -> torch.Tensor:
    """Plain version of K4."""
    _build.count_plain("delinearize", words)
    return encoding.delinearize(enc, words)


def smem_bytes(enc: AltoEncoding, tile: int, route: str) -> int:
    """Shared memory of one K4 CTA: the staging tile's ``tile × N`` ints,
    plus the byte tables' ``N × W × 4 × 256`` entries under ``"smem"``.
    A `pi_rows` CTA stages no tile: ``tile=0``."""
    tables = enc.ndim * enc.n_words * 4 * 256 * 4 if route == "smem" else 0
    return tables + tile * enc.ndim * 4


def choose_route(enc: AltoEncoding, tile: int, limit_bytes: int) -> str:
    """``"smem"`` where the tables and the staging tile fit ``limit_bytes``
    (one CTA's shared memory), else ``"l1"``."""
    return "smem" if smem_bytes(enc, tile, "smem") <= limit_bytes else "l1"


def delinearize(enc: AltoEncoding, words,
                route: str | None = None) -> torch.Tensor:
    """K4: (M, n_words) int32 words -> (M, N) int32 coordinates, any M.
    ``route``: one of `ROUTES`, or None for `choose_route`."""
    M = words.shape[0]
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} not one of {sorted(ROUTES)}")
    common.check_tensor(words, "words", torch.int32, (M, enc.n_words))
    if not common.on_cuda(words):
        return delinearize_plain(enc, words)
    if words.data_ptr() % (4 * enc.n_words):
        raise ValueError("words: rows not aligned to a row of "
                         f"{enc.n_words} words (the kernel loads a row as "
                         f"one vector)")
    limit = common.smem_limit(words.device)
    route = route or choose_route(enc, TILE, limit)
    if smem_bytes(enc, TILE, route) > limit:
        raise ValueError(f"route {route!r} needs "
                         f"{smem_bytes(enc, TILE, route)} bytes of shared "
                         f"memory, a CTA has {limit}")
    dtab = common.decode_table(enc, words.device)
    coords = torch.empty((M, enc.ndim), dtype=torch.int32,
                         device=words.device)
    lib = _build.library("delinearize")
    status = lib.alto_delinearize(
        enc.ndim, enc.n_words, words.data_ptr(), dtab.data_ptr(), M, TILE,
        ROUTES[route], coords.data_ptr(), common.stream_ptr(words))
    _build.check(status, "alto_delinearize")
    _build.count_launch("delinearize", M)
    return coords


def pi_rows_plain(enc: AltoEncoding, words, factors,
                  mode: int) -> torch.Tensor:
    """Plain version of `pi_rows`."""
    _build.count_plain("pi_rows", words)
    return krp_rows(encoding.delinearize(enc, words), factors,
                    mode).contiguous()


def pi_rows(enc: AltoEncoding, words, factors, mode: int) -> torch.Tensor:
    """ALTO-PRE Π: (M, n_words) int32 words -> (M, R) float32 rows
    ``prod_{m != mode} factors[m][i_m, :]`` in the words' order, any M.
    Factor m is a contiguous float32 ``(I_m, R)``. A bucket's stacked
    ``(T, M, n_words)`` words and ``(T, I_m, R)`` factors give ``(T, M,
    R)``, one launch for the bucket. The decode route is `choose_route`'s
    on the tables alone."""
    if not 0 <= mode < enc.ndim:
        raise ValueError(f"mode {mode} of a {enc.ndim}-mode tensor")
    if words.dim() not in (2, 3):
        raise ValueError(f"words of shape {tuple(words.shape)}: expected "
                         f"(M, W) or (T, M, W)")
    lead, M = tuple(words.shape[:-2]), words.shape[-2]
    common.check_tensor(words, "words", torch.int32,
                        lead + (M, enc.n_words))
    factors = list(factors)
    R = factors[0].shape[-1] if factors else 0
    common.check_factors(enc, factors, R, lead)
    if not common.on_cuda(words, *factors):
        return tenant_loop(pi_rows_plain, lead, enc, words, factors, mode)
    if words.data_ptr() % (4 * enc.n_words):
        raise ValueError("words: rows not aligned to a row of "
                         f"{enc.n_words} words (the kernel loads a row as "
                         f"one vector)")
    route = choose_route(enc, 0, common.smem_limit(words.device))
    dtab = common.decode_table(enc, words.device)
    ptrs = np.array([f.data_ptr() for f in factors], dtype=np.int64)
    strides, tenants = common.tenant_args(enc, mode, R, lead)
    pi = torch.empty(lead + (M, R), dtype=torch.float32, device=words.device)
    lib = _build.library("delinearize")
    status = lib.alto_pi_rows(
        enc.ndim, enc.n_words, words.data_ptr(), dtab.data_ptr(), M,
        ptrs.ctypes.data_as(ctypes.c_void_p), mode, R, ROUTES[route],
        pi.data_ptr(), *tenants, common.stream_ptr(words))
    del strides
    _build.check(status, "alto_pi_rows")
    _build.count_launch("pi_rows", words.numel() // enc.n_words)
    return pi
