"""ALTO delinearization kernel (K4): (M, W) index words -> (M, N) int32
coordinates.

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
"""
from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.core.encoding import AltoEncoding
from repro_torch.kernels import _build, common

TILE = 1024                # nonzeros per CTA tile: four per thread
ROUTES = {"smem": 0, "l1": 1}     # ROUTE_* in delinearize.cu


def delinearize_plain(enc: AltoEncoding, words) -> torch.Tensor:
    """Plain version of K4."""
    _build.count_plain("delinearize", words)
    return encoding.delinearize(enc, words)


def smem_bytes(enc: AltoEncoding, tile: int, route: str) -> int:
    """Shared memory of one K4 CTA: the staging tile's ``tile × N`` ints,
    plus the byte tables' ``N × W × 4 × 256`` entries under ``"smem"``."""
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
