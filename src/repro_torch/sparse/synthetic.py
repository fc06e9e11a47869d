"""Synthetic sparse tensor generators.

Real FROSTT tensors (Table 1 of the paper) are multi-GB downloads; for an
offline container we generate tensors with the *distributional properties*
the paper's evaluation stresses:

  * ``uniform``  — i.i.d. coordinates: hyper-sparse, limited fiber reuse
                   (DARPA/FB-M-like behaviour).
  * ``zipf``     — power-law skewed coordinates: few hot fibers carry most
                   nonzeros, high fiber reuse (UBER/CHICAGO/ENRON-like).
  * ``blocked``  — nonzeros clustered into random dense-ish blocks
                   (the regime where HiCOO-style tiling wins).
  * ``lowrank_count`` — Poisson counts drawn from a planted rank-R CP model
                   (ground truth for CP-APR recovery tests).
  * ``lowrank_gaussian`` — planted rank-R CP model + noise (CP-ALS tests).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.sparse.tensor import SparseTensor, from_dense


def _dedup(dims, coords, values) -> SparseTensor:
    return SparseTensor(tuple(dims), coords, values).deduplicate()


def uniform_tensor(dims: Sequence[int], nnz: int, seed: int = 0,
                   count_data: bool = False) -> SparseTensor:
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.integers(0, I, size=nnz) for I in dims],
                      axis=1).astype(np.int32)
    if count_data:
        values = rng.integers(1, 10, size=nnz).astype(np.float32)
    else:
        values = rng.standard_normal(nnz).astype(np.float32)
    return _dedup(dims, coords, values)


def zipf_tensor(dims: Sequence[int], nnz: int, a: float = 1.4,
                seed: int = 0, count_data: bool = False) -> SparseTensor:
    """Skewed coordinates: mode-n index ~ truncated Zipf(a)."""
    rng = np.random.default_rng(seed)
    cols = []
    for I in dims:
        # Inverse-CDF sampling of a truncated zipf to stay in [0, I).
        ranks = rng.zipf(a, size=nnz)
        cols.append(((ranks - 1) % I).astype(np.int32))
        # Random per-mode permutation so hot indices differ between modes.
        perm = rng.permutation(I).astype(np.int32)
        cols[-1] = perm[cols[-1]]
    coords = np.stack(cols, axis=1)
    if count_data:
        values = rng.integers(1, 20, size=nnz).astype(np.float32)
    else:
        values = rng.standard_normal(nnz).astype(np.float32)
    return _dedup(dims, coords, values)


def blocked_tensor(dims: Sequence[int], nnz: int, block: int = 8,
                   n_blocks: int = 64, seed: int = 0,
                   count_data: bool = False) -> SparseTensor:
    """Nonzeros clustered in `n_blocks` random multi-dimensional blocks.
    Dense-ish blocks -> high fiber reuse along every mode (the regime
    where the paper's recursive traversal wins)."""
    rng = np.random.default_rng(seed)
    base = np.stack(
        [rng.integers(0, max(1, I - block), size=n_blocks) for I in dims],
        axis=1)
    which = rng.integers(0, n_blocks, size=nnz)
    offs = np.stack([rng.integers(0, min(block, I), size=nnz) for I in dims],
                    axis=1)
    coords = (base[which] + offs).astype(np.int32)
    if count_data:
        values = rng.integers(1, 15, size=nnz).astype(np.float32)
    else:
        values = rng.standard_normal(nnz).astype(np.float32)
    return _dedup(dims, coords, values)


def lowrank_factors(dims: Sequence[int], rank: int, seed: int = 0,
                    nonneg: bool = False) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    fs = []
    for I in dims:
        A = rng.standard_normal((I, rank)).astype(np.float32)
        if nonneg:
            A = np.abs(A)
        fs.append(A)
    return fs


def lowrank_gaussian(dims: Sequence[int], rank: int, nnz: int,
                     noise: float = 0.01, seed: int = 0) -> tuple[
                         SparseTensor, list[np.ndarray]]:
    """Sample nnz coordinates; values from a planted rank-R model + noise."""
    rng = np.random.default_rng(seed)
    factors = lowrank_factors(dims, rank, seed=seed + 1)
    coords = np.stack([rng.integers(0, I, size=nnz) for I in dims],
                      axis=1).astype(np.int32)
    vals = np.ones(nnz, dtype=np.float32)
    prod = np.ones((nnz, rank), dtype=np.float32)
    for n, A in enumerate(factors):
        prod *= A[coords[:, n]]
    vals = prod.sum(axis=1) + noise * rng.standard_normal(nnz).astype(
        np.float32)
    return _dedup(dims, coords, vals), factors


def sparse_lowrank(dims: Sequence[int], rank: int, col_support: float = 0.2,
                   noise: float = 0.0, seed: int = 0,
                   nonneg: bool = False) -> tuple[SparseTensor,
                                                  list[np.ndarray]]:
    """An *exactly* low-rank sparse tensor: factors have sparse columns, so
    the full tensor (zeros included) is rank-R and sparse. Ground truth for
    CP-ALS recovery tests. Small dims only (builds a dense intermediate)."""
    rng = np.random.default_rng(seed)
    factors = []
    for I in dims:
        A = rng.standard_normal((I, rank)).astype(np.float32)
        if nonneg:
            A = np.abs(A)
        keep = rng.random((I, rank)) < col_support
        # ensure every column keeps at least one entry
        for r in range(rank):
            if not keep[:, r].any():
                keep[rng.integers(0, I), r] = True
        factors.append(A * keep)
    letters = "abcdefgh"[:len(dims)]
    expr = ",".join(f"{c}r" for c in letters) + "->" + letters
    dense = np.einsum(expr, *factors)
    if noise:
        mask = dense != 0
        dense = dense + noise * mask * rng.standard_normal(
            dense.shape).astype(np.float32)
    x = from_dense(dense.astype(np.float32))
    return x, factors


def lowrank_count(dims: Sequence[int], rank: int, nnz_target: int,
                  scale: float = 2.0, seed: int = 0) -> tuple[
                      SparseTensor, list[np.ndarray]]:
    """Poisson counts from a planted non-negative CP model (CP-APR oracle).

    Samples candidate coordinates and draws Poisson(rate); keeps positives.
    """
    rng = np.random.default_rng(seed)
    factors = lowrank_factors(dims, rank, seed=seed + 1, nonneg=True)
    n_cand = nnz_target * 3
    coords = np.stack([rng.integers(0, I, size=n_cand) for I in dims],
                      axis=1).astype(np.int32)
    prod = np.ones((n_cand, rank), dtype=np.float32)
    for n, A in enumerate(factors):
        prod *= A[coords[:, n]]
    rate = scale * prod.sum(axis=1)
    counts = rng.poisson(np.maximum(rate, 0.0)).astype(np.float32)
    keep = counts > 0
    return _dedup(dims, coords[keep], counts[keep]), factors


PAPER_LIKE = {
    # name: (builder, kwargs) — small-scale stand-ins for the Table 1
    # fiber-reuse regimes (class in comment = min-mode reuse class).
    "uber_like": (blocked_tensor, dict(                    # high reuse
        dims=(183, 24, 1024, 1536), nnz=260_000, block=12, n_blocks=8,
        count_data=True)),
    "chicago_like": (blocked_tensor, dict(                 # limited/medium
        dims=(1024, 24, 77, 32), nnz=120_000, block=16, n_blocks=10,
        count_data=True)),
    "darpa_like": (uniform_tensor, dict(                   # limited reuse
        dims=(2048, 2048, 65536), nnz=50_000, count_data=True)),
    "nell2_like": (blocked_tensor, dict(                   # high reuse
        dims=(2048, 1024, 4096), nnz=140_000, block=24, n_blocks=16)),
    "fbm_like": (uniform_tensor, dict(                     # limited reuse
        dims=(65536, 65536, 166), nnz=60_000)),
    "enron_like": (blocked_tensor, dict(                   # high reuse
        dims=(1024, 1024, 8192, 512), nnz=300_000, block=12, n_blocks=10,
        count_data=True)),
    "deli_like": (blocked_tensor, dict(                    # limited/medium
        dims=(4096, 2048, 1024, 64), nnz=100_000, block=16, n_blocks=40)),
}


def paper_like(name: str, seed: int = 0) -> SparseTensor:
    builder, kw = PAPER_LIKE[name]
    return builder(seed=seed, **kw)
