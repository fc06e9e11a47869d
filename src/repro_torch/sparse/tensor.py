"""Sparse tensor substrate: COO container + dense conversions.

The COO form is the paper's baseline format (Fig. 3a) and the input to ALTO
format generation. Coordinates are kept as int32 (every assigned data set has
mode lengths < 2**31); values default to float32. A copy of the JAX
package's module, so the same seed gives the same tensor in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """A mode-N sparse tensor in list-of-nonzeros (COO) form.

    Attributes:
      dims:   static mode lengths (I_1, ..., I_N).
      coords: (M, N) int32 multi-dimensional indices.
      values: (M,) float values.
    """

    dims: tuple[int, ...]
    coords: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        coords = np.asarray(self.coords, dtype=np.int32)
        values = np.asarray(self.values)
        if coords.ndim != 2 or coords.shape[1] != len(self.dims):
            raise ValueError(
                f"coords shape {coords.shape} does not match dims {self.dims}")
        if values.shape != (coords.shape[0],):
            raise ValueError(
                f"values shape {values.shape} != ({coords.shape[0]},)")
        for n, I in enumerate(self.dims):
            if coords.shape[0] and (coords[:, n].min() < 0
                                    or coords[:, n].max() >= I):
                raise ValueError(f"mode-{n} coordinates out of range [0,{I})")
        object.__setattr__(self, "coords", coords)
        object.__setattr__(self, "values", values)

    @property
    def nnz(self) -> int:
        return self.coords.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def density(self) -> float:
        total = float(np.prod([float(d) for d in self.dims]))
        return self.nnz / total if total else 0.0

    def todense(self) -> np.ndarray:
        """Dense ndarray (small tensors / test oracles only)."""
        out = np.zeros(self.dims, dtype=self.values.dtype)
        # += via np.add.at to honour duplicate coordinates like scatter-add.
        np.add.at(out, tuple(self.coords[:, n] for n in range(self.ndim)),
                  self.values)
        return out

    def deduplicate(self) -> "SparseTensor":
        """Sum values of duplicate coordinates (canonicalisation)."""
        order = np.lexsort(tuple(self.coords[:, n]
                                 for n in range(self.ndim - 1, -1, -1)))
        c = self.coords[order]
        v = self.values[order]
        if c.shape[0] == 0:
            return self
        new_run = np.any(c[1:] != c[:-1], axis=1)
        starts = np.concatenate([[0], np.nonzero(new_run)[0] + 1])
        seg_id = np.cumsum(np.concatenate([[0], new_run.astype(np.int64)]))
        sums = np.zeros(len(starts), dtype=v.dtype)
        np.add.at(sums, seg_id, v)
        return SparseTensor(self.dims, c[starts], sums)

    def permute_modes(self, perm: Sequence[int]) -> "SparseTensor":
        perm = list(perm)
        return SparseTensor(tuple(self.dims[p] for p in perm),
                            self.coords[:, perm], self.values)


def from_dense(arr: np.ndarray) -> SparseTensor:
    coords = np.argwhere(arr != 0).astype(np.int32)
    values = arr[tuple(coords[:, n] for n in range(arr.ndim))]
    return SparseTensor(tuple(arr.shape), coords, values)
