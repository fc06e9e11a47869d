"""Shape-class bucketing: many tenant tensors onto a few plans.

A service decomposes many small and medium tensors at once (one per
customer, subnet or day), and each distinct `AltoMeta` is its own plan,
its own tuner entry and, in the batched drivers (`core.batched`), its own
bucket. A :class:`ShapeClass` removes the three sources of divergence:

* **dims** round up per mode to the next power of two. Embedding a tensor
  in larger extents is exact: coordinates are unchanged, and the extra
  factor rows receive no contributions, so they stay exactly zero through
  every CP-ALS and CP-APR update;
* **nnz** rounds up to the next power of two (at least the partition
  count), and the COO stream is padded to it with `kernels.ops.
  pad_sorted_stream`'s rule: copies of the last element with value 0,
  which add nothing to any reduction (the zero coordinate for an empty
  stream);
* **meta** is canonical: `canonical_meta` is the one `AltoMeta` every
  member shares, ``temp_rows`` the padded class dims (the only bound that
  holds for every member) and ``fiber_reuse`` 1.0, which routes every mode
  of the static class plan output-oriented. A tuned class plan may route
  a mode recursive where its Temp fits (`plan.recursive_fits`); the
  kernels of both traversals take a tenant axis (`core.batched`).

The canonical meta is a function of the class alone, so a plan made from
it (`plan.make_class_plan`) and its plan-store key (`autotune.
class_plan_key`) serve every tenant the class admits. The price is the
padding: a tenant just past a power of two computes on up to twice its
nonzeros. A copy of the JAX package's module over the port's types.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.alto import AltoMeta, AltoTensor
from repro_torch.core.encoding import make_encoding
from repro_torch.sparse.tensor import SparseTensor

DEFAULT_PARTITIONS = 8


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """Hashable bucket descriptor. ``dims`` and ``nnz`` are the PADDED
    class values (per-mode powers of two; a power-of-two stream length, a
    multiple of ``n_partitions``), never a member's own."""
    dims: tuple[int, ...]
    nnz: int
    n_partitions: int
    rank: int
    dtype: str = "float32"

    @property
    def order(self) -> int:
        return len(self.dims)

    def admits(self, x: SparseTensor) -> bool:
        """True iff ``x`` fits this class (dims and nnz bounded)."""
        return (len(x.dims) == self.order and x.nnz <= self.nnz
                and all(d <= cd for d, cd in zip(x.dims, self.dims)))


def classify(x: SparseTensor, rank: int,
             n_partitions: int = DEFAULT_PARTITIONS) -> ShapeClass:
    """The shape class a tenant tensor buckets into: per-mode power-of-two
    dims, a power-of-two nnz of at least the partition count (so the
    padded stream is a whole number of balanced partitions)."""
    L = max(1, int(n_partitions))
    nnz_c = max(_next_pow2(x.nnz), _next_pow2(L))
    return ShapeClass(dims=tuple(_next_pow2(d) for d in x.dims),
                      nnz=nnz_c, n_partitions=L, rank=int(rank),
                      dtype=str(np.dtype(x.values.dtype)))


def pad_to_class(x: SparseTensor, sc: ShapeClass) -> SparseTensor:
    """``x`` embedded in its class: class dims, the stream padded to the
    class nnz with value-0 copies of the last element (the zero
    coordinate when ``x`` is empty)."""
    if not sc.admits(x):
        raise ValueError(f"tensor dims={x.dims} nnz={x.nnz} does not fit "
                         f"shape class {sc}")
    coords = np.asarray(x.coords, np.int32)
    values = np.asarray(x.values)
    pad = sc.nnz - x.nnz
    if pad:
        if x.nnz == 0:
            pad_coords = np.zeros((pad, sc.order), np.int32)
        else:
            pad_coords = np.repeat(coords[-1:], pad, axis=0)
        coords = np.concatenate([coords, pad_coords], axis=0)
        values = np.concatenate(
            [values, np.zeros((pad,), values.dtype)], axis=0)
    return SparseTensor(sc.dims, coords, values)


def canonical_meta(sc: ShapeClass) -> AltoMeta:
    """The one `AltoMeta` every member of the class shares: no field
    depends on a member's data (``temp_rows`` the class dims,
    ``fiber_reuse`` 1.0 on every mode)."""
    return AltoMeta(enc=make_encoding(sc.dims), nnz=sc.nnz,
                    n_partitions=sc.n_partitions,
                    temp_rows=tuple(sc.dims),
                    fiber_reuse=(1.0,) * sc.order)


def canonicalize_tensor(at: AltoTensor, sc: ShapeClass) -> AltoTensor:
    """``at``, built from a `pad_to_class` tensor, with the canonical
    meta in place of its data-dependent one; the tensors are shared."""
    expect = canonical_meta(sc)
    if (at.meta.enc != expect.enc or at.words.shape[0] != sc.nnz
            or at.meta.n_partitions != sc.n_partitions):
        raise ValueError(f"tensor (dims={at.meta.dims}, "
                         f"Mp={at.words.shape[0]}) was not built from a "
                         f"pad_to_class({sc}) input")
    return AltoTensor(meta=expect, words=at.words, values=at.values,
                      part_start=at.part_start, part_end=at.part_end)
