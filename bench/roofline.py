"""The least time an MTTKRP or a CP-APR Φ evaluation could take on one
H100, reckoned from the tensor alone.

The count does not depend on the port's format, kernels or Π policy, so a
later change to any of them is read against the same work:

* bytes: each nonzero's value (4 B) and its coordinate at
  Σ_m ⌈log2 I_m⌉ bits, rounded up to whole bytes per nonzero; the rows of
  the other modes' factors that the nonzeros touch (distinct indices),
  R × 4 B each; the output, I_n × R × 4 B, written once. A Φ evaluation
  also reads the rows of B that the nonzeros touch, once.
* FLOPs: 2·R per nonzero, the accumulation every traversal must do (a
  recursive traversal shares the other products across a fiber, so only
  this part is counted).

The least time is the larger of bytes over the bandwidth and FLOPs over
the FP32 peak (NVIDIA H100 SXM datasheet, dense, at its 700 W limit).
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
VALUE_BYTES = 4


def coord_bits(dims) -> int:
    """Σ_m ⌈log2 I_m⌉: the bits that tell one coordinate from another."""
    return sum((int(d) - 1).bit_length() for d in dims)


def nonzero_bytes(dims) -> int:
    """A nonzero's value and its coordinate, rounded up to whole bytes."""
    return VALUE_BYTES + -(-coord_bits(dims) // 8)


@dataclasses.dataclass(frozen=True)
class Bound:
    bytes: int
    flops: int

    @property
    def seconds(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.flops / FP32_FLOPS_PER_S)

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / FP32_FLOPS_PER_S else "flops")


def mttkrp(dims, nnz: int, distinct, rank: int, mode: int) -> Bound:
    """One MTTKRP of ``mode``; ``distinct[m]`` is the number of distinct
    mode-m indices among the nonzeros."""
    rows = sum(int(distinct[m]) for m in range(len(dims)) if m != mode)
    b = (nnz * nonzero_bytes(dims) + rows * rank * VALUE_BYTES
         + int(dims[mode]) * rank * VALUE_BYTES)
    return Bound(bytes=b, flops=2 * rank * nnz)


def phi(dims, nnz: int, distinct, rank: int, mode: int) -> Bound:
    """One Φ evaluation of ``mode``: the MTTKRP's bytes and FLOPs and the
    touched rows of B."""
    m = mttkrp(dims, nnz, distinct, rank, mode)
    return Bound(bytes=m.bytes + int(distinct[mode]) * rank * VALUE_BYTES,
                 flops=m.flops)


def als_iteration_s(dims, nnz, distinct, rank) -> float:
    """The least time of one CP-ALS iteration's N MTTKRPs."""
    return sum(mttkrp(dims, nnz, distinct, rank, n).seconds
               for n in range(len(dims)))


def apr_outer_s(dims, nnz, distinct, rank, l_max: int) -> float:
    """The least time of one CP-APR outer iteration's N × ``l_max`` Φ
    evaluations."""
    return l_max * sum(phi(dims, nnz, distinct, rank, n).seconds
                       for n in range(len(dims)))
