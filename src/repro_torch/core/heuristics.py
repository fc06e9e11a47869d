"""Input-aware adaptation heuristics (paper §4.2, §4.3, Table 1).

All decisions are made from static tensor statistics (`AltoMeta`) when a
plan is made. The paper's rules do not depend on the hardware, so this is
a copy of the JAX package's module; the kernels' resource model lives in
`core.plan`.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.alto import AltoMeta

# Paper §4.2: the two-stage buffered accumulation costs at worst 4 memory
# operations (2 reads + 2 writes); recursive traversal pays off only when the
# average reuse per output fiber exceeds that.
BUFFERED_ACCUM_COST = 4.0

# Paper §5.1.2 (Table 1) classification thresholds.
HIGH_REUSE = 8.0
MEDIUM_REUSE = 5.0

# Fast-memory budget used by the PRE/OTF decision (kept equal to the JAX
# package's value so both packages pick the same policy).
DEFAULT_FAST_MEM_BYTES = 128 * 1024 * 1024


class Traversal(enum.Enum):
    RECURSIVE = "recursive"          # ALTO order + Temp + pull reduction
    OUTPUT_ORIENTED = "oriented"     # output-mode order + segment reduction
    # output-mode order + per-block run sums stored straight to the
    # (I_n, R) output; only each block's first and last runs go through
    # a small carries buffer — no (n_blocks, block_m, R) partials.
    ORIENTED_CARRY = "oriented_carry"


# Both output-oriented variants consume the same row-sorted view and obey
# the same carry-merge correctness condition; routing code that only cares
# about "recursive vs oriented" should test membership here, not identity
# with OUTPUT_ORIENTED.
ORIENTED_FAMILY = (Traversal.OUTPUT_ORIENTED, Traversal.ORIENTED_CARRY)


def is_oriented(traversal: Traversal) -> bool:
    """True for either output-oriented variant (one-hot merge or carry)."""
    return traversal in ORIENTED_FAMILY


class PiPolicy(enum.Enum):
    PRE = "pre"    # precompute & stream the (M, R) Khatri-Rao rows
    OTF = "otf"    # recompute KRP rows on the fly


def classify_reuse(reuse: float) -> str:
    if reuse > HIGH_REUSE:
        return "high"
    if reuse >= MEDIUM_REUSE:
        return "medium"
    return "limited"


def tensor_reuse_class(meta: AltoMeta) -> str:
    """A tensor is limited/medium if ANY mode is (paper §5.1.2)."""
    classes = [classify_reuse(r) for r in meta.fiber_reuse]
    for level in ("limited", "medium"):
        if level in classes:
            return level
    return "high"


def choose_traversal(meta: AltoMeta, mode: int) -> Traversal:
    """Recursive traversal iff fiber reuse amortizes the buffered
    accumulation (> 4 memory ops), else output-oriented (paper §4.2)."""
    if meta.fiber_reuse[mode] > BUFFERED_ACCUM_COST:
        return Traversal.RECURSIVE
    return Traversal.OUTPUT_ORIENTED


def candidate_traversals(meta: AltoMeta, mode: int) -> tuple[Traversal, ...]:
    """All traversals, the static family choice first, then the other two
    in the JAX package's order. The measured tuner (`core.autotune`)
    re-ranks them; the static rule orders the candidates, so a capped
    search keeps the analytic choice."""
    first = choose_traversal(meta, mode)
    rest = tuple(t for t in (Traversal.OUTPUT_ORIENTED,
                             Traversal.ORIENTED_CARRY, Traversal.RECURSIVE)
                 if t is not first)
    return (first,) + rest


# ---------------------------------------------------------------------------
# Oriented-variant choice: one-hot merge vs scratch-carry, by HBM traffic
# ---------------------------------------------------------------------------

def stream_len(meta: AltoMeta) -> int:
    """Length of the (partition-padded) sorted nonzero stream the oriented
    kernels consume. The further padding to a ``block_m`` multiple is at
    most one block and is ignored by the traffic model."""
    L = meta.n_partitions
    return -(-max(meta.nnz, L) // L) * L


def oriented_merge_traffic_bytes(meta: AltoMeta, mode: int, rank: int,
                                 dtype_bytes: int = 4) -> int:
    """HBM bytes the one-hot oriented path moves BEYOND the stream read.

    The kernel materializes ``(n_blocks, block_m, R)`` per-block segment
    sums to HBM (one write), which `ops.segment_merge` immediately reads
    back together with the row stream and scatters into the ``(I_n, R)``
    output (one read + the output write). For typical tensors the
    partials round-trip dwarfs everything else — it is the term the
    scratch-carry traversal deletes.
    """
    M = stream_len(meta)
    partials_round_trip = 2 * M * rank * dtype_bytes   # write, then re-read
    merge_rows = M * 4                                 # merge re-reads rows
    out_write = meta.dims[mode] * rank * dtype_bytes
    return partials_round_trip + merge_rows + out_write


def carry_traffic_bytes(meta: AltoMeta, mode: int, rank: int,
                        dtype_bytes: int = 4) -> int:
    """HBM bytes the scratch-carry path moves BEYOND the stream read.

    The only materialized intermediate is the output itself (zeroed,
    then written): ``2·I_n·R``, independent of nnz. The per-block
    carries are ``O(n_blocks·R)`` and ignored.
    """
    return 2 * meta.dims[mode] * rank * dtype_bytes


def choose_oriented_variant(meta: AltoMeta, mode: int, rank: int,
                            dtype_bytes: int = 4,
                            carry_feasible: bool = True) -> Traversal:
    """Pick between the output-oriented variants by modelled HBM traffic.

    The carry traversal wins whenever its resident-output traffic is
    below the one-hot path's partials round-trip — i.e. unless the mode
    dimension dwarfs the nonzero stream — and only while the plan layer
    reports it feasible (``carry_feasible``).
    """
    if not carry_feasible:
        return Traversal.OUTPUT_ORIENTED
    if (carry_traffic_bytes(meta, mode, rank, dtype_bytes)
            < oriented_merge_traffic_bytes(meta, mode, rank, dtype_bytes)):
        return Traversal.ORIENTED_CARRY
    return Traversal.OUTPUT_ORIENTED


def choose_pi_policy(meta: AltoMeta, rank: int, value_bytes: int = 4,
                     fast_mem_bytes: int = DEFAULT_FAST_MEM_BYTES
                     ) -> PiPolicy:
    """ALTO-PRE iff reuse is low AND factors overflow fast memory (§4.3)."""
    factor_bytes = sum(I * rank * value_bytes for I in meta.dims)
    low_reuse = tensor_reuse_class(meta) == "limited"
    if low_reuse and factor_bytes > fast_mem_bytes:
        return PiPolicy.PRE
    return PiPolicy.OTF
