"""Baseline sparse tensor formats the paper compares against (§2.3):

  * HiCOO  — block-based hierarchical COO (Li et al. [18]): nonzeros
    sorted by multi-dimensional block key; per-block coordinates split
    into (block index, element offset) with small offset types.
  * CSF    — compressed sparse fiber (SPLATT [20]): a fiber tree per mode
    order; MTTKRP is the classic bottom-up traversal, expressed here as a
    chain of sorted segment sums.

Both exist to make Fig. 9 (MTTKRP across formats) and Fig. 12 (storage)
head-to-heads inside one runtime. The builds are host numpy, the same
code as the JAX package's, so every structure array is its array bit for
bit; the arrays the MTTKRP reads are also held as tensors on ``device``
(default ``cuda``). The MTTKRPs are plain PyTorch — gathers, Hadamard
products and ``index_add_`` — as the JAX package's are plain ``jnp``:
they are the paper's comparison points, not SPLATT's or HiCOO's own
codes. On the card ``index_add_`` adds with float atomics in no fixed
order, so their outputs vary in the last bits from run to run
(``torch.use_deterministic_algorithms`` makes them repeatable).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.tensor import SparseTensor


def _segment_sum(data: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Rows of ``data`` summed by ``segments`` (sorted) into ``n`` rows."""
    return data.new_zeros((n, data.shape[1])).index_add_(0, segments, data)


# ---------------------------------------------------------------------------
# HiCOO
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HiCooTensor:
    dims: tuple[int, ...]
    block_bits: int
    bptr: np.ndarray             # (n_blocks + 1,) int64 — nnz range per block
    bcoords: np.ndarray          # (n_blocks, N) int32 — block indices
    ecoords: np.ndarray          # (M, N) uint8 — element offsets in block
    values: torch.Tensor         # (M,)
    blk_of_nnz: torch.Tensor     # (M,) int32 — owning block per nonzero
    bcoords_dev: torch.Tensor    # ``bcoords`` on the values' device
    ecoords_dev: torch.Tensor    # ``ecoords`` on the values' device

    @property
    def nnz(self) -> int:
        return self.ecoords.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.bcoords.shape[0]

    def storage_bytes(self) -> int:
        """Paper Fig. 12 accounting: bptr 8B/block, bi 4B/mode/block,
        ei 1B/mode/nnz, values 4B."""
        N = len(self.dims)
        return (8 * (self.n_blocks + 1) + 4 * N * self.n_blocks
                + 1 * N * self.nnz + 4 * self.nnz)


def build_hicoo(x: SparseTensor, block_bits: int = 7,
                device=None) -> HiCooTensor:
    """Sort by block key, split coords into (block, offset) (Fig. 3b)."""
    dev = resolve_device(device)
    b = (x.coords >> block_bits).astype(np.int64)
    e = (x.coords & ((1 << block_bits) - 1)).astype(np.uint8)
    order = np.lexsort(tuple(b[:, n] for n in range(x.ndim - 1, -1, -1)))
    b, e, v = b[order], e[order], np.asarray(x.values)[order]
    new_blk = np.any(b[1:] != b[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(new_blk)[0] + 1])
    bptr = np.concatenate([starts, [x.nnz]]).astype(np.int64)
    blk_id = np.cumsum(np.concatenate([[0], new_blk.astype(np.int64)]))
    bcoords = b[starts].astype(np.int32)
    return HiCooTensor(
        dims=x.dims, block_bits=block_bits, bptr=bptr, bcoords=bcoords,
        ecoords=e, values=torch.from_numpy(v).to(dev),
        blk_of_nnz=torch.from_numpy(blk_id.astype(np.int32)).to(dev),
        bcoords_dev=torch.from_numpy(bcoords).to(dev),
        ecoords_dev=torch.from_numpy(e).to(dev))


def hicoo_coords(h: HiCooTensor) -> torch.Tensor:
    """Reconstruct full coordinates (block << bits | offset), int32."""
    b = h.bcoords_dev.index_select(0, h.blk_of_nnz)
    return (b << h.block_bits) | h.ecoords_dev.to(torch.int32)


def mttkrp_hicoo(h: HiCooTensor, factors: Sequence[torch.Tensor],
                 mode: int) -> torch.Tensor:
    """HiCOO MTTKRP: delinearize block + offset, scatter-add (on the card
    a scatter like COO's, which is the paper's point about block
    formats)."""
    coords = hicoo_coords(h)
    out = None
    for m, A in enumerate(factors):
        if m == mode:
            continue
        rows = A.index_select(0, coords[:, m])
        out = rows if out is None else out * rows
    contrib = h.values[:, None] * out
    return _segment_sum(contrib, coords[:, mode], factors[mode].shape[0])


# ---------------------------------------------------------------------------
# CSF
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CsfTensor:
    """One fiber tree for a given mode order (root first)."""
    dims: tuple[int, ...]
    mode_order: tuple[int, ...]        # e.g. (1, 0, 2): root mode first
    fids: list[np.ndarray]             # per level: node ids (mode index)
    parent: list[np.ndarray]           # per level>0: parent node position
    values: torch.Tensor               # (M,) leaf values (sorted)
    fids_dev: list[torch.Tensor]       # ``fids`` on the values' device
    parent_dev: list[torch.Tensor]     # ``parent`` on the values' device

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def storage_bytes(self) -> int:
        """fids 4B/node + parent ptr 4B/node + values 4B/nnz (a SPLATT
        fptr-style layout lower bound)."""
        total = 4 * self.nnz
        for lvl in range(len(self.fids)):
            total += 4 * len(self.fids[lvl])
            if lvl > 0:
                total += 4 * len(self.parent[lvl])
        return total


def build_csf(x: SparseTensor, root: int = 0, device=None) -> CsfTensor:
    dev = resolve_device(device)
    order = (root,) + tuple(m for m in range(x.ndim) if m != root)
    c = x.coords[:, order]
    perm = np.lexsort(tuple(c[:, n] for n in range(x.ndim - 1, -1, -1)))
    c = c[perm]
    v = np.asarray(x.values)[perm]
    N = x.ndim
    fids, parent = [], []
    prev_node_of_row = None                 # node position per nnz row
    for lvl in range(N):
        prefix = c[:, :lvl + 1]
        new = np.ones(len(c), bool)
        new[1:] = np.any(prefix[1:] != prefix[:-1], axis=1)
        node_of_row = np.cumsum(new) - 1
        starts = np.nonzero(new)[0]
        fids.append(c[starts, lvl].astype(np.int32))
        if lvl == 0:
            parent.append(np.zeros(0, np.int32))
        else:
            parent.append(prev_node_of_row[starts].astype(np.int32))
        prev_node_of_row = node_of_row
    return CsfTensor(dims=x.dims, mode_order=order, fids=fids, parent=parent,
                     values=torch.from_numpy(v).to(dev),
                     fids_dev=[torch.from_numpy(f).to(dev) for f in fids],
                     parent_dev=[torch.from_numpy(p).to(dev)
                                 for p in parent])


def mttkrp_csf_root(t: CsfTensor, factors: Sequence[torch.Tensor]
                    ) -> torch.Tensor:
    """Root-mode MTTKRP: bottom-up traversal (paper §2.3.3) as a chain of
    sorted segment sums. Conflict-free per subtree — the reason CSF needs
    one tree copy per mode."""
    N = len(t.dims)
    R = factors[0].shape[1]
    # leaves: val * A^(leaf mode) rows
    leaf_mode = t.mode_order[-1]
    cur = t.values[:, None] * factors[leaf_mode].index_select(
        0, t.fids_dev[-1])
    # fold up: at each internal level, segment-sum children then multiply
    # by that level's factor rows
    for lvl in range(N - 2, 0, -1):
        cur = _segment_sum(cur, t.parent_dev[lvl + 1], len(t.fids[lvl]))
        m = t.mode_order[lvl]
        cur = cur * factors[m].index_select(0, t.fids_dev[lvl])
    cur = _segment_sum(cur, t.parent_dev[1], len(t.fids[0]))
    root = t.mode_order[0]
    out = cur.new_zeros((t.dims[root], R))
    return out.index_copy_(0, t.fids_dev[0].long(), cur)


class CsfAll:
    """The paper's 'SPLATT-ALL' configuration: N tree copies, best speed,
    N× the storage (Fig. 12's mode-specific cost)."""

    def __init__(self, x: SparseTensor, device=None):
        self.trees = [build_csf(x, root=m, device=device)
                      for m in range(x.ndim)]

    def mttkrp(self, factors, mode: int) -> torch.Tensor:
        return mttkrp_csf_root(self.trees[mode], factors)

    def storage_bytes(self) -> int:
        return sum(t.storage_bytes() for t in self.trees)
