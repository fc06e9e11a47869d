"""Plain PyTorch oracles for the MTTKRP kernels (allclose targets in tests).

Written independently of the kernels' plain versions: a per-bit decode
with no run compression, and one scatter-add per partition.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoding import AltoEncoding, unsigned
from repro_torch.core.mttkrp import krp_rows


def ref_delinearize(enc: AltoEncoding, words: torch.Tensor) -> torch.Tensor:
    """Oracle for the decode: one bit at a time."""
    u = unsigned(words)
    cols = [torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
            for _ in range(enc.ndim)]
    for b in range(enc.total_bits):
        bit = (u[..., b // 32] >> (b % 32)) & 1
        cols[enc.bit_mode[b]] |= bit << enc.bit_pos[b]
    return torch.stack(cols, dim=-1).to(torch.int32)


def ref_mttkrp_partials(enc: AltoEncoding, mode: int, temp_rows: int,
                        words, values, part_start, factors) -> torch.Tensor:
    """Oracle for the recursive kernel: per-partition Temp (L, T, R)."""
    L = part_start.shape[0]
    chunk = words.shape[0] // L
    coords = ref_delinearize(enc, words)
    contrib = values[:, None] * krp_rows(coords, factors, mode)
    R = contrib.shape[-1]
    out = contrib.new_zeros((L, temp_rows, R))
    for l in range(L):
        local = coords[l * chunk:(l + 1) * chunk, mode].long() \
            - int(part_start[l, mode])
        out[l].index_add_(0, local, contrib[l * chunk:(l + 1) * chunk])
    return out


def ref_pull_reduction(partials: torch.Tensor, part_start_mode: torch.Tensor,
                       out_dim: int) -> torch.Tensor:
    """Oracle for the pull reduction (Alg. 4 lines 14-18)."""
    L, T, R = partials.shape
    out = partials.new_zeros((out_dim, R))
    for l in range(L):
        rows = (int(part_start_mode[l]) + torch.arange(T)).clamp_max(
            out_dim - 1)
        out.index_add_(0, rows.to(partials.device), partials[l])
    return out
