"""Rotary position embeddings: standard RoPE and multi-axis M-RoPE.

M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into sections
(temporal, height, width); each section rotates with its own position
stream. Text tokens carry identical t/h/w positions, so M-RoPE degenerates
to RoPE on text — the stub vision frontend supplies 3-D positions for the
patch-embedding prefix.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x, ang):
    """x: (B, S, H, hd); ang: (B, S, hd/2) float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)     # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """x: (B, S, H, hd); positions3: (3, B, S) int (t, h, w streams).

    sections sum to hd/2; frequency slot j uses the position stream of the
    section containing j (Qwen2-VL §2.1).
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device),
        output_size=hd // 2)                             # (hd/2,)
    pos_per_slot = positions3.float()[stream]             # (hd/2, B, S)
    return _rotate(x, pos_per_slot.permute(1, 2, 0) * freqs)
