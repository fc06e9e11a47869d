"""Device resolution shared by the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
When CUDA is absent and no CPU device was asked for they raise: a run
that was meant for the card never falls back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a `torch.device`, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
