"""Dense SwiGLU MLP."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import ParamDef, einsum, swiglu


def mlp_def(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    return {
        "w_gate": ParamDef((D, F), ("fsdp", "mlp")),
        "w_up": ParamDef((D, F), ("fsdp", "mlp")),
        "w_down": ParamDef((F, D), ("mlp", "fsdp")),
    }


def mlp(p, x):
    h = swiglu(einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype)),
               einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype)))
    h = shd.act(h, ("batch", None, "mlp"))
    return einsum("bsf,fd->bsd", h, p["w_down"].to(x.dtype))
