"""Architecture registry + reduced smoke-test configs (a copy of the JAX
package's `configs/`, equal field by field)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ModelConfig,
                                      ShapeConfig, shapes_for)

_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "glm4-9b": "glm4_9b",
    "smollm-360m": "smollm_360m",
    "minitron-8b": "minitron_8b",
    "whisper-base": "whisper_base",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


def reduced_config(name: str, n_repeats: int = 2) -> ModelConfig:
    """Tiny same-family config for CPU tests (small width/depth/vocab,
    few experts)."""
    cfg = get_config(name)
    plen = len(cfg.block_pattern)
    over = dict(
        n_layers=plen * n_repeats,
        d_model=64,
        n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=0,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=128,
        encoder_seq=24 if cfg.is_encdec else cfg.encoder_seq,
        ssm_head_dim=16 if cfg.ssm_state or "mamba" in cfg.block_pattern
        else cfg.ssm_head_dim,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_chunk=8,
        attn_chunk=16,
        vision_prefix=8 if cfg.family == "vlm" else cfg.vision_prefix,
        mrope_sections=(2, 3, 3) if cfg.mrope else cfg.mrope_sections,
        grad_accum=1,
        remat=False,
        dtype="float32",
    )
    if cfg.n_experts:
        over.update(n_experts=8, experts_per_token=2, d_expert=32)
    return dataclasses.replace(cfg, **over)


__all__ = ["ARCHS", "get_config", "get_shape", "reduced_config",
           "ModelConfig", "ShapeConfig", "shapes_for", "ALL_SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"]
