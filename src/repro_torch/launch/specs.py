"""Input stand-ins for every model input and their shardings.

Each stand-in is a ``meta`` tensor: shape and dtype, never allocated (the
JAX package's ``ShapeDtypeStruct``); the dry run shards them. Modality
frontends are stubs: audio supplies precomputed frame embeddings, vlm
patch embeddings + 3-D M-RoPE positions.

The port's decode cache is a list with one entry per layer
(`models.model.init_cache`), where the JAX package stacks each pattern
position's layers ``(n_repeats, B, ...)``. `cache_shardings` applies the
JAX rules to each layer's shapes, the leading repeat axis gone: batch is
axis 0, the KV cache's length axis 1 and its heads axis 2.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.models.common import def_paths_get, shardings

I32 = torch.int32
BF16 = torch.bfloat16
F32 = torch.float32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    specs = {"tokens": _sds((B, S), I32), "labels": _sds((B, S), I32)}
    if cfg.family == "audio":
        specs["frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), BF16)
    if cfg.family == "vlm":
        vis = cfg.vision_prefix
        specs["tokens"] = _sds((B, S - vis), I32)
        specs["patch_embeds"] = _sds((B, vis, cfg.d_model), BF16)
        specs["positions3"] = _sds((3, B, S), I32)
    return specs


def batch_shardings(cfg: ModelConfig, mesh, specs: dict) -> dict:
    """Batch dim over (pod, data); everything else replicated."""
    out = {}
    for k, s in specs.items():
        if k == "positions3":
            log = (None, "batch") + (None,) * (len(s.shape) - 2)
        else:
            log = ("batch",) + (None,) * (len(s.shape) - 1)
        out[k] = shd.sharding_for(mesh, log, tuple(s.shape))
    return out


def opt_state_shardings(optimizer, cfg: ModelConfig, mesh) -> list[dict]:
    """Per parameter group of a `optim.optimizers` optimizer, ``{state
    key: Sharding}``: `shardings` of its `state_defs` over `model_def`,
    at the group's JAX leaf."""
    sdefs = type(optimizer).state_defs(model_lib.model_def(cfg))
    trees = {k: shardings(v, mesh) for k, v in sdefs.items()
             if k != "count"}
    return [{k: def_paths_get(trees[k], g["leaf"]) for k in trees if k in g}
            for g in optimizer.param_groups]


def decode_cache_logical(cfg: ModelConfig, mesh, B: int):
    """Pick cache sharding: batch over (pod,data) when divisible; KV heads
    over model when divisible, else the cache sequence axis (SP)."""
    ms = shd.mesh_shape(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in ms:
            dp *= ms[a]
    batch_ok = B % dp == 0
    kv_ok = cfg.n_kv_heads % ms.get("model", 1) == 0
    return batch_ok, kv_ok


def _map_cache(fn, tree, path=()):
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_cache(fn, v, path + (k,)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_cache(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    return [_map_cache(fn, v, path + (i,)) for i, v in enumerate(tree)]


def cache_shardings(cfg: ModelConfig, mesh, cache_tree, B: int):
    """Shardings for the per-layer decode-cache tree (same layout).

    KV caches (path contains 'kv'): shard KV heads over model when
    divisible, else sequence-parallel (SP) over the cache length; batch
    over (pod,data) when divisible, else cache length over data too
    (the B=1 long_500k cells). Recurrent states: heads over model.
    """
    batch_ok, kv_ok = decode_cache_logical(cfg, mesh, B)
    ms = shd.mesh_shape(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in ms)
    model_n = ms.get("model", 1)

    def one(path, leaf):
        is_kv = any("kv" in str(n) for n in path)
        shape = tuple(leaf.shape)               # (B, ...)
        spec: list = [None] * len(shape)
        if batch_ok and len(shape) >= 1 and shape[0] == B:
            spec[0] = dp_axes[0] if len(dp_axes) == 1 else dp_axes
        if is_kv and len(shape) == 4:           # (B, S, KV, hd)
            if kv_ok:
                spec[2] = "model"
                if not batch_ok and "data" in ms \
                        and shape[1] % ms["data"] == 0:
                    spec[1] = "data"            # B=1: SP over data too
            elif shape[1] % model_n == 0:
                spec[1] = "model"               # SP over cache length
        elif not is_kv and len(shape) >= 2:     # recurrent state (B,H,..)
            if shape[1] % model_n == 0 and shape[1] >= model_n:
                spec[1] = "model"
        return shd.Sharding(mesh, tuple(spec))

    return _map_cache(one, cache_tree)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Serve-step inputs: one new token + a seq_len KV cache."""
    B, S = shape.global_batch, shape.seq_len
    tokens = _sds((B, 1), I32)
    cache = model_lib.init_cache(cfg, B, S, BF16, device="meta")
    extras = {}
    if cfg.family == "vlm":
        extras["positions3"] = _sds((3, B, 1), I32)
    return tokens, cache, extras
