"""GQA attention: query-chunked full attention + single-token decode.

Training / prefill attend in query chunks of ``cfg.attn_chunk`` (a Python
loop where the JAX package scans), so the (chunk, S) logit tile, not the
full (S, S) matrix, is the peak live activation. Decode attends one query
over the KV cache with position masking.

The logits are float32 with a ``-1e30`` mask, as in the JAX package; this
is plain PyTorch, not `scaled_dot_product_attention`, which computes in
the inputs' dtype and would break the parity with the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import ParamDef, einsum
from repro_torch.models.rope import apply_mrope, apply_rope

NEG_INF = -1e30


def attn_def(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("fsdp", "heads", None)),
        "wk": ParamDef((D, KV, hd), ("fsdp", "kv_heads", None)),
        "wv": ParamDef((D, KV, hd), ("fsdp", "kv_heads", None)),
        "wo": ParamDef((H, hd, D), ("heads", None, "fsdp"), axis=-3),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((H, hd), ("heads", None), init="zeros")
        d["bk"] = ParamDef((KV, hd), ("kv_heads", None), init="zeros")
        d["bv"] = ParamDef((KV, hd), ("kv_heads", None), init="zeros")
    return d


def _project_qkv(cfg, p, x, kv_x=None):
    kv_x = x if kv_x is None else kv_x
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = einsum("bsd,dhk->bshk", kv_x, p["wk"].to(x.dtype))
    v = einsum("bsd,dhk->bshk", kv_x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _sdpa(q, k, v, q_pos, k_valid_upto, causal, scale):
    """q: (B, C, KV, G, hd); k/v: (B, S, KV, hd); q_pos: (C,) absolute.

    k_valid_upto: mask keys at positions > this (decode: cache fill level);
    pass None for full validity.
    """
    S = k.shape[1]
    logits = einsum("bckgh,bskh->bkgcs", q.float(), k.float()) * scale
    k_pos = torch.arange(S, device=k.device)
    mask = torch.ones((q.shape[1], S), dtype=torch.bool, device=k.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if k_valid_upto is not None:
        mask &= k_pos[None, :] <= k_valid_upto
    logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = einsum("bkgcs,bskh->bckgh", w, v.float())
    return out.to(v.dtype)


def _attend(cfg: ModelConfig, causal: bool, q, k, v, q_pos, head_kv):
    """Attention of q (B, Sq, H, hd) at absolute positions q_pos (Sq,)
    over k/v (B, S, KV, hd), in query chunks: (B, Sq, H, hd). Under a mesh
    it runs on each device's shards (a `local_map` region): its rows, and
    its query heads or its query positions; ``head_kv`` then names the kv
    head of each local query head when the kv heads are not sharded with
    them (None otherwise)."""
    B, Sq, H, hd = q.shape
    if head_kv is None:
        KV = k.shape[2]
    else:                       # the kv heads of the local query heads
        KV = max(1, H * cfg.n_kv_heads // cfg.n_heads)
        kv_idx = head_kv[::H // KV]
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    C = min(cfg.attn_chunk, Sq)
    if Sq % C:
        C = Sq
    scale = cfg.head_dim ** -0.5
    outs = [_sdpa(qg[:, i:i + C], k, v, q_pos[i:i + C], None, causal, scale)
            for i in range(0, Sq, C)]
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, Sq, H, hd)


def attention_full(cfg: ModelConfig, p, x, positions, *, causal=True,
                   kv_x=None, positions3=None, return_kv=False):
    """Full-sequence attention (train / prefill). x: (B, S, D)."""
    B, S, D = x.shape
    G = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _project_qkv(cfg, p, x, kv_x)
    if kv_x is None and cfg.use_rope:      # self-attention -> RoPE
        if cfg.mrope and positions3 is not None:
            q = apply_mrope(q, positions3, cfg.rope_theta,
                            cfg.mrope_sections)
            k = apply_mrope(k, positions3, cfg.rope_theta,
                            cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    # TP when heads divide the model axis; otherwise sequence parallelism
    # on the query axis, as the JAX package chooses
    mesh = shd.current_mesh()
    model_n = shd.mesh_shape(mesh).get("model", 1) if mesh is not None else 1
    q_log, kv_log, head_kv = ("batch", None, None, None), \
        ("batch", None, None, None), None
    if cfg.n_heads % model_n == 0:
        q_log = ("batch", None, "heads", None)
        q = shd.act(q, q_log)
        if cfg.n_kv_heads % model_n == 0:
            kv_log = ("batch", None, "kv_heads", None)
        elif mesh is not None:
            head_kv = torch.arange(cfg.n_heads, device=x.device) // G
    elif S % model_n == 0:
        q_log = ("batch", "seq_sharded", None, None)
        q = shd.act(q, q_log)
    k = shd.act(k, ("batch", None, "kv_heads", None))
    v = shd.act(v, ("batch", None, "kv_heads", None))
    q_pos = torch.arange(S, device=x.device)
    out = shd.local_map(
        functools.partial(_attend, cfg, causal),
        (q_log, kv_log, kv_log, q_log[1:2], q_log[2:3]), (q_log,))(
        q, k, v, q_pos, head_kv)
    y = einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    if return_kv:
        return y, (k, v)
    return y


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, KV, hd)
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(cfg: ModelConfig, p, x, cache: KVCache, index: int,
                     positions3=None, cross: bool = False):
    """One-token decode. x: (B, 1, D); index: position of the new token.
    Self-attention writes the new key and value into the cache in place
    and returns it; cross-attention reads the (pre-filled) cache."""
    B = x.shape[0]
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k_new, v_new = _project_qkv(cfg, p, x)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    if not cross:
        if not cfg.use_rope:
            pass
        elif cfg.mrope and positions3 is not None:
            q = apply_mrope(q, positions3, cfg.rope_theta,
                            cfg.mrope_sections)
            k_new = apply_mrope(k_new, positions3, cfg.rope_theta,
                                cfg.mrope_sections)
        else:
            q = apply_rope(q, pos, cfg.rope_theta)
            k_new = apply_rope(k_new, pos, cfg.rope_theta)
        cache.k[:, index:index + 1] = k_new.to(cache.k.dtype)
        cache.v[:, index:index + 1] = v_new.to(cache.v.dtype)
        valid_upto = index
    else:
        valid_upto = None
    mesh = shd.current_mesh()
    if mesh is not None and KV % shd.mesh_shape(mesh).get("model", 1):
        # the grouped reshape below cannot split heads sharded over a
        # model axis that the kv heads do not divide: gather them
        q = shd.act(q, ("batch", None, None, None))
    qg = q.reshape(B, 1, KV, G, cfg.head_dim)
    out = _sdpa(qg, cache.k, cache.v, pos[0], valid_upto, False,
                cfg.head_dim ** -0.5)
    out = out.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    y = einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, cache
