"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM's recurrence C_t = f_t·C_{t-1} + i_t·(v_t k_tᵀ), y_t = (C_t q_t) / nrm
maps directly onto the shared SSD core (ssm.ssd_chunked) with a = log f,
B = k, X = i·v, C = q; the normalizer n_t = f_t·n_{t-1} + i_t·k_t is the
same recurrence with P=1. Gates use sigmoid forget / sigmoid input, as in
the JAX package.

sLSTM is inherently sequential: a Python loop over time with per-head
block-diagonal recurrent weights and exponential-gate stabilization (m
state). The post-FFN's GELU is the tanh approximation (`jax.nn.gelu`'s
default).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import ParamDef, einsum, rmsnorm
from repro_torch.models.ssm import ssd_rows, ssd_step


# -----------------------------------------------------------------------
# mLSTM
# -----------------------------------------------------------------------

class MlstmCache(NamedTuple):
    c: torch.Tensor    # (B, H, N, P) matrix memory
    n: torch.Tensor    # (B, H, N) normalizer


def _mlstm_dims(cfg: ModelConfig):
    D = cfg.d_model
    d_inner = int(cfg.mlstm_proj_factor * D)
    H = cfg.n_heads
    P = d_inner // H
    N = max(8, P // 2)                  # qk dim factor 0.5
    return D, d_inner, H, P, N


def mlstm_def(cfg: ModelConfig) -> dict:
    D, d_inner, H, P, N = _mlstm_dims(cfg)
    return {
        "w_up": ParamDef((D, H, P), ("fsdp", "heads", None)),
        "w_gate": ParamDef((D, H, P), ("fsdp", "heads", None)),
        "wq": ParamDef((D, H, N), ("fsdp", "heads", None)),
        "wk": ParamDef((D, H, N), ("fsdp", "heads", None)),
        "wi": ParamDef((D, H), ("fsdp", "heads")),
        "wf": ParamDef((D, H), ("fsdp", "heads")),
        "f_bias": ParamDef((H,), ("heads",), init="ones"),
        "norm": ParamDef((H, P), ("heads", None), init="ones"),
        "w_down": ParamDef((H, P, D), ("heads", None, "fsdp"), axis=-3),
    }


# DTensor has no rule for log-sigmoid's backward: under a mesh it runs on
# each device's own rows
_logsigmoid = shd.local_map(F.logsigmoid, (("batch",),), (("batch",),))


def _mlstm_gates(p, x):
    # TP: xlstm has only 4 heads, so the model axis shards the qk (N) and
    # value (P) feature dims instead
    v = einsum("bsd,dhp->bshp", x, p["w_up"].to(x.dtype))
    v = shd.act(v, ("batch", None, None, "mlp"))
    z = einsum("bsd,dhp->bshp", x, p["w_gate"].to(x.dtype))
    z = shd.act(z, ("batch", None, None, "mlp"))
    q = einsum("bsd,dhn->bshn", x, p["wq"].to(x.dtype))
    q = shd.act(q, ("batch", None, None, "mlp"))
    k = einsum("bsd,dhn->bshn", x, p["wk"].to(x.dtype))
    k = shd.act(k, ("batch", None, None, "mlp"))
    i_raw = einsum("bsd,dh->bsh", x, p["wi"].to(x.dtype))
    f_raw = einsum("bsd,dh->bsh", x, p["wf"].to(x.dtype)) \
        + p["f_bias"].to(x.dtype)
    i_g = torch.sigmoid(i_raw.float())
    log_f = _logsigmoid(f_raw.float())
    return v, z, q, k, i_g, log_f


def _mlstm_out(p, y, z, shape):
    """Normalized output through the gate and the down projection."""
    B_, S, H, P = shape
    y = rmsnorm({"scale": p["norm"].reshape(-1)},
                y.reshape(B_, S, H * P)).reshape(B_, S, H, P)
    y = y * F.silu(z)
    return einsum("bshp,hpd->bsd", y, p["w_down"].to(z.dtype))


def mlstm_apply(cfg: ModelConfig, p, x, return_cache: bool = False):
    B_, S, D = x.shape
    _, d_inner, H, P, N = _mlstm_dims(cfg)
    v, z, q, k, i_g, log_f = _mlstm_gates(p, x)
    scale = N ** -0.5
    X = v.float() * i_g[..., None]
    y, cT = ssd_rows(log_f, k * scale, X, q, cfg.ssm_chunk)
    # normalizer: same recurrence with X = i (P=1)
    nrm, nT = ssd_rows(log_f, k * scale, i_g[..., None], q,
                       cfg.ssm_chunk)
    y = y / torch.clamp(torch.abs(nrm), min=1.0).to(y.dtype)
    out = _mlstm_out(p, y, z, (B_, S, H, P))
    if not return_cache:
        return out
    return out, MlstmCache(c=cT, n=nT[..., 0])


def mlstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    _, _, H, P, N = _mlstm_dims(cfg)
    return MlstmCache(
        c=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, N), dtype=torch.float32, device=device))


def mlstm_decode(cfg: ModelConfig, p, x, cache: MlstmCache):
    B_, _, D = x.shape
    _, d_inner, H, P, N = _mlstm_dims(cfg)
    v, z, q, k, i_g, log_f = _mlstm_gates(p, x)
    scale = N ** -0.5
    X = v[:, 0].float() * i_g[:, 0, :, None]
    y, c = ssd_step(cache.c, log_f[:, 0], k[:, 0] * scale, X, q[:, 0])
    n = cache.n * torch.exp(log_f[:, 0])[..., None] \
        + (k[:, 0] * scale).float() * i_g[:, 0, :, None]
    nrm = einsum("bhn,bhn->bh", q[:, 0].float(), n)
    y = y / torch.clamp(torch.abs(nrm), min=1.0)[..., None].to(y.dtype)
    out = _mlstm_out(p, y[:, None], z, (B_, 1, H, P))
    return out, MlstmCache(c=c, n=n)


# -----------------------------------------------------------------------
# sLSTM
# -----------------------------------------------------------------------

class SlstmCache(NamedTuple):
    c: torch.Tensor    # (B, H, P)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor    # exponential-gate stabilizer


GATES = ("z", "i", "f", "o")


def _slstm_dims(cfg: ModelConfig):
    D = cfg.d_model
    H = cfg.n_heads
    P = D // H
    return D, H, P


def slstm_def(cfg: ModelConfig) -> dict:
    D, H, P = _slstm_dims(cfg)
    d = {}
    for g in GATES:
        d[f"w{g}"] = ParamDef((D, H, P), ("fsdp", "heads", None))
        d[f"r{g}"] = ParamDef((H, P, P), ("heads", None, None), axis=-2)
        d[f"b{g}"] = ParamDef((H, P), ("heads", None), init="zeros")
    # post-FFN (factor 4/3 per the xLSTM paper)
    F_ = int(D * 4 / 3)
    d["ffn_up"] = ParamDef((D, F_), ("fsdp", "mlp"))
    d["ffn_down"] = ParamDef((F_, D), ("mlp", "fsdp"))
    return d


def _slstm_cell(p, xg, state: SlstmCache):
    """One step. xg: dict gate -> (B, H, P) pre-activations from input."""
    c, n, h, m = state
    pre = {g: xg[g] + einsum("bhp,hpq->bhq", h, p[f"r{g}"].to(h.dtype))
           for g in GATES}
    z = torch.tanh(pre["z"].float())
    o = torch.sigmoid(pre["o"].float())
    log_i = pre["i"].float()                             # exponential gate
    log_f = _logsigmoid(pre["f"].float())
    m_new = torch.maximum(log_f + m, log_i)              # stabilizer
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.clamp(f_s * n + i_s, min=1e-6)
    h_new = o * c_new / n_new
    return SlstmCache(c_new, n_new, h_new.to(h.dtype), m_new)


def _slstm_ffn(p, y, dtype):
    """The post-FFN, weights in the model's ``dtype`` (a decode from
    `init_cache` reads a bf16 ``h`` in a float32 model)."""
    f = F.gelu(einsum("bsd,df->bsf", y, p["ffn_up"].to(dtype)),
               approximate="tanh")
    return einsum("bsf,fd->bsd", f, p["ffn_down"].to(dtype))


def slstm_apply(cfg: ModelConfig, p, x, return_cache: bool = False):
    B_, S, D = x.shape
    D, H, P = _slstm_dims(cfg)
    xg = {g: einsum("bsd,dhp->bshp", x, p[f"w{g}"].to(x.dtype))
          + p[f"b{g}"].to(x.dtype) for g in GATES}
    *hs, c, n, h, m = _slstm_scan_rows(
        *(xg[g] for g in GATES), *(p[f"r{g}"] for g in GATES))
    state = SlstmCache(c, n, h, m)
    y = hs[0].reshape(B_, S, D)
    out = _slstm_ffn(p, y, x.dtype)
    if not return_cache:
        return out
    return out, state


def _slstm_scan(*tensors):
    """The recurrence over the sequence from the gates' input
    pre-activations (four (B, S, H, P)) and recurrent weights (four (H,
    P, P)), in `GATES` order: every step's h stacked (B, S, H, P), and
    the final state's c, n, h, m."""
    xg = dict(zip(GATES, tensors[:4]))
    p = {f"r{g}": r for g, r in zip(GATES, tensors[4:])}
    x = tensors[0]
    B_, S, H, P = x.shape
    state = _slstm_state((B_, H, P), x.dtype, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, {g: xg[g][:, t] for g in GATES}, state)
        hs.append(state.h)
    return (torch.stack(hs, dim=1),) + tuple(state)


# under a mesh the sequential scan runs on each device's own rows, the
# heads and the recurrent weights gathered
_RW = (None, None, None)
_slstm_scan_rows = shd.local_map(
    _slstm_scan, (("batch",),) * 4 + (_RW,) * 4, (("batch",),) * 5)


def _slstm_state(shape, dtype, device) -> SlstmCache:
    """The sLSTM's initial state, (B, H, P) each: c = m = 0, n = 1, h = 0
    in ``dtype``."""
    return SlstmCache(
        c=torch.zeros(shape, dtype=torch.float32, device=device),
        n=torch.ones(shape, dtype=torch.float32, device=device),
        h=torch.zeros(shape, dtype=dtype, device=device),
        m=torch.zeros(shape, dtype=torch.float32, device=device))


def slstm_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    D, H, P = _slstm_dims(cfg)
    return _slstm_state((batch, H, P), dtype, device)


def slstm_decode(cfg: ModelConfig, p, x, cache: SlstmCache):
    B_ = x.shape[0]
    xg = {g: einsum("bd,dhp->bhp", x[:, 0], p[f"w{g}"].to(x.dtype))
          + p[f"b{g}"].to(x.dtype) for g in GATES}
    cache = _slstm_cell(p, xg, cache)
    D, H, P = _slstm_dims(cfg)
    y = cache.h.reshape(B_, 1, D)
    return _slstm_ffn(p, y, x.dtype), cache
