"""State-space / linear-recurrence substrate.

`ssd_chunked` is the shared chunked-scan core (Mamba2's SSD algorithm):
within a chunk the recurrence is computed in a parallel attention-like
form; across chunks a Python loop (the JAX package's scan) carries the
(H, N, P) state. Both Mamba2 blocks (zamba2) and mLSTM cells (xlstm) lower
onto this core — an mLSTM is the same recurrence with a = log f, B = k,
X = i·v, C = q.

Decode is the O(1) per-token state update.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import ParamDef, einsum, rmsnorm


def softplus(x):
    """log(1 + exp(x)) with no linear threshold (`jax.nn.softplus`)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(a, Bm, X, Cm, chunk: int):
    """Chunked linear recurrence  h_t = exp(a_t)·h_{t-1} + B_t ⊗ X_t,
    y_t = C_t · h_t.

    a:  (B, S, H)      log-decay per step
    Bm: (B, S, G, N)   input maps (G groups of heads; G=1 broadcasts)
    X:  (B, S, H, P)   inputs
    Cm: (B, S, G, N)   output maps
    Returns y (B, S, H, P), final state (B, H, N, P) float32.
    """
    Bsz, S, H = a.shape
    N = Bm.shape[-1]
    P = X.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    G = Bm.shape[2]
    hpg = H // G                                        # heads per group
    af = a.float().reshape(Bsz, nc, Q, H)
    Bh = Bm.reshape(Bsz, nc, Q, G, N).repeat_interleave(hpg, dim=3).float()
    Ch = Cm.reshape(Bsz, nc, Q, G, N).repeat_interleave(hpg, dim=3).float()
    Xc = X.float().reshape(Bsz, nc, Q, H, P)

    cum = torch.cumsum(af, dim=2)                      # (B,nc,Q,H)
    total = cum[:, :, -1:, :]                          # (B,nc,1,H)

    # --- intra-chunk (parallel attention-like form) ---
    # L[i,j] = exp(cum_i - cum_j) for i >= j. Above the diagonal the
    # difference can pass float32's exp range: it is masked to -inf
    # before the exponential, so exp gives 0 there and so does its
    # gradient. (The JAX package masks after exp, where its backward
    # multiplies the masked zero by exp's inf: NaN gradients once the
    # decay sums pass ~88, at full width. The values are the same.)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=a.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                              float("-inf")))
    scores = einsum("bcihn,bcjhn->bcijh", Ch, Bh)    # (B,nc,Q,Q,H)
    y_intra = einsum("bcijh,bcjhp->bcihp", scores * L, Xc)

    # --- chunk states ---
    decay_state = torch.exp(total - cum)                # (B,nc,Q,H)
    BX = einsum("bcjhn,bcjh,bcjhp->bchnp", Bh, decay_state, Xc)

    chunk_decay = torch.exp(total[:, :, 0, :])          # (B,nc,H)

    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=a.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + BX[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B,nc,H,N,P)

    # --- inter-chunk contribution ---
    y_inter = einsum("bcihn,bchnp->bcihp", Ch, h_prevs)
    y_inter = y_inter * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(X.dtype), h


_R3, _R4 = ("batch", None, None), ("batch", None, None, None)
# under a mesh the scan runs on each device's own rows, the heads gathered
ssd_rows = shd.local_map(ssd_chunked, (_R3, _R4, _R4, _R4, None),
                         (_R4, _R4))


def ssd_step(h, a, Bm, X, Cm):
    """Single-token recurrence step. h: (B,H,N,P); a: (B,H);
    Bm/Cm: (B,G,N); X: (B,H,P). Returns y (B,H,P), new h."""
    G = Bm.shape[1]
    hpg = h.shape[1] // G
    Bfull = Bm.repeat_interleave(hpg, dim=1)            # (B,H,N)
    Cfull = Cm.repeat_interleave(hpg, dim=1)
    h = h * torch.exp(a.float())[:, :, None, None] \
        + Bfull[..., None].float() * X[:, :, None, :]
    y = einsum("bhn,bhnp->bhp", Cfull.float(), h)
    return y.to(X.dtype), h


# -----------------------------------------------------------------------
# Mamba2 block
# -----------------------------------------------------------------------

class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, H·P + 2N) pre-conv channels, bf16
    h: torch.Tensor      # (B, H, N, P) float32


def mamba_def(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    P = cfg.ssm_head_dim
    H = (2 * D) // P                   # expand factor 2
    N = cfg.ssm_state
    W = cfg.conv_width
    return {
        "wz": ParamDef((D, H, P), ("fsdp", "heads", None)),
        "wx": ParamDef((D, H, P), ("fsdp", "heads", None)),
        "wB": ParamDef((D, N), ("fsdp", None)),
        "wC": ParamDef((D, N), ("fsdp", None)),
        "wdt": ParamDef((D, H), ("fsdp", "heads")),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "a_log": ParamDef((H,), ("heads",), init="zeros"),
        "skip": ParamDef((H,), ("heads",), init="ones"),
        "conv_x": ParamDef((W, H, P), (None, "heads", None), init="normal"),
        "conv_B": ParamDef((W, N), (None, None), init="normal"),
        "conv_C": ParamDef((W, N), (None, None), init="normal"),
        "norm": ParamDef((H, P), ("heads", None), init="ones"),
        "wo": ParamDef((H, P, D), ("heads", None, "fsdp"), axis=-3),
    }


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv along seq. x: (B,S,...C), w: (W,...C)."""
    W = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], W - 1) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(W))
    new_cache = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(out), new_cache


def _mamba_in(p, x):
    z = einsum("bsd,dhp->bshp", x, p["wz"].to(x.dtype))
    xs = einsum("bsd,dhp->bshp", x, p["wx"].to(x.dtype))
    Bm = einsum("bsd,dn->bsn", x, p["wB"].to(x.dtype))
    Cm = einsum("bsd,dn->bsn", x, p["wC"].to(x.dtype))
    dt = einsum("bsd,dh->bsh", x, p["wdt"].to(x.dtype))
    return z, xs, Bm, Cm, dt


def mamba_apply(cfg: ModelConfig, p, x, return_cache: bool = False):
    """x: (B, S, D) -> (B, S, D). Training / prefill path."""
    B_, S, D = x.shape
    P = cfg.ssm_head_dim
    W = cfg.conv_width
    H = (2 * D) // P
    z, xs0, Bm0, Cm0, dt = _mamba_in(p, x)
    xs, _ = _causal_conv(xs0, p["conv_x"])
    Bm, _ = _causal_conv(Bm0, p["conv_B"])
    Cm, _ = _causal_conv(Cm0, p["conv_C"])
    xs = shd.act(xs, ("batch", None, "heads", None))

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())                   # (H,) negative
    a = dt * A[None, None, :]                            # (B,S,H) log decay
    X = xs.float() * dt[..., None]
    y, hT = ssd_rows(a, Bm[:, :, None, :], X, Cm[:, :, None, :],
                     cfg.ssm_chunk)
    y = y + xs * p["skip"].to(x.dtype)[None, None, :, None]
    y = rmsnorm({"scale": p["norm"].reshape(-1)},
                y.reshape(B_, S, H * P)).reshape(B_, S, H, P)
    y = y * F.silu(z)
    out = einsum("bshp,hpd->bsd", y, p["wo"].to(x.dtype))
    if not return_cache:
        return out
    # conv cache: last W-1 *pre-conv* channel values, matching decode
    # layout, in bf16 whatever the model's dtype (as the JAX package has it)
    tail = torch.cat([xs0.reshape(B_, S, H * P), Bm0, Cm0],
                     dim=-1)[:, -(W - 1):]
    return out, MambaCache(conv=tail.to(torch.bfloat16), h=hT)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None):
    D = cfg.d_model
    P, N, W = cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width
    H = (2 * D) // P
    return MambaCache(
        conv=torch.zeros((batch, W - 1, H * P + 2 * N), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device))


def mamba_decode(cfg: ModelConfig, p, x, cache: MambaCache):
    """x: (B, 1, D) one token. Returns y (B,1,D), new cache."""
    B_, _, D = x.shape
    P, N, W = cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width
    H = (2 * D) // P
    z, xs, Bm, Cm, dt = _mamba_in(p, x)

    conv_in = torch.cat([xs.reshape(B_, 1, H * P), Bm, Cm],
                        dim=-1)                          # (B,1,HP+2N)
    xp = torch.cat([cache.conv.to(x.dtype), conv_in], dim=1)
    w_full = torch.cat([p["conv_x"].reshape(W, H * P), p["conv_B"],
                        p["conv_C"]], dim=-1)
    conv_out = F.silu(einsum("bwc,wc->bc", xp, w_full.to(x.dtype)))
    xs = conv_out[:, :H * P].reshape(B_, H, P)
    Bm = conv_out[:, H * P:H * P + N].reshape(B_, 1, N)
    Cm = conv_out[:, H * P + N:].reshape(B_, 1, N)
    new_conv = xp[:, 1:]

    dt = softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B,H)
    A = -torch.exp(p["a_log"].float())
    a = dt * A[None, :]
    X = xs.float() * dt[..., None]
    y, h = ssd_step(cache.h, a, Bm, X, Cm)               # (B,H,P)
    y = y + xs * p["skip"].to(x.dtype)[None, :, None]
    y = rmsnorm({"scale": p["norm"].reshape(-1)},
                y.reshape(B_, 1, H * P)).reshape(B_, H, P)
    y = y * F.silu(z[:, 0])
    out = einsum("bhp,hpd->bd", y, p["wo"].to(x.dtype))
    return out[:, None, :], MambaCache(conv=new_conv.to(cache.conv.dtype),
                                       h=h)
