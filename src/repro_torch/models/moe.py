"""Mixture-of-Experts with ALTO-linearized sorted dispatch.

This is where the paper's technique is a first-class feature of the LM
stack: the (token, expert) routing assignment is a sparse rank-2 tensor,
and it is dispatched the way ALTO executes an output-oriented traversal
(paper §4.2):

  1. linearize each routing pair to a single integer key with the expert
     bits above the pair-index bits (expert-major: the "output mode" here
     is the expert, since the conflicting resource is the per-expert
     buffer);
  2. sort by the linearized key (one 1-D sort instead of a 2-D lexsort);
  3. runs of equal expert id become contiguous segments; each pair's slot
     is its rank within the segment (the capacity bucket), conflict-free
     by construction.

Capacity and slots are per batch row, as the JAX package's `vmap` over
rows has them: each row's keys are sorted on their own. Pairs past an
expert's capacity are dropped, their weight zeroed (the top-k weights are
normalized before the drop), standard for capacity-bucketed MoE.

The JAX package scatter-adds both ways; here the dispatch writes each kept
pair into its own (expert, slot), and the combine gathers each token's K
contributions and sums them in a fixed order, the order the JAX scatter
adds them (expert-major on the ALTO path, ``k`` order on the reference
path): no float atomics, so two runs on the card give equal bits.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding as shd
from repro_torch.models.common import ParamDef, einsum, swiglu


def moe_def(cfg: ModelConfig) -> dict:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_expert
    ep = "expert_dp" if cfg.moe_ep_axis == "data" else "expert"
    return {
        "router": ParamDef((D, E), ("fsdp", None)),
        "w_gate": ParamDef((E, D, F_), (ep, "fsdp", "mlp"), axis=-2),
        "w_up": ParamDef((E, D, F_), (ep, "fsdp", "mlp"), axis=-2),
        "w_down": ParamDef((E, F_, D), (ep, "mlp", "fsdp"), axis=-2),
    }


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(cfg.experts_per_token * n_tokens / cfg.n_experts
            * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)          # pad to a multiple of 8


def _alto_sort_dispatch(expert_ids, n_experts, n_tokens):
    """ALTO-style linearized sort of (expert, pair) keys, row by row.

    expert_ids: (..., T*k) integer. Returns (order, slot, seg_expert) over
    the last axis: `order` sorts pairs expert-major, `slot` is the rank of
    each sorted pair within its expert segment (capacity bucket index),
    `seg_expert` the sorted expert ids. The key has the JAX package's
    32-bit layout, held in int64 (the card's sort takes no uint32); it
    carries the pair index, so it is unique and the order is determined.
    """
    tk = expert_ids.shape[-1]
    pair_bits = max(1, (tk - 1).bit_length())
    if pair_bits + max(1, (n_experts - 1).bit_length()) > 32:
        raise ValueError("linearized routing key exceeds 32 bits")
    idx = torch.arange(tk, device=expert_ids.device)
    key = (expert_ids.long() << pair_bits) | idx
    order = torch.sort(key, dim=-1).indices          # expert-major run order
    sorted_e = torch.gather(expert_ids, -1, order)
    # rank within segment: position minus index of the segment start
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.cummax(
        torch.where(is_start, idx, torch.zeros_like(idx)), dim=-1).values
    slot = idx - seg_start
    return order, slot, sorted_e


def _one_hot(ids, n: int):
    """`F.one_hot` without its range check, which waits for the device."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def _reference_slots(flat_e, n_experts):
    """Per-expert cumulative counts without sorting: each pair's rank among
    the earlier pairs of its expert. flat_e: (..., T*k)."""
    return torch.gather(torch.cumsum(_one_hot(flat_e, n_experts), dim=-2) - 1,
                        -1, flat_e.long()[..., None])[..., 0]


def dispatch_slots(cfg: ModelConfig, top_e, C: int, alto: bool):
    """Every (token, k) pair's capacity slot and whether it is kept.

    top_e: (B, S, K). Returns (slot, keep, add_order): slot and keep in
    pair order (B, S·K); add_order (B, S, K) the order in which a token's
    K contributions are summed (ascending expert on the ALTO path, which
    is the sorted order; ``k`` order on the reference path)."""
    B, S, K = top_e.shape
    flat_e = top_e.reshape(B, S * K)
    if alto:
        order, slot_sorted, _ = _alto_sort_dispatch(flat_e, cfg.n_experts, S)
        slot = torch.empty_like(slot_sorted)
        slot.scatter_(-1, order, slot_sorted)
        add_order = torch.argsort(top_e, dim=-1)
    else:
        slot = _reference_slots(flat_e, cfg.n_experts)
        add_order = torch.arange(K, device=top_e.device).expand(B, S, K)
    return slot, slot < C, add_order


def route(cfg: ModelConfig, p, x):
    """The router on x (B, S, D): (probs (B, S, E) float32, top_p, top_e),
    the top-k experts (B, S, K) in descending probability and their
    weights normalized over the k."""
    logits = einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1,
                              sorted=True)
    return probs, top_p / torch.sum(top_p, dim=-1, keepdim=True), top_e


def _dispatch(cfg: ModelConfig, x, top_e):
    """Every row's tokens into its (E, C) capacity buckets: the bucket
    buffer (B, E, C, D), each pair's row of it and whether it was kept."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, S)                                 # per-row buckets
    slot, keep, add_order = dispatch_slots(cfg, top_e, C,
                                           cfg.moe_alto_dispatch)
    flat_e = top_e.reshape(B, S * K)
    rows = (torch.arange(B, device=x.device)[:, None] * E + flat_e) * C \
        + torch.where(keep, slot, torch.zeros_like(slot))
    trash = B * E * C                       # where dropped pairs land
    dest = torch.where(keep, rows, torch.full_like(rows, trash))
    tok = torch.arange(S, device=x.device).repeat_interleave(K)
    buf = torch.zeros((trash + 1, D), dtype=x.dtype, device=x.device)
    buf[dest.reshape(-1)] = x[:, tok].reshape(B * S * K, D)
    return buf[:trash].view(B, E, C, D), rows, keep, add_order


def _combine(y, rows, keep, add_order, top_p):
    """Each token's kept expert outputs, weighted and summed in
    ``add_order``: (B, S, D)."""
    B, E, C, D = y.shape
    S, K = top_p.shape[1:]
    w = (top_p.reshape(B, S * K) * keep).to(y.dtype)
    contrib = (y.reshape(B * E * C, D)[rows.reshape(-1)].view(B, S * K, D)
               * w[..., None]).view(B, S, K, D)
    contrib = torch.gather(contrib, 2,
                           add_order[..., None].expand(B, S, K, D))
    out = contrib[:, :, 0]
    for k in range(1, K):
        out = out + contrib[:, :, k]
    return out


# under a mesh the dispatch and the combine (a sort, gathers, scatters and
# indexed writes) run on each device's own rows
_ROW3 = ("batch", None, None)
_ROW4 = ("batch", None, None, None)


def moe_ffn(cfg: ModelConfig, p, x):
    """x: (B, S, D) -> (B, S, D), plus router aux loss (load balancing)."""
    E = cfg.n_experts
    probs, top_p, top_e = route(cfg, p, x)

    # load-balancing aux loss (Switch): E * <f_e, p_e>
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(_one_hot(top_e[..., 0], E).float(), dim=(0, 1))
    aux = E * torch.sum(me * ce)

    buf, rows, keep, add_order = shd.local_map(
        functools.partial(_dispatch, cfg), (_ROW3, _ROW3),
        (_ROW4, ("batch", None), ("batch", None), _ROW3))(x, top_e)
    ep = "expert_dp" if cfg.moe_ep_axis == "data" else "expert"
    buf_spec = ((None, ep, None, None) if ep == "expert_dp"
                else ("batch", ep, None, None))           # a2a over data
    buf = shd.act(buf, buf_spec)

    h = swiglu(
        einsum("becd,edf->becf", buf, p["w_gate"].to(x.dtype)),
        einsum("becd,edf->becf", buf, p["w_up"].to(x.dtype)))
    h = shd.act(h, buf_spec[:3] + ("mlp",))
    y = einsum("becf,efd->becd", h, p["w_down"].to(x.dtype))
    y = shd.act(y, buf_spec)

    out = shd.local_map(_combine, (_ROW4, ("batch", None), ("batch", None),
                                   _ROW3, _ROW3), (_ROW3,))(
        y, rows, keep, add_order, top_p)
    return out, aux
