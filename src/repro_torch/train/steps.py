"""Train and serve step builders (the JAX package's `train/steps.py`).

`make_train_step` gives ``train_step(model, optimizer, batch,
compress_state=None)``, which updates the model and the optimizer in place
and returns the metrics, with:
  * microbatch gradient accumulation (``cfg.grad_accum``), the batch split
    as the JAX step splits it and the gradients summed in the parameters'
    dtype;
  * gradient compression (bf16 / int8 with error feedback), applied before
    clipping;
  * global-norm clipping over the JAX leaves.

Gradients travel as a list per JAX leaf (`models.model.jax_leaves`, the
optimizer's groups), one tensor a layer for a stacked leaf.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.models.common import unembed
from repro_torch.optim import compress as compress_lib


def _token_ce(logits: torch.Tensor, labels: torch.Tensor):
    """Each token's CE (zero where the label is -1) and the label mask."""
    mask = (labels >= 0).float()
    safe = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    return (lse - ll) * mask, mask


# under a mesh the vocabulary is gathered and each device takes its rows
_token_ce_rows = shd.local_map(_token_ce, (("batch", None, None),
                                           ("batch", None)),
                               (("batch", None), ("batch", None)))


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor):
    """The summed token CE over the labels that are not -1, and their
    count."""
    ce, mask = _token_ce_rows(logits, labels)
    return torch.sum(ce), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token CE with -1 = ignore. logits (B,S,V) float32 over the padded
    vocabulary, labels (B,S) int."""
    s, n = _ce_sums(logits, labels)
    return s / torch.clamp_min(n, 1.0)


def _chunked_ce(cfg: ModelConfig, model, hidden, labels, chunk: int):
    """CE over sequence chunks, each under `torch.utils.checkpoint`: one
    chunk's (B,C,V) logits are the only vocabulary-sized buffer live."""
    B, S, D = hidden.shape
    C = min(chunk, S)
    while S % C:
        C -= 1
    emb = model_lib.unembed_params(cfg, model)

    def body(h, lab):
        return _ce_sums(unembed(emb, h), lab)

    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, C):
        sc, nc = model_lib.remat(body, hidden[:, c:c + C],
                                 labels[:, c:c + C])
        s, n = s + sc, n + nc
    return s / torch.clamp_min(n, 1.0)


def make_loss_fn(cfg: ModelConfig):
    """``loss_fn(model, batch) -> (loss, {"loss", "ce", "aux"})``."""
    def loss_fn(model, batch):
        if cfg.loss_seq_chunk > 0:
            hidden, aux = model_lib.forward_hidden(cfg, model, batch)
            ce = _chunked_ce(cfg, model, hidden, batch["labels"],
                             cfg.loss_seq_chunk)
        else:
            logits, aux = model_lib.forward(cfg, model, batch)
            ce = cross_entropy(logits, batch["labels"])
        loss = ce + cfg.router_aux_coef * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    return loss_fn


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in JAX order (a stacked
    leaf's layers summed in repeat order), in float32."""
    total = 0
    for leaf in grads:
        sq = 0
        for g in leaf:
            sq = sq + torch.sum(torch.square(g.float()))
        total = total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float):
    """The gradients scaled in place to ``max_norm`` at most (the scale
    cast to each gradient's dtype), and the norm before."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-6), 1.0)
    for leaf in grads:
        for g in leaf:
            g.mul_(scale.to(g.dtype))
    return grads, norm


def _split(key: str, x: torch.Tensor, accum: int) -> list:
    """``accum`` microbatches of ``x`` (``positions3`` (3, B, S) splits on
    axis 1), consecutive rows each, as the JAX step's reshape."""
    ax = 1 if key == "positions3" else 0
    if x.shape[ax] % accum:
        raise ValueError(f"{key}: batch {x.shape[ax]} is not a multiple of "
                         f"grad_accum {accum}")
    return list(torch.chunk(x, accum, dim=ax))


def make_train_step(cfg: ModelConfig, clip_norm: float = 1.0,
                    compression: str | None = None):
    """compression: None | 'bf16' | 'int8_ef'. The step returns the
    metrics (loss, ce, aux, grad_norm: float32 device scalars), and under
    'int8_ef' also the new error state (`compress.init_error_feedback`
    gives the first)."""
    loss_fn = make_loss_fn(cfg)
    accum = max(1, cfg.grad_accum)
    chunks = max(1, cfg.opt_update_chunks)

    def grads_of(params, shape, model, batch):
        loss, metrics = loss_fn(model, batch)
        it = iter(torch.autograd.grad(loss, params))
        return ([[next(it) for _ in range(n)] for n in shape],
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(optimizer, model, batch):
        groups = optimizer.param_groups
        params = [p for g in groups for p in g["params"]]
        shape = [len(g["params"]) for g in groups]
        if accum == 1:
            return grads_of(params, shape, model, batch)
        parts = {k: _split(k, v, accum) for k, v in batch.items()}
        g_acc = [[torch.zeros_like(p) for p in g["params"]] for g in groups]
        m_acc = {k: torch.zeros((), dtype=torch.float32,
                                device=params[0].device)
                 for k in ("loss", "ce", "aux")}
        for i in range(accum):
            g, metrics = grads_of(params, shape, model,
                                  {k: v[i] for k, v in parts.items()})
            for acc, leaf in zip(g_acc, g):
                for a, b in zip(acc, leaf):
                    a.add_(b.to(a.dtype))
            m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
        for leaf in g_acc:
            for a in leaf:
                a.div_(accum)
        return g_acc, {k: v / accum for k, v in m_acc.items()}

    def train_step(model, optimizer, batch, compress_state=None):
        grads, metrics = compute_grads(optimizer, model, batch)
        if compression == "bf16":
            grads = compress_lib.bf16_compress(grads)
        elif compression == "int8_ef":
            grads, compress_state = compress_lib.int8_with_error_feedback(
                grads, compress_state)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        optimizer.step(grads=grads, chunks=chunks)
        metrics["grad_norm"] = gnorm
        if compression == "int8_ef":
            return metrics, compress_state
        return metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, s_max: int):
    def prefill_step(model, batch):
        return model_lib.prefill(cfg, model, batch, s_max)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(model, tokens, cache, index, positions3=None):
        return model_lib.decode_step(cfg, model, tokens, cache, index,
                                     positions3=positions3)
    return decode_step
