"""GPipe pipeline parallelism over the model stack, over a process group.

The depth of `models.model` is ``n_repeats`` repeats of the block pattern;
pipeline parallelism cuts it into ``n_stages`` contiguous stages, one a
rank of the group passed at call time (``group=``, default the world
group; the rank in it is the stage), and streams microbatches through
them:

* `to_pipeline_params` groups the model's layers by stage: stage ``s``
  owns layers ``[s·per·P, (s+1)·per·P)`` of ``model.layers`` (``per =
  n_repeats / n_stages`` repeats, ``P`` the pattern length), the layers
  themselves, not copies. Embedding, final norm and unembedding stay
  outside the stages: stage 0's rank embeds, every rank normalizes and
  unembeds. `from_pipeline_params` is its inverse;
* `pipeline_forward` runs the GPipe schedule: stage 0 injects microbatch
  ``t`` at tick ``t``; each stage applies its layers to its microbatches
  in order and hands each activation (with the running aux loss) to the
  next stage point to point; the last stage's outputs reach every rank
  (a broadcast, the JAX package's ``psum`` of the masked outputs). A rank
  computes only its real microbatches: the bubble ticks are idle here,
  where the JAX schedule computes them on zeros and masks them out;
* `pipeline_loss` is the training entry, differentiable with respect to
  every parameter by ``loss.backward()`` on every rank: the point-to-point
  hand-offs are `torch.autograd.Function`\\ s whose backward sends the
  gradient back a stage (the receive's backward sends it, the send's
  backward receives it), so autograd runs the reverse schedule, last
  microbatch first. The broadcast's backward keeps the last stage's own
  gradient (every rank computes the same loss from the same outputs).

Hand-offs go through ``torch.distributed.send`` / ``recv``. gloo cannot
send a CUDA tensor, so on the card an activation (and its gradient) is
staged through a pinned host buffer both ways; `PipeStats` counts those
bytes. Two ranks may share one card.

Equivalence: stage 0 embeds each microbatch on its own, and stage ``s``
applies its layers in `model.forward_hidden`'s order, under the same
remat (one repeat a checkpoint), carrying the aux sum from stage to
stage, so each microbatch's hidden state and aux equal the sequential
model's on that microbatch bit for bit. Final norm and unembedding run
per microbatch, so the logits equal the sequential model's on each
microbatch; the aux losses of the microbatches are summed in order and
divided by ``n_microbatches``.

Gradients: a stage's layers hold theirs on their own rank, and the
parameters outside the stages theirs on stage 0's rank (the embedding's
input path runs there; the other ranks hold the unembedding path
alone). Autograd sums each parameter's microbatch contributions last
microbatch first, as the sequential model's backward over the same
microbatches run one after another does; a tied embedding table's two
uses go through `_Tied`, which sums them in that model's order too (each
microbatch's unembedding, then its embedding), so every gradient can
equal that run's bit for bit.

Scope: decoder-only families (dense/moe/ssm/hybrid). Encoder-decoder and
VLM prefixes keep their sequential path.
"""
from __future__ import annotations

import dataclasses
import types

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import rmsnorm, unembed
from repro_torch.train.steps import cross_entropy


@dataclasses.dataclass
class PipelineParams:
    """A model's parameters grouped for ``n_stages`` stages: ``stages[s]``
    the layers stage ``s`` owns, ``model`` the rest (its ``layers`` are
    not read by the pipeline)."""
    model: model_lib.Model
    stages: list[nn.ModuleList]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


@dataclasses.dataclass
class PipeStats:
    """Bytes this rank staged through the host, and its hand-offs."""
    staged_bytes: int = 0
    sends: int = 0
    recvs: int = 0


def _per_stage(cfg: ModelConfig, n_stages: int) -> int:
    if cfg.n_repeats % n_stages:
        raise ValueError(f"n_repeats {cfg.n_repeats} not divisible by "
                         f"{n_stages} pipeline stages")
    return cfg.n_repeats // n_stages


def to_pipeline_params(cfg: ModelConfig, model, n_stages: int
                       ) -> PipelineParams:
    """Group ``model.layers`` into ``n_stages`` contiguous stages of
    ``n_repeats // n_stages`` repeats each, keeping the layer order."""
    per = _per_stage(cfg, n_stages) * len(cfg.block_pattern)
    return PipelineParams(model, [
        nn.ModuleList(model.layers[s * per:(s + 1) * per])
        for s in range(n_stages)])


def from_pipeline_params(cfg: ModelConfig, pp: PipelineParams):
    """Inverse of `to_pipeline_params`: the model with its stages merged
    back into one stack."""
    pp.model.layers = nn.ModuleList(
        layer for stage in pp.stages for layer in stage)
    return pp.model


def _to_host(t: torch.Tensor, stats: PipeStats) -> torch.Tensor:
    """``t`` as a CPU tensor gloo can send; a CUDA tensor goes through a
    pinned buffer (its bytes counted)."""
    if t.device.type == "cpu":
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    stats.staged_bytes += buf.numel() * buf.element_size()
    return buf


def _recv(shape, dtype, device, src: int, group, stats: PipeStats):
    pinned = device.type == "cuda"
    buf = torch.empty(shape, dtype=dtype, pin_memory=pinned)
    dist.recv(buf, group_src=src, group=group)
    if not pinned:
        return buf
    stats.staged_bytes += buf.numel() * buf.element_size()
    return buf.to(device)


def _send(t: torch.Tensor, dst: int, group, stats: PipeStats):
    dist.send(_to_host(t, stats), group_dst=dst, group=group)


class _Send(torch.autograd.Function):
    """Send (x, aux) to the next stage; returns a scalar token whose
    backward receives their gradients from that stage."""

    @staticmethod
    def forward(ctx, x, aux, dst, group, stats):
        ctx.meta = (x.shape, x.dtype, x.device, dst, group, stats)
        _send(x, dst, group, stats)
        _send(aux.reshape(1), dst, group, stats)
        stats.sends += 1
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, group, stats = ctx.meta
        gx = _recv(shape, dtype, device, dst, group, stats)
        gaux = _recv((1,), torch.float32, device, dst, group, stats)
        return gx, gaux.reshape(()), None, None, None


class _Recv(torch.autograd.Function):
    """Receive (x, aux) from the previous stage; the backward sends their
    gradients back to it. ``anchor`` is a leaf that requires grad, so
    the outputs join the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group, stats):
        ctx.meta = (src, group, stats)
        x = _recv(shape, dtype, anchor.device, src, group, stats)
        aux = _recv((1,), torch.float32, anchor.device, src, group, stats)
        stats.recvs += 1
        return x, aux.reshape(())

    @staticmethod
    def backward(ctx, gx, gaux):
        src, group, stats = ctx.meta
        _send(gx, src, group, stats)
        _send(gaux.reshape(1), src, group, stats)
        return None, None, None, None, None, None


class _Tied(torch.autograd.Function):
    """``2n`` aliases of a tied embedding table: microbatch ``m``'s
    embedding (``2m``) and unembedding (``2m + 1``). The backward sums
    their gradients microbatch by microbatch, the last first and each
    one's unembedding before its embedding: the order in which the
    sequential model's backward accumulates the table's gradient over the
    same microbatches run one after another."""

    @staticmethod
    def forward(ctx, w, n):
        ctx.set_materialize_grads(False)
        return tuple(w.view_as(w) for _ in range(2 * n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for m in reversed(range(len(grads) // 2)):
            for g in (grads[2 * m + 1], grads[2 * m]):
                if g is not None:
                    total = g if total is None else total + g
        return total, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs on every rank. On the last rank the inputs
    are its outputs and the backward hands it the gradient; elsewhere
    they are the send tokens, whose zero gradients start the backward
    sends of the earlier stages."""

    @staticmethod
    def forward(ctx, shapes, dtype, src, group, stats, *inputs):
        rank = dist.get_rank(group)
        ctx.last, ctx.n_in = rank == src, len(inputs)
        device = ctx.device = inputs[0].device
        outs = []
        for i, shape in enumerate(shapes):
            dt = torch.float32 if i == len(shapes) - 1 else dtype
            if ctx.last:
                t = _to_host(inputs[i], stats)
            else:
                t = torch.empty(shape, dtype=dt,
                                pin_memory=device.type == "cuda")
            dist.broadcast(t, group_src=src, group=group)
            if not ctx.last and device.type == "cuda":
                stats.staged_bytes += t.numel() * t.element_size()
            outs.append(inputs[i] if ctx.last else t.to(device))
        return tuple(o.clone() if ctx.last else o for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.last:
            return (None,) * 5 + tuple(grads)
        return (None,) * 5 + tuple(torch.zeros((), device=ctx.device)
                                   for _ in range(ctx.n_in))


def _group_info(group):
    group = group if group is not None else dist.group.WORLD
    return group, dist.get_rank(group), dist.get_world_size(group)


def forward_with_aux(cfg: ModelConfig, pp: PipelineParams, tokens,
                     n_microbatches: int, group=None,
                     stats: PipeStats | None = None):
    """The pipelined forward on every rank: (logits, aux loss)."""
    if cfg.is_encdec or cfg.family == "vlm":
        raise NotImplementedError(
            "pipeline parallelism covers decoder-only token models; "
            f"{cfg.name} ({cfg.family}) needs the sequential path "
            "(cross-attention / multimodal prefixes are not staged)")
    group, rank, n_stages = _group_info(group)
    if n_stages != pp.n_stages:
        raise ValueError(f"{pp.n_stages} stages on a group of {n_stages}")
    stats = stats if stats is not None else PipeStats()
    B, S = tokens.shape
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} "
                         "microbatches")
    model = pp.model
    dev = model.final_norm.scale.device
    dtype = model_lib._act_dtype(cfg)
    mb = B // n_microbatches
    tokens_m = torch.chunk(tokens, n_microbatches, dim=0)
    if cfg.tie_embeddings:
        alias = _Tied.apply(model.embed.tokens, n_microbatches)
        emb_in = [{"tokens": alias[2 * m]} for m in range(n_microbatches)]
        emb_out = [{"tokens": alias[2 * m + 1]}
                   for m in range(n_microbatches)]
    else:
        emb_in = [model.embed] * n_microbatches
        emb_out = [model.unembed] * n_microbatches
    positions = torch.arange(S, device=dev)[None, :]
    first = rank * len(pp.stages[rank])
    layers = pp.stages[rank]
    last = n_stages - 1
    anchor = torch.zeros((), device=dev, requires_grad=True)
    shape = (mb, S, cfg.d_model)
    outs, toks = [], []
    for m in range(n_microbatches):
        if rank == 0:           # stage 0 embeds microbatch m at tick m
            h, _, _ = model_lib._embed_inputs(
                cfg, types.SimpleNamespace(embed=emb_in[m]),
                {"tokens": tokens_m[m]})
            aux = torch.zeros((), dtype=torch.float32, device=dev)
        else:
            h, aux = _Recv.apply(anchor, shape, dtype, rank - 1, group,
                                 stats)
        h, aux = model_lib.apply_repeats(cfg, layers, first, h, aux,
                                        positions, None)
        if rank < last:
            toks.append(_Send.apply(h, aux, rank + 1, group, stats))
        else:
            outs.append((h, aux))
    shapes = [shape] * n_microbatches + [(n_microbatches,)]
    inputs = ([h for h, _ in outs] + [torch.stack([a for _, a in outs])]
              if rank == last else toks)
    *hidden, auxes = _Broadcast.apply(shapes, dtype, last, group, stats,
                                      *inputs)
    logits = torch.cat([unembed(emb_out[m], rmsnorm(model.final_norm, h,
                                                    cfg.norm_eps))
                        for m, h in enumerate(hidden)], dim=0)
    aux = auxes[0]
    for m in range(1, n_microbatches):
        aux = aux + auxes[m]
    # per-microbatch aux losses are means over equal-size microbatches;
    # their average is the full-batch mean the sequential model reports
    return logits, aux / n_microbatches


def pipeline_forward(cfg: ModelConfig, pp: PipelineParams, tokens,
                     n_microbatches: int = 1, group=None,
                     stats: PipeStats | None = None) -> torch.Tensor:
    """Pipelined forward on every rank of ``group``: logits (f32 over the
    padded vocabulary), each microbatch's equal to `model.forward`'s on
    it."""
    logits, _ = forward_with_aux(cfg, pp, tokens, n_microbatches, group,
                                 stats)
    return logits


def pipeline_loss(cfg: ModelConfig, pp: PipelineParams, batch,
                  n_microbatches: int = 1, group=None,
                  stats: PipeStats | None = None) -> torch.Tensor:
    """Pipelined training loss (CE + router aux) on every rank;
    ``loss.backward()`` on every rank runs the reverse schedule."""
    logits, aux = forward_with_aux(cfg, pp, batch["tokens"],
                                   n_microbatches, group, stats)
    return cross_entropy(logits, batch["labels"]) + cfg.router_aux_coef * aux
