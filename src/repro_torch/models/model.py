"""Model assembly: embedding → block stack → norm → logits.

`Model` holds the embedding, one block per layer in ``cfg.layer_types()``
order (xattn for an encoder-decoder's decoder), the final norm, the
unembedding unless tied, and whisper's encoder blocks with ``enc_norm``.
The module-level functions take the model where the JAX package takes
``params``, and the configuration beside it.

The JAX package scans over ``n_repeats`` stacked copies of the block
pattern, under remat and jit; here the depth is a Python loop over the
layers, run eagerly. Layer ``r · len(block_pattern) + pos`` is the JAX
package's ``blocks_{pos}`` leaf ``r``; `jax_leaves` groups the layers'
parameters into those stacked leaves, which the optimizers and the
gradient compressors work on. With grad enabled and ``cfg.remat``, each
repeat of the pattern (and each encoder layer) runs under
`torch.utils.checkpoint`, as the JAX package wraps them in
`jax.checkpoint`. Caches are lists with one entry per layer.

Families: dense/moe/ssm/hybrid decoder-only LMs; vlm (stub patch-embedding
prefix + M-RoPE positions); audio (whisper-style encoder-decoder with stub
frame embeddings).
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models import sharding as shd
from repro_torch.models.common import (ParamDef, ParamModule, embed,
                                       def_paths, embed_def, is_def,
                                       materialize, n_params, named_defs,
                                       rmsnorm, rmsnorm_def, unembed)

Tree = Any


def _block_types(cfg: ModelConfig) -> list[str]:
    """Each decoder layer's block type (attn becomes xattn in an
    encoder-decoder)."""
    return ["xattn" if (cfg.is_encdec and b == "attn") else b
            for b in cfg.layer_types()]


def _stack_defs(defs: Tree, n: int) -> Tree:
    if is_def(defs):
        return ParamDef((n,) + defs.shape, ("layers",) + defs.logical,
                        init=defs.init, axis=defs.axis)
    return {k: _stack_defs(v, n) for k, v in defs.items()}


def _unembed_def(cfg: ModelConfig) -> Tree:
    return {"tokens": ParamDef((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "fsdp"), init="normal")}


def model_def(cfg: ModelConfig) -> Tree:
    """The JAX package's parameter tree: ``blocks_{pos}`` leaves stacked
    over ``n_repeats`` (what `interop.lm_params` carries in)."""
    d: dict = {"embed": embed_def(cfg.padded_vocab, cfg.d_model),
               "final_norm": rmsnorm_def(cfg.d_model)}
    if not cfg.tie_embeddings:
        d["unembed"] = _unembed_def(cfg)
    for pos, btype in enumerate(cfg.block_pattern):
        bt = "xattn" if (cfg.is_encdec and btype == "attn") else btype
        d[f"blocks_{pos}"] = _stack_defs(blk.block_def(cfg, bt),
                                         cfg.n_repeats)
    if cfg.is_encdec:
        d["enc_blocks"] = _stack_defs(blk.block_def(cfg, "attn"),
                                      cfg.encoder_layers)
        d["enc_norm"] = rmsnorm_def(cfg.d_model)
    return d


class Model(nn.Module):
    """The parameters of one architecture, created empty on ``meta``: fill
    them with ``load_state_dict(..., assign=True)``, as `init_model` and
    `interop.lm_params` do."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = ParamModule(embed_def(cfg.padded_vocab, cfg.d_model))
        self.layers = nn.ModuleList(blk.make_block(cfg, bt)
                                    for bt in _block_types(cfg))
        self.final_norm = ParamModule(rmsnorm_def(cfg.d_model))
        if not cfg.tie_embeddings:
            self.unembed = ParamModule(_unembed_def(cfg))
        if cfg.is_encdec:
            self.enc_layers = nn.ModuleList(
                blk.make_block(cfg, "attn")
                for _ in range(cfg.encoder_layers))
            self.enc_norm = ParamModule(rmsnorm_def(cfg.d_model))

    def forward(self, batch):
        return forward(self.cfg, self, batch)


class Leaf(NamedTuple):
    """One leaf of the JAX package's parameter tree: its dotted path in
    `model_def`, the port's parameters that make it up (one a repeat for
    a stacked leaf, in repeat order) and whether it is stacked."""
    name: str
    params: list
    stacked: bool


def jax_leaves(model: Model) -> list[Leaf]:
    """The JAX package's parameter leaves in `jax.tree.flatten` order
    (sorted keys). ``blocks_{pos}`` lists its ``n_repeats`` layers,
    ``enc_blocks`` the encoder's layers; every other leaf one tensor."""
    cfg = model.cfg
    plen = len(cfg.block_pattern)
    out = []
    for path in def_paths(model_def(cfg)):
        top, _, rest = path.partition(".")
        if top.startswith("blocks_"):
            pos = int(top[len("blocks_"):])
            layers = [model.layers[r * plen + pos]
                      for r in range(cfg.n_repeats)]
        elif top == "enc_blocks":
            layers = list(model.enc_layers)
        else:
            out.append(Leaf(path, [model.get_parameter(path)], False))
            continue
        out.append(Leaf(path, [m.get_parameter(rest) for m in layers], True))
    return out


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of matmuls without batch
    dimensions (``mm``, ``addmm``, and the one-batch ``bmm`` that
    `torch.einsum` makes of a contraction without batch axes), recompute
    the rest, as JAX's ``dots_with_no_batch_dims_saveable``."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, *args, dots: bool = False):
    """``fn(*args)``, under `torch.utils.checkpoint` when grad is enabled:
    its activations are recomputed in the backward (``dots``: but for the
    matmuls `_save_dots` keeps). Changes memory, never values."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if dots:
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> Model:
    """A model with weights drawn by `materialize` on ``device`` (default
    ``cuda``) from ``generator``, which must live there; bf16 unless the
    configuration says float32."""
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    model = Model(cfg)
    model.load_state_dict(materialize(named_defs(model), generator, dtype,
                                      device), assign=True)
    return model


def _sinusoidal(S: int, D: int, dtype, device) -> torch.Tensor:
    """The absolute position table, built in float64 and then cast (the
    prefill's; decode builds its row in float32, as the JAX package does)."""
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / D)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def _encoder(cfg: ModelConfig, model: Model, frames):
    """Whisper-style encoder over stub frame embeddings (B, S_enc, D)."""
    B, S, D = frames.shape
    x = frames + _sinusoidal(S, D, frames.dtype, frames.device)[None]
    x = shd.act(x, ("batch", None, None))
    positions = torch.arange(S, device=x.device)[None, :]

    def layer(p, x):
        return blk.block_apply(cfg, "attn", p, x, positions=positions,
                               causal=False)[0]

    for p in model.enc_layers:
        x = (remat(functools.partial(layer, p), x) if cfg.remat
             else layer(p, x))
    return rmsnorm(model.enc_norm, x, cfg.norm_eps)


def _act_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _embed_inputs(cfg: ModelConfig, model: Model, batch):
    """Token / multimodal embedding. Returns x, positions, positions3."""
    x = embed(model.embed, batch["tokens"]).to(_act_dtype(cfg))
    positions3 = batch.get("positions3")
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    if not cfg.use_rope:
        x = x + _sinusoidal(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = shd.act(x, ("batch", None, None))
    return x, positions, positions3


def forward_hidden(cfg: ModelConfig, model: Model, batch):
    """Forward up to the final norm: returns (hidden (B,S,D), aux_loss)."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encoder(cfg, model, batch["frames"])
    x, positions, positions3 = _embed_inputs(cfg, model, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = apply_repeats(cfg, model.layers, 0, x, aux, positions,
                           positions3, enc_out)
    return rmsnorm(model.final_norm, x, cfg.norm_eps), aux


def apply_repeats(cfg: ModelConfig, layers, first: int, x, aux, positions,
                  positions3, enc_out=None):
    """Apply ``layers`` (whole repeats of the pattern; ``first`` the index
    of the first in the model's stack): a repeat a checkpoint under remat,
    the aux loss summed layer by layer. `forward_hidden` runs it over the
    whole stack, the pipeline over one stage."""
    types, plen = _block_types(cfg), len(cfg.block_pattern)

    def repeat(r, x, aux):
        for i in range(r * plen, (r + 1) * plen):
            x, a = blk.block_apply(cfg, types[first + i], layers[i], x,
                                   positions=positions,
                                   positions3=positions3, enc_out=enc_out)
            aux = aux + a
        return x, aux

    for r in range(len(layers) // plen):
        if cfg.remat:
            x, aux = remat(functools.partial(repeat, r), x, aux,
                           dots=cfg.remat_policy != "nothing")
        else:
            x, aux = repeat(r, x, aux)
    return x, aux


def unembed_params(cfg: ModelConfig, model: Model):
    return model.embed if cfg.tie_embeddings else model.unembed


def forward(cfg: ModelConfig, model: Model, batch):
    """Training/scoring forward: returns (logits f32 over the padded
    vocabulary, aux_loss)."""
    x, aux = forward_hidden(cfg, model, batch)
    logits = unembed(unembed_params(cfg, model), x)
    return shd.act(logits, ("batch", None, "vocab")), aux


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> list:
    """One empty decode cache per layer on ``device`` (default ``cuda``;
    ``meta`` gives the dry run's input stand-in, no allocation)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    return [blk.block_cache_init(cfg, bt, batch, s_max, dtype, dev)
            for bt in _block_types(cfg)]


def prefill(cfg: ModelConfig, model: Model, batch, s_max: int,
            cache_dtype=torch.bfloat16):
    """Run the full prompt; returns (last-position logits, cache)."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = _encoder(cfg, model, batch["frames"])
    x, positions, positions3 = _embed_inputs(cfg, model, batch)
    caches = []
    for bt, p in zip(_block_types(cfg), model.layers):
        x, c = blk.block_prefill(cfg, bt, p, x, positions=positions,
                                 positions3=positions3, enc_out=enc_out,
                                 s_max=s_max, cache_dtype=cache_dtype)
        caches.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = unembed(unembed_params(cfg, model), x[:, -1:])
    return logits[:, 0, :cfg.vocab_size], caches


def decode_step(cfg: ModelConfig, model: Model, tokens, cache, index: int,
                positions3=None):
    """One-token serve step. tokens: (B, 1). Returns (logits, new cache);
    the attention caches are updated in place."""
    x = embed(model.embed, tokens).to(_act_dtype(cfg))
    if not cfg.use_rope:                  # absolute position at `index`
        D = cfg.d_model
        i = torch.arange(D // 2, dtype=torch.float32, device=x.device)
        ang = torch.tensor(index, dtype=torch.float32, device=x.device) \
            / torch.pow(torch.tensor(10000.0, device=x.device), 2 * i / D)
        pe = torch.cat([torch.sin(ang), torch.cos(ang)])
        x = x + pe[None, None, :].to(x.dtype)
    x = shd.act(x, ("batch", None, None))
    new_cache = []
    for bt, p, c in zip(_block_types(cfg), model.layers, cache):
        x, c = blk.block_decode(cfg, bt, p, x, c, index,
                                positions3=positions3)
        new_cache.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    logits = unembed(unembed_params(cfg, model), x)
    logits = shd.act(logits, ("batch", None, "vocab"))
    # drop vocab padding at the (tiny) decode output
    return logits[:, 0, :cfg.vocab_size], new_cache


def count_params(cfg: ModelConfig) -> int:
    return n_params(model_def(cfg))


def count_active_params(cfg: ModelConfig) -> int:
    """Active per-token parameters (MoE: only routed experts count)."""
    total = count_params(cfg)
    if cfg.n_experts == 0:
        return total
    expert_params = 3 * cfg.d_model * cfg.d_expert     # gate/up/down
    inactive = (cfg.n_experts - cfg.experts_per_token) * expert_params
    n_moe_layers = sum(1 for b in cfg.layer_types() if b == "moe")
    return total - n_moe_layers * inactive
