"""Block registry: every architecture is a repeating pattern of these.

Types: attn (attention+MLP), moe (attention+MoE), xattn (self+cross+MLP,
whisper decoder), mamba, mlstm, slstm. Each type is a `ParamModule` with
``forward`` (the JAX package's apply), ``prefill``, ``decode`` and
``cache_init``, all taking the configuration first, as the JAX functions
do, so a caller can run the same weights under a changed configuration.
`block_apply`, `block_prefill`, `block_decode` and `block_cache_init`
dispatch by type.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.common import ParamModule, rmsnorm, rmsnorm_def
from repro_torch.models.mlp import mlp, mlp_def


def block_def(cfg: ModelConfig, btype: str) -> dict:
    if btype == "attn":
        return {"ln1": rmsnorm_def(cfg.d_model), "attn": attn.attn_def(cfg),
                "ln2": rmsnorm_def(cfg.d_model), "mlp": mlp_def(cfg)}
    if btype == "moe":
        return {"ln1": rmsnorm_def(cfg.d_model), "attn": attn.attn_def(cfg),
                "ln2": rmsnorm_def(cfg.d_model), "moe": moe_mod.moe_def(cfg)}
    if btype == "xattn":
        return {"ln1": rmsnorm_def(cfg.d_model), "attn": attn.attn_def(cfg),
                "lnx": rmsnorm_def(cfg.d_model),
                "xattn": attn.attn_def(cfg),
                "ln2": rmsnorm_def(cfg.d_model), "mlp": mlp_def(cfg)}
    if btype == "mamba":
        return {"ln1": rmsnorm_def(cfg.d_model), "mamba": ssm.mamba_def(cfg)}
    if btype == "mlstm":
        return {"ln1": rmsnorm_def(cfg.d_model),
                "mlstm": xlstm.mlstm_def(cfg)}
    if btype == "slstm":
        return {"ln1": rmsnorm_def(cfg.d_model),
                "slstm": xlstm.slstm_def(cfg)}
    raise ValueError(f"unknown block type {btype}")


class Block(ParamModule):
    """One layer's parameters, under `block_def`'s names."""
    btype = ""

    def __init__(self, cfg: ModelConfig):
        super().__init__(block_def(cfg, self.btype))


class AttnBlock(Block):
    """attn, and the base of moe and xattn: self-attention, then (xattn)
    cross-attention over the encoder, then the MLP or the MoE."""
    btype = "attn"

    def _ffn(self, cfg, x):
        if self.btype == "moe":
            return moe_mod.moe_ffn(cfg, self["moe"],
                                   rmsnorm(self["ln2"], x, cfg.norm_eps))
        return (mlp(self["mlp"], rmsnorm(self["ln2"], x, cfg.norm_eps)),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def forward(self, cfg: ModelConfig, x, *, positions=None,
                positions3=None, enc_out=None, causal=True):
        """Full-sequence apply. Returns (x, aux_loss)."""
        eps = cfg.norm_eps
        h = attn.attention_full(cfg, self["attn"],
                                rmsnorm(self["ln1"], x, eps), positions,
                                causal=causal, positions3=positions3)
        x = x + h.to(x.dtype)
        if self.btype == "xattn":
            h = attn.attention_full(cfg, self["xattn"],
                                    rmsnorm(self["lnx"], x, eps),
                                    positions, causal=False, kv_x=enc_out)
            x = x + h.to(x.dtype)
        h, aux = self._ffn(cfg, x)
        return x + h.to(x.dtype), aux

    def prefill(self, cfg: ModelConfig, x, *, positions=None,
                positions3=None, enc_out=None, s_max: int = 0,
                cache_dtype=torch.bfloat16):
        """Full-sequence apply that also emits the decode cache: the (k, v)
        of the S prefilled positions padded to s_max, in ``cache_dtype``."""
        eps = cfg.norm_eps
        S = x.shape[1]

        def pad_kv(k, v):
            pad = s_max - S
            k, v = k.to(cache_dtype), v.to(cache_dtype)
            if pad > 0:
                zeros = torch.zeros((k.shape[0], pad) + tuple(k.shape[2:]),
                                    dtype=cache_dtype, device=k.device)
                k = torch.cat([k, zeros], dim=1)
                v = torch.cat([v, zeros], dim=1)
            return attn.KVCache(k, v)

        h, (k, v) = attn.attention_full(cfg, self["attn"],
                                        rmsnorm(self["ln1"], x, eps),
                                        positions, causal=True,
                                        positions3=positions3,
                                        return_kv=True)
        x = x + h.to(x.dtype)
        cache = {"kv": pad_kv(k, v)}
        if self.btype == "xattn":
            h, (xk, xv) = attn.attention_full(cfg, self["xattn"],
                                              rmsnorm(self["lnx"], x, eps),
                                              positions, causal=False,
                                              kv_x=enc_out, return_kv=True)
            x = x + h.to(x.dtype)
            cache["xkv"] = attn.KVCache(xk.to(cache_dtype),
                                        xv.to(cache_dtype))
        h, _ = self._ffn(cfg, x)
        return x + h.to(x.dtype), cache

    def decode(self, cfg: ModelConfig, x, cache, index: int, *,
               positions3=None):
        """One-token decode. Returns (x, cache)."""
        eps = cfg.norm_eps
        h, kv = attn.attention_decode(cfg, self["attn"],
                                      rmsnorm(self["ln1"], x, eps),
                                      cache["kv"], index,
                                      positions3=positions3)
        x = x + h.to(x.dtype)
        new_cache = dict(cache)
        new_cache["kv"] = kv
        if self.btype == "xattn":
            h, _ = attn.attention_decode(cfg, self["xattn"],
                                         rmsnorm(self["lnx"], x, eps),
                                         cache["xkv"], index, cross=True)
            x = x + h.to(x.dtype)
        h, _ = self._ffn(cfg, x)
        return x + h.to(x.dtype), new_cache

    @classmethod
    def cache_init(cls, cfg: ModelConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16, device=None) -> dict:
        out = {"kv": attn.init_kv_cache(cfg, batch, s_max, dtype, device)}
        if cls.btype == "xattn":
            out["xkv"] = attn.init_kv_cache(cfg, batch, cfg.encoder_seq,
                                            dtype, device)
        return out


class MoeBlock(AttnBlock):
    btype = "moe"


class XattnBlock(AttnBlock):
    btype = "xattn"


class _StateBlock(Block):
    """mamba, mlstm, slstm: a norm, then one recurrent mixer whose decode
    cache is its state."""
    _fns: tuple = ()           # (apply, decode, init_cache)

    def _mixer(self):
        return self[self.btype]

    def forward(self, cfg: ModelConfig, x, *, positions=None,
                positions3=None, enc_out=None, causal=True):
        apply = self._fns[0]
        h = apply(cfg, self._mixer(), rmsnorm(self["ln1"], x, cfg.norm_eps))
        return (x + h.to(x.dtype),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def prefill(self, cfg: ModelConfig, x, *, positions=None,
                positions3=None, enc_out=None, s_max: int = 0,
                cache_dtype=torch.bfloat16):
        apply = self._fns[0]
        h, st = apply(cfg, self._mixer(),
                      rmsnorm(self["ln1"], x, cfg.norm_eps),
                      return_cache=True)
        return x + h.to(x.dtype), {"state": st}

    def decode(self, cfg: ModelConfig, x, cache, index: int, *,
               positions3=None):
        decode = self._fns[1]
        h, st = decode(cfg, self._mixer(),
                       rmsnorm(self["ln1"], x, cfg.norm_eps), cache["state"])
        return x + h.to(x.dtype), {"state": st}

    @classmethod
    def cache_init(cls, cfg: ModelConfig, batch: int, s_max: int,
                   dtype=torch.bfloat16, device=None) -> dict:
        return {"state": cls._fns[2](cfg, batch, dtype, device)}


class MambaBlock(_StateBlock):
    btype = "mamba"
    _fns = (ssm.mamba_apply, ssm.mamba_decode, ssm.mamba_init_cache)


class MlstmBlock(_StateBlock):
    btype = "mlstm"
    _fns = (xlstm.mlstm_apply, xlstm.mlstm_decode, xlstm.mlstm_init_cache)


class SlstmBlock(_StateBlock):
    btype = "slstm"
    _fns = (xlstm.slstm_apply, xlstm.slstm_decode, xlstm.slstm_init_cache)


BLOCKS = {c.btype: c for c in (AttnBlock, MoeBlock, XattnBlock, MambaBlock,
                               MlstmBlock, SlstmBlock)}


def _block(btype: str) -> type:
    if btype not in BLOCKS:
        raise ValueError(f"unknown block type {btype}")
    return BLOCKS[btype]


def make_block(cfg: ModelConfig, btype: str) -> Block:
    return _block(btype)(cfg)


def block_apply(cfg: ModelConfig, btype: str, p: Block, x, **kw):
    """Full-sequence apply. Returns (x, aux_loss)."""
    return _block(btype).forward(p, cfg, x, **kw)


def block_prefill(cfg: ModelConfig, btype: str, p: Block, x, **kw):
    """Full-sequence apply that also emits the decode cache."""
    return _block(btype).prefill(p, cfg, x, **kw)


def block_decode(cfg: ModelConfig, btype: str, p: Block, x, cache, index,
                 *, positions3=None):
    """One-token decode. Returns (x, new_cache)."""
    return _block(btype).decode(p, cfg, x, cache, index,
                                positions3=positions3)


def block_cache_init(cfg: ModelConfig, btype: str, batch: int, s_max: int,
                     dtype=torch.bfloat16, device=None) -> Any:
    return _block(btype).cache_init(cfg, batch, s_max, dtype, device)
