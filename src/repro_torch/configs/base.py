"""Model/config system: one frozen dataclass per architecture.

Every architecture is expressed as a repeating ``block_pattern`` (e.g.
8×mamba + 1×attn for zamba2); the layers cycle through it.

The dataclasses equal the JAX package's field by field. The training and
mesh fields (``remat``, ``remat_policy``, ``scan_unroll``, ``grad_accum``,
``opt_update_chunks``, ``loss_seq_chunk``, ``moe_ep_axis``) stay so that
configurations compare equal; the port's forward, prefill and decode
ignore them (no remat, no scan, one device).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "audio", "ssm", "vlm", "moe", "hybrid"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    use_rope: bool = True              # False -> absolute sinusoidal (whisper)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # block structure: repeating pattern, cycled to n_layers
    block_pattern: tuple[str, ...] = ("attn",)

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_alto_dispatch: bool = True     # ALTO-linearized sorted dispatch
    moe_ep_axis: str = "model"         # model | data (see models/moe.py)

    # SSM / recurrent
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0

    # encoder-decoder (audio family)
    encoder_layers: int = 0
    encoder_seq: int = 1500            # whisper 30 s of 10 ms frames / 2

    # vlm
    mrope: bool = False
    mrope_sections: tuple[int, ...] = (16, 24, 24)  # t/h/w head_dim halves
    vision_prefix: int = 256           # stubbed patch-embedding positions

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"      # nothing | dots (save matmul outs;
                                       # trades scan-carried memory for
                                       # less recompute — per-cell choice)
    opt_update_chunks: int = 1         # >1: sequence optimizer leaf updates
    loss_seq_chunk: int = 0            # >0: CE over seq chunks (never
                                       # materializes full (B,S,V) logits)
    scan_unroll: bool = False          # unroll scans (cost-calibration runs)
    attn_chunk: int = 1024             # query-chunked attention block
    optimizer: str = "adamw"           # adamw | adafactor
    grad_accum: int = 1                # microbatch accumulation steps

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not a multiple of "
                f"pattern {self.block_pattern}")

    # vocab padding: embedding/unembed tables round up so the vocab axis
    # shards over the model axis (granite's 49155 / whisper's 51865 would
    # otherwise replicate the logits across all TP ranks)
    vocab_pad_to: int = 128

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (SSM/hybrid state recurrence)."""
        return any(b in ("mamba", "mlstm", "slstm")
                   for b in self.block_pattern)

    def layer_types(self) -> list[str]:
        return [self.block_pattern[i % len(self.block_pattern)]
                for i in range(self.n_layers)]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the assigned shapes)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> list[ShapeConfig]:
    """The shape cells an architecture runs (long_500k only where the
    architecture is sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out
