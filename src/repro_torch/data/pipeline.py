"""Deterministic, restart-safe synthetic token pipeline.

Every batch is a pure function of (seed, step), drawn with numpy as the
JAX package draws it, so the port's tokens, labels, frames, patch
embeddings and 3-D positions equal the JAX package's bit for bit:
  * skip-to-step restart is exact (after a restore the pipeline resumes
    at `state.step` with identical data);
  * no host state needs checkpointing beyond the integer cursor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataState:
    seed: int
    step: int


def make_batch(cfg: ModelConfig, B: int, S: int, seed: int, step: int,
               device=None) -> dict:
    """Global batch for (seed, step), as tensors on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipf-ish unigram stream: realistic token frequency skew
    z = rng.zipf(1.3, size=(B, S + 1))
    tokens_full = ((z - 1) % cfg.vocab_size).astype(np.int32)
    batch = {"tokens": tokens_full[:, :S], "labels": tokens_full[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        vis = cfg.vision_prefix
        batch["tokens"] = batch["tokens"][:, :S - vis]
        batch["patch_embeds"] = rng.standard_normal(
            (B, vis, cfg.d_model)).astype(np.float32)
        batch["positions3"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S))
        batch["labels"] = np.concatenate(
            [np.full((B, vis), -1, np.int32), batch["labels"][:, :S - vis]],
            axis=1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


class TokenPipeline:
    """Iterator with an explicit, checkpointable cursor."""

    def __init__(self, cfg: ModelConfig, B: int, S: int, seed: int = 0,
                 start_step: int = 0, device=None):
        self.cfg, self.B, self.S = cfg, B, S
        self.device = resolve_device(device)
        self.state = DataState(seed=seed, step=start_step)

    def __next__(self):
        batch = make_batch(self.cfg, self.B, self.S, self.state.seed,
                           self.state.step, self.device)
        self.state.step += 1
        return batch

    def __iter__(self):
        return self

    def skip_to(self, step: int):
        self.state.step = step
