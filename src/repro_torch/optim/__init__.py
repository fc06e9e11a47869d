"""Optimizers and gradient compression over the JAX parameter leaves."""
from repro_torch.optim import compress
from repro_torch.optim.optimizers import (Adafactor, AdamW, get_optimizer,
                                          warmup_cosine)

__all__ = ["AdamW", "Adafactor", "get_optimizer", "warmup_cosine",
           "compress"]
