"""Gradient compression, applied to the gradients before clipping and the
optimizer (the JAX package's `optim/compress.py`).

  * bf16: cast the gradients to bfloat16;
  * int8 with error feedback: symmetric int8 quantization with one scale
    a leaf, the residual carried to the next step in a bfloat16 error
    state, so the compression bias vanishes over steps.

Gradients are a list per leaf of the JAX parameter tree (one tensor a
layer for a stacked leaf, in the order of `models.model.jax_leaves` and
the optimizer's groups). The scale is taken over the whole JAX leaf,
every repeat of a stacked one, and the error state has the stacked
leaf's shape: the port compresses what the JAX package compresses.
``torch.round`` rounds half to even, as ``jnp.round`` does. Two steps
follow what XLA compiles the JAX formula into, so the values are the
JAX package's bit for bit: ``max|x| / 127`` is a multiplication by the
float32 reciprocal of 127, and the new error is the exact residual
``x - q·scale`` rounded once to float32 (a fused multiply-add), then to
bfloat16.
"""
from __future__ import annotations

import torch


def bf16_compress(grads: list) -> list:
    return [[g.to(torch.bfloat16) for g in leaf] for leaf in grads]


def init_error_feedback(leaves) -> list:
    """A bfloat16 zero error state for each leaf (`jax_leaves`), shaped
    like the stacked leaf."""
    out = []
    for leaf in leaves:
        p = leaf.params[0]
        shape = ((len(leaf.params),) if leaf.stacked else ()) \
            + tuple(p.shape)
        out.append(torch.zeros(shape, dtype=torch.bfloat16,
                               device=p.device))
    return out


def _quantize(gs: list, errs: list) -> tuple[list, list]:
    """Quantize the pieces of one leaf (``gs[i] + errs[i]``) to int8 under
    one scale, ``max|g + err| / 127`` over all the pieces; returns the
    dequantized pieces (float32) and the new errors (bfloat16)."""
    amax = None
    for g, e in zip(gs, errs):      # first pass: the leaf's max only
        a = torch.max(torch.abs(g.float() + e.float()))
        amax = a if amax is None else torch.maximum(amax, a)
    scale = torch.clamp_min(amax, 1e-12) * (1.0 / 127.0)
    deq, new_err = [], []
    for g, e in zip(gs, errs):
        x = g.float() + e.float()
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        deq.append(q.float() * scale)
        residual = x.double() - q.double() * scale.double()  # exact
        new_err.append(residual.float().to(torch.bfloat16))
    return deq, new_err


def int8_compress_decompress(g: torch.Tensor, err: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``g + err`` to int8; returns (dequantized, new error)."""
    deq, new_err = _quantize([g], [err])
    return deq[0], new_err[0]


def int8_with_error_feedback(grads: list, err_state: list
                             ) -> tuple[list, list]:
    """Each leaf quantized under its own scale; a stacked leaf's layers
    are the error state's slices along its first axis."""
    out, new_state = [], []
    for gs, err in zip(grads, err_state):
        stacked = err.dim() > gs[0].dim()
        deq, new_err = _quantize(gs, list(err) if stacked else [err])
        out.append(deq)
        new_state.append(torch.stack(new_err) if stacked else new_err[0])
    return out, new_state
