#!/usr/bin/env python3
"""The JAX package's own decode consistency at full width, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/lm_decode_witness.py \
        [--arch smollm-360m] [--layers 2 8 16] [--dtype float32]

For the architecture at its published width, cut to each depth given, on
weights from ``PRNGKey(0)`` and the batch of `chip_smoke.py`'s LM check
(2 rows of 64 tokens, ``make_batch`` seed 0, step 1), prints the check of
``tests/test_archs_smoke.py::test_decode_consistency``: ``prefill(S-1)``
plus one ``decode_step`` against ``forward`` at ``S-2`` and ``S-1``,
``max|Δ| / max|forward|``. Beside it, the relative change of the forward
logits when every weight is moved by about one unit in its last place
(multiplied by ``1 ± eps`` of its dtype, the sign drawn from a seed).
Both read how far the reference itself amplifies last-bit differences
with depth; no device rate is measured.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.data.pipeline import make_batch
from repro.models import model as M
from repro.models.common import materialize

B, S = 2, 64


def witness(arch: str, layers: int, dtype: str) -> dict:
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype)
    wdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = materialize(M.model_def(cfg), jax.random.PRNGKey(0), wdt)
    batch = make_batch(cfg, B, S, 0, 1)
    batch.pop("labels")
    fwd = jax.jit(lambda p, b: M.forward(cfg, p, b)[0])
    full = fwd(params, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    lg_pre, cache = jax.jit(lambda p, b: M.prefill(
        cfg, p, b, s_max=S, cache_dtype=wdt))(params, pre)
    lg_dec, _ = jax.jit(lambda p, t, c: M.decode_step(cfg, p, t, c, S - 1))(
        params, batch["tokens"][:, S - 1:], cache)
    V = cfg.vocab_size
    scale = float(jnp.max(jnp.abs(full)))
    out = {"arch": arch, "layers": layers, "dtype": dtype,
           "prefill": float(jnp.max(jnp.abs(lg_pre - full[:, S - 2, :V])))
           / scale,
           "decode": float(jnp.max(jnp.abs(lg_dec - full[:, S - 1, :V])))
           / scale}
    eps = float(jnp.finfo(wdt).eps)
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(100), len(leaves))
    moved = jax.tree.unflatten(tree, [
        w * (1 + eps * jax.random.rademacher(k, w.shape, w.dtype))
        for w, k in zip(leaves, keys)])
    out["one_ulp"] = float(jnp.max(jnp.abs(fwd(moved, batch) - full))) \
        / scale
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 8, 16])
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args(argv)
    for n in args.layers:
        print(json.dumps(witness(args.arch, n, args.dtype)), flush=True)


if __name__ == "__main__":
    main()
