"""Each layer's backward in the port against the JAX package's, alone on
the JAX layer's input and a seeded cotangent (CPU), for the stacks whose
chained gradients amplify float32 rounding (whisper, xlstm, zamba2: see
`GRAD_CHAIN_REL` in `test_torch_train.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import blocks as jblk
from repro.models import common as jc
from repro.models import model as jM
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import blocks as tblk
from repro_torch.models import model as tM
from torch_lm import (GRAD_CHAIN_REL, assert_close_to_max, carried_train,
                      paths, train_batches)

LAYER_GRAD_REL = 1e-5   # max|port - JAX| / max|JAX| per gradient


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_vjp(jfn):
    """``(params, args, cotangent) -> gradients`` of ``jfn``, jitted."""
    def run(q, args, ct):
        return jax.vjp(jfn, q, *args)[1](ct)
    return jax.jit(run)


def _check_vjp(label, jvjp, jparams, jargs, tfn, layer):
    """One layer's VJP in both packages on the same inputs and a seeded
    cotangent: every parameter's and every input's gradient within
    LAYER_GRAD_REL of the JAX gradient's max."""
    ct = np.random.default_rng(3).standard_normal(jargs[0].shape).astype(
        np.float32)
    want = jvjp(jparams, jargs, jnp.asarray(ct))
    layer.requires_grad_(True)
    xs = [_t(a).requires_grad_(True) for a in jargs]
    names = [n for n, _ in layer.named_parameters()]
    got = torch.autograd.grad(
        tfn(layer, *xs), [p for _, p in layer.named_parameters()] + xs,
        _t(ct))
    wp = paths(want[0])
    for name, g in zip(names, got):
        assert_close_to_max(g, wp[name], LAYER_GRAD_REL, f"{label} {name}")
    for i, g in enumerate(got[len(names):]):
        assert_close_to_max(g, want[1 + i], LAYER_GRAD_REL,
                            f"{label} input {i}")


@pytest.mark.parametrize("arch", sorted(GRAD_CHAIN_REL))
def test_layer_vjps_match_jax(arch):
    """Each layer of the stacks whose chained gradients amplify rounding
    (whisper's encoder and decoder, xlstm, zamba2), its backward alone on
    the JAX layer's input."""
    cfg_j, cfg_t = jreduced(arch), treduced(arch)
    params, model = carried_train(cfg_j, cfg_t)
    jb, _ = train_batches(cfg_j, cfg_t)
    enc = None
    if cfg_j.is_encdec:
        x = jb["frames"] + jM._sinusoidal(cfg_j.encoder_seq, cfg_j.d_model,
                                          jnp.float32)[None]
        pos = jnp.arange(cfg_j.encoder_seq)[None]

        def jenc(q, x):
            return jblk.block_apply(cfg_j, "attn", q, x, positions=pos,
                                    causal=False)[0]

        def tenc(m, x):
            return tblk.block_apply(cfg_t, "attn", m, x, positions=_t(pos),
                                    causal=False)[0]
        jvjp = _jax_vjp(jenc)
        for r, p in enumerate(model.enc_layers):
            jp = jax.tree.map(lambda a: a[r], params["enc_blocks"])
            _check_vjp(f"encoder {r}", jvjp, jp, (x,), tenc, p)
            x = jenc(jp, x)
        enc = jc.rmsnorm(params["enc_norm"], x, cfg_j.norm_eps)
    x, pos, _ = jM._embed_inputs(cfg_j, params, jb)
    plen = len(cfg_j.block_pattern)
    jitted = {}
    for i, (bt, p) in enumerate(zip(tM._block_types(cfg_t), model.layers)):
        jp = jax.tree.map(lambda a: a[i // plen],
                          params[f"blocks_{i % plen}"])
        args = (x,) if enc is None else (x, enc)

        def jfn(q, x, e=None, bt=bt):
            return jblk.block_apply(cfg_j, bt, q, x, positions=pos,
                                    enc_out=e)[0]

        def tfn(m, x, e=None, bt=bt):
            return tblk.block_apply(cfg_t, bt, m, x, positions=_t(pos),
                                    enc_out=e)[0]
        if bt not in jitted:
            jitted[bt] = (_jax_vjp(jfn), jax.jit(jfn))
        _check_vjp(f"layer {i} ({bt})", jitted[bt][0], jp, args, tfn, p)
        x = jitted[bt][1](jp, *args)




