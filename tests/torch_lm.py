"""Helpers of the LM-stack parity tests (not collected): draw parameters
with the JAX package, hand them to the port as numpy, compare."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as jreduced
from repro.data.pipeline import make_batch as jmake
from repro.models import blocks as jblk
from repro.models import common as jc
from repro.models import model as jM
from repro.models.common import materialize as jmaterialize
from repro_torch import interop
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import make_batch as tmake
from repro_torch.models import blocks as tblk
from repro_torch.models import common as tcm
from repro_torch.models import model as tM

LOGITS_REL = 1e-4            # max|port - JAX| / max|JAX| for logits
BF16_CACHE_REL = 2.0 ** -8   # decode logits over bf16 caches (one ulp)
LAYER_REL = 1e-5             # one layer on the JAX layer's input
# Two stacks amplify float32 rounding through their layers (each layer
# alone holds LAYER_REL): whisper's attention is near one-hot (logits to
# ~75) over 6 encoder and 2 decoder layers, xlstm has 16 recurrent
# layers. Their chained logits and states, measured over seeds 0-5 of
# `carried`: whisper 6.4e-5 to 6.5e-4, xlstm 4.4e-4 to 3.5e-3 of max|JAX|.
CHAIN_REL = {"whisper-base": 5e-3, "xlstm-1.3b": 1e-2}
B, S, STEPS = 2, 16, 3


def jax_params(defs, seed=0):
    """The JAX package's parameters for ``defs`` as a numpy tree."""
    return jax.tree.map(np.asarray,
                        jmaterialize(defs, jax.random.PRNGKey(seed)))


def perturb(tree, rng, scale=0.1):
    """Every leaf plus seeded noise (zero-init biases, unit norms and the
    like would hide a wrong index)."""
    return jax.tree.map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(a.dtype),
        tree)


def to_torch(tree):
    """A numpy tree as nested dicts of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def np_of(x):
    """A torch or JAX array as float64 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def assert_close_to_max(got, want, rel, label=""):
    """max|got - want| <= rel · max|want| (shapes equal)."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    assert np.isfinite(g).all(), label
    scale = float(np.abs(w).max()) if w.size else 0.0
    err = float(np.abs(g - w).max()) if w.size else 0.0
    assert err <= rel * scale, (label, err, scale)


def bf16_ulp(x):
    """One bfloat16 ulp at each |x| (7 stored mantissa bits)."""
    a = np.maximum(np.abs(np_of(x)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulp(got, want, rel, label=""):
    """Each element within one bf16 ulp of its own value plus ``rel ·
    max|want|`` (the float32 values before the rounding agree that far)."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, (label, g.shape, w.shape)
    bound = bf16_ulp(w) + rel * (float(np.abs(w).max()) if w.size else 0.0)
    assert (np.abs(g - w) <= bound).all(), (
        label, float(np.abs(g - w).max()))


# ---------------------------------------------------------------------
# whole models on carried weights (`interop.lm_params`)
# ---------------------------------------------------------------------

def carried(arch, seed=0):
    """(JAX config, port config, JAX params, port model) for the reduced
    float32 ``arch``, the port holding the JAX package's weights."""
    cfg_j, cfg_t = jreduced(arch), treduced(arch)
    tree = perturb(jax_params(jM.model_def(cfg_j), seed),
                   np.random.default_rng(seed), 0.02)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            interop.lm_params(cfg_t, tree, device="cpu"))


def batches(cfg_j, cfg_t, B, S, seed=0):
    """The same synthetic batch from each package's `make_batch`, labels
    dropped."""
    jb = jmake(cfg_j, B, S, seed, 0)
    tb = tmake(cfg_t, B, S, seed, 0, device="cpu")
    jb.pop("labels")
    tb.pop("labels")
    return jb, tb


def cache_leaves(jcache, tcache, cfg):
    """(label, JAX leaf, port leaf) for every cache leaf: the JAX cache is
    stacked per pattern position, the port's a list per layer."""
    plen = len(cfg.block_pattern)
    for i, layer in enumerate(tcache):
        pos, r = i % plen, i // plen
        for key, val in layer.items():
            jval = jcache[pos][key]
            for name, g in zip(val._fields, val):
                yield f"layer {i} {key}.{name}", getattr(jval, name)[r], g


def assert_caches(jcache, tcache, cfg, rel):
    """float32 leaves within ``rel · max|JAX leaf|``, bf16 leaves within
    one bf16 ulp more, dtypes equal."""
    for label, w, g in cache_leaves(jcache, tcache, cfg):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), label
        if g.dtype == torch.bfloat16:
            assert_within_bf16_ulp(g, w, rel, label)
        else:
            assert_close_to_max(g, w, rel, label)


def port_cache(jcache, tcache, cfg):
    """The JAX cache's values in the port's layout (``tcache`` gives the
    types): each decode step is then held from the same state, so a bf16
    cache entry that rounded the other way in an earlier step (one ulp,
    2**-8 relative) does not carry into the next step's bound."""
    leaves = {label: torch.from_numpy(np.array(w.astype(np.float32)))
              for label, w, _ in cache_leaves(jcache, tcache, cfg)}
    return [{key: type(val)(*(leaves[f"layer {i} {key}.{name}"].to(g.dtype)
                              for name, g in zip(val._fields, val)))
             for key, val in layer.items()}
            for i, layer in enumerate(tcache)]


def check_layers(arch):
    """Every layer (the encoder's too) on the JAX layer's input: its output
    within LAYER_REL · max|JAX output|, and the final logits from the JAX
    final hidden state within LOGITS_REL."""
    cfg_j, cfg_t, params, model = carried(arch)
    jb, tb = batches(cfg_j, cfg_t, B, S)
    enc = None
    if cfg_j.is_encdec:
        x = jb["frames"] + jM._sinusoidal(cfg_j.encoder_seq, cfg_j.d_model,
                                          jnp.float32)[None]
        pos = jnp.arange(cfg_j.encoder_seq)[None]
        for r, p in enumerate(model.enc_layers):
            jp = jax.tree.map(lambda a: a[r], params["enc_blocks"])
            want, _ = jblk.block_apply(cfg_j, "attn", jp, x, positions=pos,
                                       causal=False)
            got, _ = tblk.block_apply(cfg_t, "attn", p, _t(x),
                                      positions=_t(pos), causal=False)
            assert_close_to_max(got, want, LAYER_REL, f"encoder {r}")
            x = want
        enc = jc.rmsnorm(params["enc_norm"], x, cfg_j.norm_eps)
    x, pos, pos3 = jM._embed_inputs(cfg_j, params, jb)
    plen = len(cfg_j.block_pattern)
    jitted = {}
    for i, (bt, p) in enumerate(zip(tM._block_types(cfg_t), model.layers)):
        jp = jax.tree.map(lambda a: a[i // plen],
                          params[f"blocks_{i % plen}"])
        if bt not in jitted:
            jitted[bt] = jax.jit(
                lambda p, x, bt=bt: jblk.block_apply(
                    cfg_j, bt, p, x, positions=pos, positions3=pos3,
                    enc_out=enc))
        want, _ = jitted[bt](jp, x)
        got, _ = tblk.block_apply(
            cfg_t, bt, p, _t(x), positions=_t(pos),
            positions3=None if pos3 is None else _t(pos3),
            enc_out=None if enc is None else _t(enc))
        assert_close_to_max(got, want, LAYER_REL, f"layer {i} ({bt})")
        x = want
    x = jc.rmsnorm(params["final_norm"], x, cfg_j.norm_eps)
    emb = jM.unembed_params(cfg_j, params)
    assert_close_to_max(
        tcm.unembed(tM.unembed_params(cfg_t, model), _t(x)),
        jc.unembed(emb, x), LOGITS_REL, "unembed")


def _t(x):
    return torch.from_numpy(np.array(x))


def check_model(arch):
    """`forward` logits and aux, then `check_prefill_decode` under float32
    and bf16 caches, on the JAX package's weights; the chain is held to
    LOGITS_REL, or to CHAIN_REL where the stack amplifies rounding."""
    rel = CHAIN_REL.get(arch, LOGITS_REL)
    cfg_j, cfg_t, params, model = carried(arch)
    jb, tb = batches(cfg_j, cfg_t, B, S)
    want, waux = jax.jit(lambda p, b: jM.forward(cfg_j, p, b))(params, jb)
    got, gaux = tM.forward(cfg_t, model, tb)
    assert_close_to_max(got, want, rel, "forward")
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5,
                               atol=1e-6)
    for cache_dtype in ("float32", "bfloat16"):
        check_prefill_decode(cfg_j, cfg_t, params, model, jb, tb,
                             cache_dtype, rel)


def check_prefill_decode(cfg_j, cfg_t, params, model, jb, tb, cache_dtype,
                         rel):
    """`prefill` then STEPS `decode_step`s, each from the JAX state. With
    float32 caches the logits hold ``rel``; with the default bf16 caches a
    key or value written this step may round the other way (one bf16 ulp,
    2**-8 relative), so they hold BF16_CACHE_REL where that is larger."""
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    dec_rel = rel if cache_dtype == "float32" else max(rel, BF16_CACHE_REL)
    s_max = S + STEPS
    wl, wc = jax.jit(lambda p, b: jM.prefill(cfg_j, p, b, s_max=s_max,
                                             cache_dtype=jdt))(params, jb)
    gl, gc = tM.prefill(cfg_t, model, tb, s_max=s_max, cache_dtype=tdt)
    assert_close_to_max(gl, wl, rel, "prefill")
    assert_caches(wc, gc, cfg_t, rel)

    jdec = jax.jit(lambda p, t, c, i: jM.decode_step(cfg_j, p, t, c, i))
    rng = np.random.default_rng(1)
    for step in range(STEPS):
        tok = rng.integers(0, cfg_t.vocab_size, (B, 1)).astype(np.int32)
        gc = port_cache(wc, gc, cfg_t)       # the same state on both sides
        wl, wc = jdec(params, tok, wc, S + step)
        gl, gc = tM.decode_step(cfg_t, model, torch.from_numpy(tok), gc,
                                S + step)
        assert_close_to_max(gl, wl, dec_rel,
                            f"decode {step} ({cache_dtype})")
        assert_caches(wc, gc, cfg_t, rel)


def check_init_cache(arch):
    """`init_cache` equals the JAX package's leaf for leaf (zeros and ones
    in the same dtypes), and a `decode_step` at index 0 from it holds
    the chain's bound."""
    cfg_j, cfg_t, params, model = carried(arch)
    wc = jM.init_cache(cfg_j, B, 8)
    gc = tM.init_cache(cfg_t, B, 8, device="cpu")
    for label, w, g in cache_leaves(wc, gc, cfg_t):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), label
        np.testing.assert_array_equal(np_of(g), np_of(w), err_msg=label)
    tok = np.random.default_rng(2).integers(
        0, cfg_t.vocab_size, (B, 1)).astype(np.int32)
    wl, _ = jax.jit(lambda p, t, c: jM.decode_step(cfg_j, p, t, c, 0))(
        params, tok, wc)
    gl, _ = tM.decode_step(cfg_t, model, torch.from_numpy(tok), gc, 0)
    assert_close_to_max(gl, wl, max(CHAIN_REL.get(arch, LOGITS_REL),
                                    BF16_CACHE_REL), "decode from init")


# ---------------------------------------------------------------------
# training: carried weights, batches with labels, JAX trees by path
# ---------------------------------------------------------------------

# Three stacks amplify float32 rounding through their backward: one ulp
# of every weight moves the JAX package's own gradient, relative to each
# leaf's max, by 3.7e-3 to 7.0e-3 (whisper), 7.1e-2 to 7.3e-2 (xlstm) and
# 1.1e-4 to 3.3e-4 (zamba2) over three draws
# (`tools/torch_lm_grad_witness.py`). Their chained gradients are held at
# about three times that, and every layer's VJP alone at 1e-5 on the JAX
# layer's input (`test_torch_train_layers.py`).
GRAD_CHAIN_REL = {"whisper-base": 2e-2, "xlstm-1.3b": 0.2,
                  "zamba2-7b": 1e-3}
TRAIN_LOSS_REL = 1e-5      # loss, ce, aux: |port - JAX| / |JAX|
TRAIN_B, TRAIN_S = 4, 16


def train_configs(arch, **over):
    """The reduced configuration of ``arch`` in both packages, with the
    same fields changed."""
    return (dataclasses.replace(jreduced(arch), **over),
            dataclasses.replace(treduced(arch), **over))


def carried_train(cfg_j, cfg_t, seed=0):
    """(JAX params, port model) on the same perturbed JAX weights for the
    given (possibly modified) configurations."""
    tree = perturb(jax_params(jM.model_def(cfg_j), seed),
                   np.random.default_rng(seed), 0.02)
    return (jax.tree.map(jnp.asarray, tree),
            interop.lm_params(cfg_t, tree, device="cpu"))


def train_batches(cfg_j, cfg_t, step=0):
    """Each package's `make_batch` (labels kept) for data step ``step``."""
    return (jmake(cfg_j, TRAIN_B, TRAIN_S, 0, step),
            tmake(cfg_t, TRAIN_B, TRAIN_S, 0, step, device="cpu"))


def paths(tree, prefix=""):
    """A nested dict's leaves by dotted path, in sorted-key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(paths(tree[k], f"{prefix}.{k}" if prefix else k))
    return out
