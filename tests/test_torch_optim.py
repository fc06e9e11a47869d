"""The port's optimizers, schedule and gradient compressors against the JAX
package's `optim/`, on identical inputs (CPU).

Leaves are stacked as the JAX trainer stacks ``blocks_{pos}``: per-layer
ranks 1, 2 and 3 at ``n_repeats`` 1 and 2, beside unstacked matrix and
vector leaves. The port holds each layer as its own parameter; its state
and its statistics are the stacked leaf's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.configs import reduced_config as jreduced
from repro.models import model as jM
from repro.optim import compress as jcompress
from repro.optim import get_optimizer as jget
from repro.optim import warmup_cosine as jwarmup
from repro_torch import interop
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as tM
from repro_torch.optim import Adafactor, AdamW
from repro_torch.optim import compress as tcompress
from repro_torch.optim import get_optimizer as tget
from repro_torch.optim import warmup_cosine as twarmup

OPT_REL = 1e-6        # max|port - JAX| / max|JAX| per leaf, same inputs
PER_LAYER = {"a": (16,), "b": (4, 6), "c": (3, 4, 5)}   # stacked leaves
UNSTACKED = {"e": (7, 5), "f": (9,)}
OPTIMIZERS = [("adamw", {}), ("adamw", {"weight_decay": 0.1}),
              ("adafactor", {}), ("adafactor", {"weight_decay": 0.1})]


def _tree(n, rng, scale=1.0):
    """A JAX-layout float32 tree: ``blocks_0`` stacked over ``n``."""
    t = {"blocks_0": {k: (scale * rng.standard_normal((n,) + s)).astype(
        np.float32) for k, s in PER_LAYER.items()}}
    t.update({k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in UNSTACKED.items()})
    return t


def _paths(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_paths(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def _port_leaves(tree, stacked=True):
    """`tM.Leaf`s holding ``tree``'s values, a parameter a layer. With
    ``stacked=False`` each layer is a leaf of its own (what a per-layer
    optimizer would see)."""
    out = []
    for name, a in _paths(tree).items():
        if name.startswith("blocks_"):
            ps = [nn.Parameter(torch.from_numpy(a[r].copy()))
                  for r in range(a.shape[0])]
            if stacked:
                out.append(tM.Leaf(name, ps, True))
            else:
                out += [tM.Leaf(f"{name}#{r}", [p], False)
                        for r, p in enumerate(ps)]
        else:
            out.append(tM.Leaf(name, [nn.Parameter(
                torch.from_numpy(a.copy()))], False))
    return out


def _port_grads(tree, leaves):
    """``tree``'s values as the port's gradients (a list a leaf)."""
    paths = _paths(tree)
    out = []
    for leaf in leaves:
        name, _, layer = leaf.name.partition("#")
        a = paths[name]
        if leaf.stacked:
            out.append([torch.from_numpy(a[r].copy())
                        for r in range(a.shape[0])])
        else:
            out.append([torch.from_numpy(np.array(a[int(layer)] if layer
                                                  else a))])
    return out


def _assert_leaf(got, want, label, rel=OPT_REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (label, err, scale)


def _assert_tree(got, want, label):
    gp, wp = _paths(got), _paths(want)
    assert sorted(gp) == sorted(wp), label
    for k in wp:
        _assert_leaf(gp[k].float().numpy(), np.asarray(wp[k], np.float32),
                     f"{label} {k}")


def _lr():
    return 2e-2, 3, 10          # peak, warmup, total: steps 1-2 warm, 3 cos


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_update_matches_jax(name, kw, n):
    """Three updates from the JAX state after each earlier one: params
    and every state leaf within OPT_REL of JAX's, count equal."""
    rng = np.random.default_rng(7)
    params = _tree(n, rng)
    jopt = jget(name, lr=jwarmup(*_lr()), **kw)
    jupd = jax.jit(jopt.update)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    leaves = _port_leaves(params)
    topt = tget(name, leaves, lr=twarmup(*_lr()), **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    for step in range(3):
        grads = _tree(n, rng, scale=10.0 ** (step - 1))
        # identical inputs: the port starts from JAX's params and state
        for leaf in leaves:
            a = _paths(jax.tree.map(np.asarray, jparams))[leaf.name]
            for r, p in enumerate(leaf.params):
                p.data.copy_(torch.from_numpy(np.array(
                    a[r] if leaf.stacked else a)))
        interop.lm_opt_state(topt, jax.tree.map(np.asarray, jstate))
        jparams, jstate = jupd(jax.tree.map(jnp.asarray, grads), jstate,
                               jparams)
        topt.step(grads=_port_grads(grads, leaves))
        assert topt.count == int(jstate["count"])
        got = {}
        for leaf in leaves:
            ps = [p.detach() for p in leaf.params]
            interop._put(got, leaf.name,
                         torch.stack(ps) if leaf.stacked else ps[0])
        _assert_tree(got, jparams, f"{name} step {step} params")
        tstate = _train_state(topt)
        for key in jstate:
            if key != "count":
                _assert_tree(tstate[key], jstate[key], f"{name} {key}")


def _train_state(opt):
    state: dict = {}
    for group in opt.param_groups:
        for key in ("m", "v", "vr", "vc"):
            if key in group:
                interop._put(state.setdefault(key, {}), group["leaf"],
                             group[key])
    return state


def test_adafactor_factors_the_stacked_leaf():
    """A stacked leaf of per-layer vectors is factored across its repeats,
    as in JAX: ``vr`` (n,), ``vc`` (D,). A per-layer optimizer (each
    layer a leaf of its own) would keep the vectors unfactored and move
    the parameters elsewhere; the port's stacked update is JAX's."""
    rng = np.random.default_rng(3)
    params, grads = _tree(2, rng), _tree(2, rng)
    leaves = _port_leaves(params)
    topt = tget("adafactor", leaves, lr=0.1)
    group = topt.param_groups[0]
    assert group["leaf"] == "blocks_0.a"
    assert group["vr"].shape == (2,) and group["vc"].shape == (16,)
    jopt = jget("adafactor", lr=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    jparams, _ = jopt.update(jax.tree.map(jnp.asarray, grads),
                             jopt.init(jp), jp)
    topt.step(grads=_port_grads(grads, leaves))
    want = np.asarray(jparams["blocks_0"]["a"])
    got = torch.stack([p.detach() for p in leaves[0].params]).numpy()
    _assert_leaf(got, want, "stacked")
    per_layer = _port_leaves(params, stacked=False)
    tget("adafactor", per_layer, lr=0.1).step(
        grads=_port_grads(grads, per_layer))
    alone = torch.stack([per_layer[r].params[0].detach()
                         for r in range(2)]).numpy()
    assert np.abs(alone - want).max() > 100 * OPT_REL * np.abs(want).max()


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_defs_and_shapes_match_jax(name):
    """`state_defs` over `model_def` equals the JAX optimizer's, and the
    port's state on a reduced model has exactly those shapes."""
    arch = "zamba2-7b"           # stacked vectors, matrices and 3-D leaves
    cfg_j, cfg_t = jreduced(arch), treduced(arch)
    jdefs = jget(name).state_defs(jM.model_def(cfg_j))
    tdefs = {"adamw": AdamW, "adafactor": Adafactor}[name].state_defs(
        tM.model_def(cfg_t))
    jflat = {k: (d.shape, d.logical) for k, d in _paths_defs(jdefs).items()}
    tflat = {k: (d.shape, d.logical) for k, d in _paths_defs(tdefs).items()}
    assert jflat == tflat
    model = tM.init_model(cfg_t, torch.Generator().manual_seed(0),
                          device="cpu")
    opt = tget(name, tM.jax_leaves(model), lr=0.1)
    for key, tree in _train_state(opt).items():
        for path, t in _paths(tree).items():
            assert tuple(t.shape) == jflat[f"{key}.{path}"][0], (key, path)


def _paths_defs(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(_paths_defs(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def test_state_dict_round_trip():
    rng = np.random.default_rng(0)
    params = _tree(2, rng)
    a = tget("adafactor", _port_leaves(params), lr=0.1)
    a.step(grads=_port_grads(_tree(2, rng), _port_leaves(params)))
    b = tget("adafactor", _port_leaves(params), lr=0.1)
    b.load_state_dict(a.state_dict())
    assert b.count == 1
    for ga, gb in zip(a.param_groups, b.param_groups):
        for key in ("m", "vr", "vc"):
            assert torch.equal(ga[key], gb[key])


# JAX's float32 schedule is what XLA compiles it into: divisions by the
# constants become multiplications by rounded reciprocals (folded with
# peak_lr), and its cosine has other last bits than PyTorch's. The port
# computes the formula in JAX's order; over 100k steps the two differ by
# at most 8 float32 ulps of the rate, near the cosine's floor where
# 1 + cos cancels (measured). Bound: 1e-6 of the peak rate.
SCHEDULE_ABS = 1e-6


@pytest.mark.parametrize("peak,warmup,total", [
    (3e-4, 20, 100), (1e-3, 7, 1000), (3e-4, 20, 6), (0.05, 1, 3),
    (3e-4, 1000, 100_000), (1e-2, 0, 50)])
def test_warmup_cosine_matches_jax(peak, warmup, total):
    steps = np.arange(0, total + 5, max(1, total // 2000),
                      dtype=np.float32)
    want = np.asarray(jax.vmap(jax.jit(jwarmup(peak, warmup, total)))(
        jnp.asarray(steps)))
    got = twarmup(peak, warmup, total)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= SCHEDULE_ABS * peak
    cut = steps < warmup          # the warmup ramp itself
    assert np.abs(got[cut] - want[cut]).max(initial=0) <= SCHEDULE_ABS * peak


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("shape,scale", [((64,), 3.0), ((3, 40, 17), 1e5),
                                         ((2, 128, 64), 1e-3)])
def test_int8_compress_decompress_bitwise(shape, scale):
    rng = np.random.default_rng(11)
    g = (scale * rng.standard_normal(shape)).astype(np.float32)
    e = (0.01 * scale * rng.standard_normal(shape)).astype(jnp.bfloat16)
    wd, we = jax.jit(jcompress.int8_compress_decompress)(jnp.asarray(g),
                                                         jnp.asarray(e))
    gd, ge = tcompress.int8_compress_decompress(torch.from_numpy(g), _bf16(e))
    assert gd.dtype == torch.float32 and ge.dtype == torch.bfloat16
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(ge.float().numpy(),
                                  np.asarray(we, np.float32))


def test_int8_rounds_ties_to_even():
    """x / scale lands on .5 (scale 1: max|x| is 127): half to even."""
    g = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                 np.float32)
    e = np.zeros_like(g).astype(jnp.bfloat16)
    wd, we = jcompress.int8_compress_decompress(jnp.asarray(g),
                                                jnp.asarray(e))
    gd, ge = tcompress.int8_compress_decompress(torch.from_numpy(g), _bf16(e))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gd.numpy()[:6], [0, 2, 2, 0, -2, -2])
    np.testing.assert_array_equal(ge.float().numpy(),
                                  np.asarray(we, np.float32))


@pytest.mark.parametrize("n", [1, 2])
def test_int8_error_feedback_per_jax_leaf(n):
    """Three steps of error feedback over a stacked tree: one scale a JAX
    leaf (over all its repeats), the error state in the stacked shape,
    bit for bit; a scale per layer would differ."""
    rng = np.random.default_rng(5)
    params = _tree(n, rng)
    leaves = _port_leaves(params)
    terr = tcompress.init_error_feedback(leaves)
    jerr = jcompress.init_error_feedback(jax.tree.map(jnp.asarray, params))
    jfn = jax.jit(jcompress.int8_with_error_feedback)
    for _ in range(3):
        grads = _tree(n, rng)
        for leaf in leaves:          # the repeats on different scales
            if leaf.stacked and n > 1:
                _paths(grads)[leaf.name][1] *= 40.0
        wdeq, jerr = jfn(jax.tree.map(jnp.asarray, grads), jerr)
        gdeq, terr = tcompress.int8_with_error_feedback(
            _port_grads(grads, leaves), terr)
        wd, we = _paths(wdeq), _paths(jerr)
        for leaf, d, e in zip(leaves, gdeq, terr):
            got = torch.stack(d) if leaf.stacked else d[0]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(wd[leaf.name]))
            np.testing.assert_array_equal(
                e.float().numpy(), np.asarray(we[leaf.name], np.float32))
    if n > 1:
        a = np.asarray(_paths(grads)["blocks_0.b"])
        per_layer, _ = tcompress.int8_compress_decompress(
            torch.from_numpy(a[0]), torch.zeros(a.shape[1:],
                                                dtype=torch.bfloat16))
        leafwide, _ = jcompress.int8_compress_decompress(
            jnp.asarray(a), jnp.zeros(a.shape, jnp.bfloat16))
        assert not np.array_equal(per_layer.numpy(),
                                  np.asarray(leafwide)[0])


def test_bf16_compress_bitwise():
    rng = np.random.default_rng(2)
    params = _tree(2, rng)
    leaves = _port_leaves(params)
    want = _paths(jcompress.bf16_compress(jax.tree.map(jnp.asarray, params)))
    got = tcompress.bf16_compress(_port_grads(params, leaves))
    for leaf, g in zip(leaves, got):
        t = torch.stack(g) if leaf.stacked else g[0]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want[leaf.name], np.float32))
