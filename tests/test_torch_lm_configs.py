"""Port parity: the LM stack's configurations, parameter shapes and counts
at full size, and the synthetic batches.

* `get_config`, `reduced_config` (one and two repeats), `get_shape`,
  `shapes_for` and `ARCHS` equal the JAX package's field by field, and the
  same errors are raised;
* the port's `Model`, built on the ``meta`` device for every **full**
  configuration (no allocation), has every parameter of the JAX
  `model_def` with its shape after unstacking, the port's `model_def`
  equals the JAX one leaf for leaf (shape, logical axes, init law), and
  `count_params` / `count_active_params` are equal;
* `make_batch` equals the JAX package's bit for bit for every family;
* the weight carry refuses a wrong shape and a missing leaf;
* the launcher, `materialize`, `init_model`, `init_cache` and
  `make_batch` refuse to run without CUDA unless given ``device="cpu"``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import common as jcommon
from repro.models import model as jM
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcommon
from repro_torch.models import model as tM

ARCHS = jconfigs.ARCHS


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_arch_registry_equal():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert [_fields(s) for s in tconfigs.ALL_SHAPES] == \
        [_fields(s) for s in jconfigs.ALL_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal(arch):
    assert _fields(tconfigs.get_config(arch)) == \
        _fields(jconfigs.get_config(arch))
    for n in (1, 2):
        assert _fields(tconfigs.reduced_config(arch, n)) == \
            _fields(jconfigs.reduced_config(arch, n))
    assert [s.name for s in tconfigs.shapes_for(tconfigs.get_config(arch))] \
        == [s.name for s in jconfigs.shapes_for(jconfigs.get_config(arch))]
    full = tconfigs.get_config(arch)
    assert (full.padded_vocab, full.n_repeats, full.is_encdec,
            full.sub_quadratic, full.layer_types()) == (
        jconfigs.get_config(arch).padded_vocab,
        jconfigs.get_config(arch).n_repeats,
        jconfigs.get_config(arch).is_encdec,
        jconfigs.get_config(arch).sub_quadratic,
        jconfigs.get_config(arch).layer_types())


def test_shapes_and_errors_equal():
    for s in jconfigs.ALL_SHAPES:
        assert _fields(tconfigs.get_shape(s.name)) == _fields(s)
    for fn in ("get_config", "get_shape"):
        with pytest.raises(KeyError) as want:
            getattr(jconfigs, fn)("no-such")
        with pytest.raises(KeyError) as got:
            getattr(tconfigs, fn)("no-such")
        assert str(got.value) == str(want.value)
    bad = dict(name="x", family="dense", n_layers=5, d_model=8, n_heads=2,
               n_kv_heads=2, d_ff=8, vocab_size=10, block_pattern=("a", "b"))
    with pytest.raises(ValueError) as want:
        jconfigs.ModelConfig(**bad)
    with pytest.raises(ValueError) as got:
        tconfigs.ModelConfig(**bad)
    assert str(got.value) == str(want.value)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _def_fields(d):
    return (tuple(d.shape), tuple(d.logical), d.init, d.axis)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameters_equal(arch):
    cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jdefs = _flat(jM.model_def(cfg_j))
    assert {k: _def_fields(d) for k, d in _flat(tM.model_def(cfg_t)).items()} \
        == {k: _def_fields(d) for k, d in jdefs.items()}
    model = tM.Model(cfg_t)                       # meta: nothing allocated
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert all(p.device.type == "meta" for p in model.parameters())
    plen = len(cfg_t.block_pattern)
    want = {}
    for path, d in jdefs.items():
        top, rest = path[0], ".".join(path[1:])
        if top.startswith("blocks_"):
            pos = int(top.split("_")[1])
            for r in range(d.shape[0]):
                want[f"layers.{r * plen + pos}.{rest}"] = tuple(d.shape[1:])
        elif top == "enc_blocks":
            for r in range(d.shape[0]):
                want[f"enc_layers.{r}.{rest}"] = tuple(d.shape[1:])
        else:
            want[f"{top}.{rest}"] = tuple(d.shape)
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) == \
        jM.count_params(cfg_j)
    assert tM.count_params(cfg_t) == jM.count_params(cfg_j)
    assert tM.count_active_params(cfg_t) == jM.count_active_params(cfg_j)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_make_batch_bitwise(arch, full):
    if full:
        cfg_j, cfg_t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    else:
        cfg_j = jconfigs.reduced_config(arch)
        cfg_t = tconfigs.reduced_config(arch)
    S = cfg_j.vision_prefix + 24 if cfg_j.family == "vlm" else 40
    want = jpipe.make_batch(cfg_j, 2, S, seed=7, step=3)
    got = tpipe.make_batch(cfg_t, 2, S, seed=7, step=3, device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_token_pipeline_cursor():
    cfg = tconfigs.reduced_config("smollm-360m")
    pipe = tpipe.TokenPipeline(cfg, 2, 16, seed=3, device="cpu")
    next(pipe)
    second = next(pipe)
    assert pipe.state.step == 2
    pipe.skip_to(1)
    again = next(pipe)
    for k in second:
        assert torch.equal(second[k], again[k])
    jpipe_ = jpipe.TokenPipeline(jconfigs.reduced_config("smollm-360m"), 2, 16,
                                 seed=3, start_step=1)
    np.testing.assert_array_equal(np.asarray(next(jpipe_)["tokens"]),
                                  again["tokens"].numpy())


def test_lm_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg = tconfigs.reduced_config("smollm-360m")
    defs = tM.model_def(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcommon.materialize(defs, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tM.init_model(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.make_batch(cfg, 2, 8, 0, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tM.init_cache(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--reduced", "--gen", "2", "--prompt-len", "4"])
    tree = tcommon.materialize(defs, torch.Generator().manual_seed(0),
                               device="cpu")
    assert tree["embed"]["tokens"].device.type == "cpu"


def test_materialize_init_laws():
    """zeros, ones, normal × 0.02, embed × 1 and fan_in, each drawn in its
    target dtype, one generator call a tensor, repeatable."""
    defs = {"z": tcommon.ParamDef((4,), (None,), init="zeros"),
            "o": tcommon.ParamDef((4,), (None,), init="ones"),
            "n": tcommon.ParamDef((256, 64), (None, None), init="normal"),
            "e": tcommon.ParamDef((256, 64), (None, None), init="embed"),
            "f": tcommon.ParamDef((64, 3, 256), (None, None, None),
                                  axis=-3)}
    a = tcommon.materialize(defs, torch.Generator().manual_seed(1),
                            torch.bfloat16, "cpu")
    b = tcommon.materialize(defs, torch.Generator().manual_seed(1),
                            torch.bfloat16, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["z"], torch.zeros(4, dtype=torch.bfloat16))
    assert torch.equal(a["o"], torch.ones(4, dtype=torch.bfloat16))
    assert abs(float(a["n"].float().std()) - 0.02) < 0.002
    assert abs(float(a["e"].float().std()) - 1.0) < 0.05
    assert abs(float(a["f"].float().std()) - 64 ** -0.5) < 0.01


def test_load_tree_refuses_mismatch():
    """The weight carry raises on a wrong shape and on a missing leaf."""
    cfg = tconfigs.reduced_config("granite-moe-3b-a800m")
    tree = jax.tree.map(np.asarray, jcommon.materialize(
        jM.model_def(jconfigs.reduced_config("granite-moe-3b-a800m")),
        jax.random.PRNGKey(0)))
    tree["blocks_0"]["moe"]["router"] = np.zeros(
        (cfg.n_repeats, 3, 3), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch for layers.0.moe"
                       ".router"):
        interop.lm_params(cfg, tree, device="cpu")
    del tree["blocks_0"]["moe"]["router"]
    with pytest.raises(RuntimeError, match="Missing key"):
        interop.lm_params(cfg, tree, device="cpu")
    tree["blocks_0"]["moe"]["router"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="expected 2 stacked layers"):
        interop.lm_params(cfg, tree, device="cpu")
