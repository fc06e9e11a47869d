"""The port's GPipe pipeline (`repro_torch.dist.pipeline`) against the
unpipelined model: the case of the JAX package's own test (glm4-9b
reduced to 4 repeats, ``remat=False``, 8 × 16 tokens, 4 microbatches) on
4 gloo ranks on the CPU. The JAX pipeline fails its own test, so the port
is held to the unpipelined forward (the port's and the JAX package's on
the same weights) and the unpipelined gradient, which is what that test
asserts; the stage grouping and the JAX pipeline tree's carrier are held
exact."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced
from repro.dist import pipeline as JPP
from repro.models import model as JM
from repro.models.common import materialize
from repro_torch import interop
from repro_torch.configs import reduced_config
from repro_torch.dist import pipeline as PP
from repro_torch.models import model as M
from repro_torch.train.steps import make_loss_fn

import torch_ranks

N_STAGES, N_MICRO = 4, 4


def _cfgs():
    jcfg = dataclasses.replace(jax_reduced("glm4-9b", n_repeats=4),
                               remat=False)
    cfg = dataclasses.replace(reduced_config("glm4-9b", n_repeats=4),
                              remat=False)
    return jcfg, cfg


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = _cfgs()
    params = materialize(JM.model_def(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    return jcfg, cfg, params, tree, toks


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    _, cfg, _, tree, toks = case
    return torch_ranks.run("job_pipeline", N_STAGES,
                           tmp_path_factory.mktemp("pipe"), cfg, tree, toks,
                           N_MICRO, timeout=240.0)


def test_logits_match_unpipelined(case, ranks):
    jcfg, cfg, params, tree, toks = case
    model = interop.lm_params(cfg, tree, device="cpu")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        ref, _ = M.forward(cfg, model, {"tokens": t})
    jref, _ = JM.forward(jcfg, params, {"tokens": jax.numpy.asarray(toks)})
    jref = torch.from_numpy(np.asarray(jref))
    for r in ranks:
        assert _rel(r["logits"], ref) < 1e-3
        assert _rel(r["logits"], jref) < 1e-3
        assert torch.equal(r["logits"], ranks[0]["logits"])
        assert torch.equal(r["loss"], ranks[0]["loss"])
    # every hand-off of the 3 links, one way each microbatch
    assert [r["sends"] for r in ranks] == [N_MICRO] * 3 + [0]
    assert [r["recvs"] for r in ranks] == [0] + [N_MICRO] * 3
    assert all(r["staged"] == 0 for r in ranks)     # CPU tensors: no staging


def test_gradients_match_unpipelined(case, ranks):
    _, cfg, _, tree, toks = case
    model = interop.lm_params(cfg, tree, device="cpu")
    model.requires_grad_(True)
    t = torch.from_numpy(toks)
    loss, _ = make_loss_fn(cfg)(model, {"tokens": t, "labels": t})
    loss.backward()
    got = {}
    for r in ranks:
        assert not set(got) & set(r["grads"])
        got.update(r["grads"])
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert _rel(got[name], p.grad) < 1e-3, name
    assert _rel(ranks[0]["loss"], loss.detach()) < 1e-5


def test_stage_grouping_round_trip(case):
    _, cfg, _, tree, _ = case
    model = interop.lm_params(cfg, tree, device="cpu")
    layers = list(model.layers)
    pp = PP.to_pipeline_params(cfg, model, N_STAGES)
    per = cfg.n_repeats // N_STAGES * len(cfg.block_pattern)
    for s, stage in enumerate(pp.stages):
        assert list(stage) == layers[s * per:(s + 1) * per]
    back = PP.from_pipeline_params(cfg, pp)
    assert list(back.layers) == layers
    with pytest.raises(ValueError, match="not divisible"):
        PP.to_pipeline_params(cfg, model, 3)


def test_jax_pipeline_tree_carrier(case):
    jcfg, cfg, params, tree, _ = case
    jtree = jax.tree.map(np.asarray,
                         JPP.to_pipeline_params(jcfg, params, N_STAGES))
    pp = interop.lm_pipeline_params(cfg, jtree, N_STAGES, device="cpu")
    flat = interop.lm_params(cfg, tree, device="cpu")
    for (n, a), (m, b) in zip(pp.model.named_parameters(),
                              flat.named_parameters()):
        assert n == m and torch.equal(a, b)
    back = interop.lm_pipeline_tree(cfg, pp)

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                walk(a[k], b[k])
        else:
            assert torch.equal(b, interop._tensor(a))
    walk(jtree, back)


def test_pipeline_refuses_encdec_and_vlm():
    for arch in ("whisper-base", "qwen2-vl-72b"):
        cfg = reduced_config(arch)
        pp = PP.PipelineParams(M.Model(cfg), [])
        with pytest.raises(NotImplementedError):
            PP.pipeline_forward(cfg, pp, torch.zeros((2, 4), dtype=torch.long))
