"""The port's train step against the JAX trainer's on the CPU (three steps
under every option), and the port's own invariants: remat and update
chunks change no bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim import get_optimizer as jget
from repro.optim import warmup_cosine as jwarmup
from repro.train import steps as jsteps
from repro_torch import interop
from repro_torch.configs import reduced_config as treduced
from repro_torch.data.pipeline import make_batch as tmake
from repro_torch.models import model as tM
from repro_torch.optim import compress as tcompress
from repro_torch.optim import get_optimizer as tget
from repro_torch.optim import warmup_cosine as twarmup
from repro_torch.train import steps as tsteps
from torch_lm import (TRAIN_B, TRAIN_LOSS_REL, TRAIN_S, carried_train, np_of,
                      paths, train_batches, train_configs)

# A train step's loss and grad_norm, three steps on: step 0 as
# TRAIN_LOSS_REL; the later steps start from parameters that AdamW's
# first, sign-like update (about lr·sign(g)) moved differently wherever a
# gradient element is within rounding of zero (up to 2·lr), so they are
# held looser. Under
# int8_ef an element within rounding of a quantization boundary lands a
# whole quantum (max|g|/127) apart, which the chain would carry on: each
# int8_ef step starts from the JAX step's parameters, optimizer state and
# error state, and is held at TRAIN_LOSS_REL.
STEP_REL = 1e-4
B, S = TRAIN_B, TRAIN_S

STEP_CASES = {
    "grad_accum_vlm": ("qwen2-vl-72b", {"grad_accum": 2}, {}),
    "seq_chunk": ("smollm-360m", {"loss_seq_chunk": 5}, {}),
    "bf16": ("smollm-360m", {}, {"compression": "bf16"}),
    "int8_ef": ("granite-moe-3b-a800m", {}, {"compression": "int8_ef"}),
    "clip_bites": ("glm4-9b", {}, {"clip_norm": 0.05}),
    "adafactor_chunks": ("kimi-k2-1t-a32b", {}, {}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """Three steps of `make_train_step` against the JAX step under jit:
    loss, ce, aux and grad_norm each step."""
    arch, over, kw = STEP_CASES[case]
    cfg_j, cfg_t = train_configs(arch, **over)
    params, model = carried_train(cfg_j, cfg_t)
    model.requires_grad_(True)
    jopt = jget(cfg_j.optimizer, lr=jwarmup(1e-3, 2, 10))
    jstate = jopt.init(params)
    jstep = jax.jit(jsteps.make_train_step(cfg_j, jopt, **kw))
    topt = tget(cfg_t.optimizer, tM.jax_leaves(model),
                lr=twarmup(1e-3, 2, 10))
    tstep = tsteps.make_train_step(cfg_t, **kw)
    int8 = kw.get("compression") == "int8_ef"
    jerr = terr = None
    if int8:
        from repro.optim import compress as jcompress
        jerr = jcompress.init_error_feedback(params)
        terr = tcompress.init_error_feedback(tM.jax_leaves(model))
    for step in range(3):
        jb, tb = train_batches(cfg_j, cfg_t, step)
        if int8:
            _load_jax_state(model, topt, params, jstate)
            terr = [interop._tensor(paths(jerr)[leaf.name])
                    for leaf in tM.jax_leaves(model)]
            params, jstate, want, jerr = jstep(params, jstate, jb, jerr)
            got, terr = tstep(model, topt, tb, terr)
        else:
            params, jstate, want = jstep(params, jstate, jb)
            got = tstep(model, topt, tb)
        rel = TRAIN_LOSS_REL if step == 0 or int8 else STEP_REL
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(
                float(got[k]), float(want[k]), rtol=rel, atol=1e-7,
                err_msg=f"{case} step {step} {k}")
        if case == "clip_bites":
            assert float(want["grad_norm"]) > 10 * kw["clip_norm"]
    assert topt.count == int(jstate["count"]) == 3


def _load_jax_state(model, opt, params, state):
    """The JAX trainer's parameters and optimizer state into the port's
    model and optimizer, in place."""
    tree = paths(jax.tree.map(np.asarray, params))
    with torch.no_grad():
        for leaf in tM.jax_leaves(model):
            a = interop._tensor(tree[leaf.name])
            for r, p in enumerate(leaf.params):
                p.copy_(a[r] if leaf.stacked else a)
    interop.lm_opt_state(opt, jax.tree.map(np.asarray, state))


def _port_run(cfg, steps=2, seed=0):
    """``steps`` port train steps from seeded weights; returns the model,
    the optimizer and each step's metrics."""
    model = tM.init_model(cfg, torch.Generator().manual_seed(seed),
                          device="cpu").requires_grad_(True)
    opt = tget(cfg.optimizer, tM.jax_leaves(model), lr=twarmup(1e-3, 2, 10))
    step = tsteps.make_train_step(cfg)
    metrics = [step(model, opt, tmake(cfg, B, S, seed, i, device="cpu"))
               for i in range(steps)]
    return model, opt, metrics


def _assert_same_bits(a, b):
    (ma, oa, xa), (mb, ob, xb) = a, b
    for x, y in zip(xa, xb):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (na, pa), (nb, pb) in zip(ma.named_parameters(),
                                  mb.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    for ga, gb in zip(oa.param_groups, ob.param_groups):
        for key in ("m", "v", "vr", "vc"):
            if key in ga:
                assert torch.equal(ga[key], gb[key]), (ga["leaf"], key)


@pytest.mark.parametrize("arch", ["smollm-360m", "kimi-k2-1t-a32b"])
def test_update_chunks_change_no_bit(arch):
    """``opt_update_chunks`` 1 and 3 (AdamW; Adafactor) give equal bits."""
    runs = [_port_run(dataclasses.replace(treduced(arch),
                                          opt_update_chunks=c))
            for c in (1, 3)]
    _assert_same_bits(*runs)


@pytest.mark.parametrize("arch,policy", [
    ("smollm-360m", "nothing"), ("smollm-360m", "dots"),
    ("granite-moe-3b-a800m", "dots"), ("whisper-base", "nothing"),
    ("zamba2-7b", "nothing")])
def test_remat_changes_no_bit(arch, policy):
    """Remat on (each repeat, and whisper's encoder layers, under
    checkpoint) against off: equal losses, gradients and updates."""
    base = treduced(arch)
    runs = [_port_run(dataclasses.replace(base, remat=on,
                                          remat_policy=policy))
            for on in (False, True)]
    _assert_same_bits(*runs)


def test_dots_policy_saves_plain_matmuls():
    """Under ``dots`` the checkpointed forward keeps the outputs of the
    matmuls without batch axes and recomputes the batched ones."""
    from torch.utils.checkpoint import CheckpointPolicy
    x, w = torch.randn(1, 6, 8), torch.randn(8, 5)
    aten = torch.ops.aten
    assert tM._save_dots(None, aten.mm.default, x[0], w) is \
        CheckpointPolicy.MUST_SAVE
    assert tM._save_dots(None, aten.bmm.default, x, w[None]) is \
        CheckpointPolicy.MUST_SAVE
    assert tM._save_dots(None, aten.bmm.default, x.expand(3, 6, 8),
                         w.expand(3, 8, 5)) is \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert tM._save_dots(None, aten.exp.default, x) is \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_prefill_and_decode_steps():
    cfg = treduced("qwen2-1.5b")
    model = tM.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = tmake(cfg, 2, 8, 0, 0, device="cpu")
    batch.pop("labels")
    lg, cache = tsteps.make_prefill_step(cfg, 10)(model, batch)
    want, _ = tM.prefill(cfg, model, batch, 10)
    assert torch.equal(lg, want)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    got, _ = tsteps.make_decode_step(cfg)(model, tok, cache, 8)
    assert got.shape == (2, cfg.vocab_size)
    assert np.isfinite(np_of(got)).all()
