"""The port's loss and gradients against the JAX trainer's on the CPU:
every gradient leaf of the ten reduced architectures on the JAX
package's weights (`interop.lm_params`), a padded vocabulary, the chunked
CE and the SSD scan's gradient. Train steps: `test_torch_train_steps.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import reduced_config as jreduced
from repro.train import steps as jsteps
from repro_torch.configs import reduced_config as treduced
from repro_torch.models import model as tM
from repro_torch.train import steps as tsteps
from torch_lm import (GRAD_CHAIN_REL, TRAIN_LOSS_REL, assert_close_to_max,
                      carried_train, paths, train_batches, train_configs)

GRAD_REL = 1e-4     # each gradient leaf: max|port - JAX| / max|JAX leaf|


def _port_grads(cfg_t, model, batch):
    """(metrics, {leaf name: stacked gradient}) of `make_loss_fn`."""
    model.requires_grad_(True)
    leaves = tM.jax_leaves(model)
    loss, metrics = tsteps.make_loss_fn(cfg_t)(model, batch)
    flat = iter(torch.autograd.grad(
        loss, [p for leaf in leaves for p in leaf.params]))
    grads = {}
    for leaf in leaves:
        gs = [next(flat) for _ in leaf.params]
        grads[leaf.name] = torch.stack(gs) if leaf.stacked else gs[0]
    return metrics, grads


def _check_loss_and_grads(arch, cfg_j, cfg_t):
    params, model = carried_train(cfg_j, cfg_t)
    jb, tb = train_batches(cfg_j, cfg_t)
    (_, want), wgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(cfg_j), has_aux=True))(params, jb)
    got, ggrads = _port_grads(cfg_t, model, tb)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=TRAIN_LOSS_REL, atol=1e-7, err_msg=k)
    rel = max(GRAD_REL, GRAD_CHAIN_REL.get(arch, 0.0))
    wg = paths(wgrads)
    assert sorted(wg) == sorted(ggrads)
    for name, g in ggrads.items():
        assert_close_to_max(g, wg[name], rel, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """`make_loss_fn` and its gradient, every leaf, against
    `jax.value_and_grad` on the same weights and batch."""
    _check_loss_and_grads(arch, jreduced(arch), treduced(arch))


def test_ssd_gradient_finite_past_exp_range():
    """Decay sums past float32's exp range above the chunk's diagonal: the
    JAX `ssd_chunked` gradient is NaN there (its `where` after `exp`),
    the port's is finite and equals the sequential recurrence's
    (`ssd_step` in a loop) within 1e-4 of its max; the values equal
    JAX's."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(0)
    B_, S_, H, N, P = 1, 16, 2, 4, 3
    a = (-20 * np.abs(rng.standard_normal((B_, S_, H)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B_, S_, 1, N)).astype(np.float32)
              for _ in range(2))
    X = rng.standard_normal((B_, S_, H, P)).astype(np.float32)

    def jloss(a):
        return jssm.ssd_chunked(a, Bm, X, Cm, 16)[0].sum()
    assert not bool(jnp.isfinite(jax.grad(jloss)(jnp.asarray(a))).all())
    at = torch.from_numpy(a).requires_grad_(True)
    y = tssm.ssd_chunked(at, *map(torch.from_numpy, (Bm, X, Cm)), 16)[0]
    np.testing.assert_allclose(y.detach().sum().numpy(),
                               float(jloss(jnp.asarray(a))), rtol=1e-5)
    (g_chunk,) = torch.autograd.grad(y.sum(), at)
    at2 = torch.from_numpy(a).requires_grad_(True)
    h = torch.zeros((B_, H, N, P))
    total = 0
    for t in range(S_):
        yt, h = tssm.ssd_step(h, at2[:, t], torch.from_numpy(Bm[:, t]),
                              torch.from_numpy(X[:, t]),
                              torch.from_numpy(Cm[:, t]))
        total = total + yt.sum()
    (g_seq,) = torch.autograd.grad(total, at2)
    assert bool(torch.isfinite(g_chunk).all())
    assert_close_to_max(g_chunk, g_seq, 1e-4, "chunked against sequential")


def test_padded_vocabulary_loss_and_grads():
    """A vocabulary of 100, padded to 128: the CE runs over the padded
    logits as JAX's does, and the padded rows of the tied embedding get
    JAX's gradient."""
    cfg_j, cfg_t = train_configs("smollm-360m", vocab_size=100)
    assert cfg_t.padded_vocab == 128
    _check_loss_and_grads("smollm-360m", cfg_j, cfg_t)


def test_chunked_ce_matches_jax():
    cfg_j, cfg_t = train_configs("qwen2-1.5b", loss_seq_chunk=5)
    _check_loss_and_grads("qwen2-1.5b", cfg_j, cfg_t)


