"""Port parity: whole models of the recurrent (xLSTM), hybrid (zamba2)
and encoder-decoder (whisper) families on the JAX package's weights, and
the launcher's greedy loop.

The model checks and their bounds are `torch_lm.check_model`'s (see
`test_torch_lm_models.py`). The greedy loop: `launch.serve.generate` on
the reduced smollm-360m and granite-moe-3b-a800m, with the JAX weights,
gives token for token the tokens of a JAX `prefill` + `decode_step` loop
(the JAX launcher's), and its first logits hold ``LOGITS_REL``. The
launcher's CLI runs with ``--device cpu``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import model as jM
from repro_torch.launch import serve as tserve
from torch_lm import (LOGITS_REL, assert_close_to_max, batches, carried,
                      check_init_cache, check_layers, check_model)


ARCHS = ("whisper-base", "xlstm-1.3b", "zamba2-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode(arch):
    check_model(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_on_jax_inputs(arch):
    check_layers(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_first_decode(arch):
    check_init_cache(arch)


def _jax_greedy(cfg, params, batch, gen):
    """The JAX launcher's loop (`repro.launch.serve.serve`) on given
    weights."""
    P = batch["tokens"].shape[1]
    prefill = jax.jit(lambda p, b: jM.prefill(cfg, p, b, s_max=P + gen))
    decode = jax.jit(lambda p, t, c, i: jM.decode_step(cfg, p, t, c, i))
    logits, cache = prefill(params, batch)
    first = logits
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = decode(params, tok, cache, P + i)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1), first


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m"])
def test_greedy_loop_tokens(arch):
    cfg_j, cfg_t, params, model = carried(arch, seed=3)
    jb, tb = batches(cfg_j, cfg_t, 3, 12, seed=5)
    want, first = _jax_greedy(cfg_j, params, jb, 8)
    got = tserve.generate(cfg_t, model, tb, 8)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.tokens.shape == (3, 8) and got.logits.shape == (
        8, 3, cfg_t.vocab_size)
    assert_close_to_max(got.logits[0], first, LOGITS_REL)


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                        "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "ms/token, batch 2" in out
    assert "generated (first row):" in out
