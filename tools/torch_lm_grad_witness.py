"""How far one float32 rounding of the weights moves the JAX package's own
gradient, for the ten reduced architectures on the weights and batch of
`tests/test_torch_train.py` (CPU, about a minute).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tools/torch_lm_grad_witness.py

Every weight is multiplied by ``1 ± 2**-23`` (a seeded sign each) and the
gradient of `make_loss_fn` is taken again; the line gives, per draw, the
largest change of a gradient leaf relative to that leaf's max. The port's
gradients can only be held to the JAX package's as closely as the JAX
package agrees with itself under such a rounding: this is the floor of the
chained gradient bounds (`GRAD_CHAIN_REL` in `tests/torch_lm.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS
from repro.configs import reduced_config as jreduced
from repro.train import steps as jsteps
from repro_torch.configs import reduced_config as treduced
from torch_lm import carried_train, paths, train_batches


def witness(arch: str, draws: int = 3) -> list[float]:
    cfg_j, cfg_t = jreduced(arch), treduced(arch)
    params, _ = carried_train(cfg_j, cfg_t)
    jb, _ = train_batches(cfg_j, cfg_t)
    grad = jax.jit(jax.grad(lambda p, b: jsteps.make_loss_fn(cfg_j)(
        p, b)[0]))
    g0 = paths(grad(params, jb))
    out = []
    for seed in range(draws):
        rng = np.random.default_rng(seed + 10)
        moved = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * jnp.asarray(
            rng.choice([-1.0, 1.0], a.shape).astype(np.float32))), params)
        g1 = paths(grad(moved, jb))
        out.append(max(float(np.abs(np.asarray(g1[k]) - np.asarray(g0[k]))
                             .max() / np.abs(np.asarray(g0[k])).max())
                       for k in g0))
    return out


if __name__ == "__main__":
    for arch in ARCHS:
        print(f"{arch:22s} " + " ".join(f"{w:.2e}" for w in witness(arch)))
