"""Seeded starts shared by both packages in the port's parity tests (not
collected).

The JAX package draws its starting factors from `jax.random`, the port
from a `torch.Generator`: the same seed gives other numbers. `use` swaps
both packages' `init_factors` (CP-ALS and CP-APR) for one numpy draw per
seed, so drivers and services that draw their own starts begin at the
same point in both packages.
"""
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr


def als_start(dims, rank, seed):
    rng = np.random.default_rng(1000 + int(seed))
    return [rng.random((int(I), rank)).astype(np.float32) for I in dims]


def apr_start(dims, rank, seed, total):
    fs = [A + np.float32(0.1) for A in als_start(dims, rank, seed)]
    fs = [(A / A.sum(axis=0, keepdims=True)).astype(np.float32) for A in fs]
    return np.full(rank, total / rank, np.float32), fs


def use(monkeypatch) -> None:
    """Patch both packages' `init_factors` for the test's duration."""

    def j_als(dims, rank, seed=0, dtype=jnp.float32):
        return [jnp.asarray(A) for A in als_start(dims, rank, seed)]

    def t_als(dims, rank, seed=0, dtype=torch.float32, device=None):
        return [torch.from_numpy(A).to(device or "cpu")
                for A in als_start(dims, rank, seed)]

    def j_apr(dims, rank, seed=0, total=1.0, dtype=jnp.float32):
        lam, fs = apr_start(dims, rank, seed, total)
        return jnp.asarray(lam), [jnp.asarray(A) for A in fs]

    def t_apr(dims, rank, seed=0, total=1.0, dtype=torch.float32,
              device=None):
        lam, fs = apr_start(dims, rank, seed, total)
        dev = device or "cpu"
        return (torch.from_numpy(lam).to(dev),
                [torch.from_numpy(A).to(dev) for A in fs])

    monkeypatch.setattr(jcpals, "init_factors", j_als)
    monkeypatch.setattr(tcpals, "init_factors", t_als)
    monkeypatch.setattr(jcpapr, "init_factors", j_apr)
    monkeypatch.setattr(tcpapr, "init_factors", t_apr)
