"""Port parity: the CP-APR Φ kernels (K5 carry, K6 partials, K7 recursive)
and the deterministic pull reduction.

The port's kernel wrappers run their plain versions on CPU tensors; they
are held against the JAX package's Pallas Φ kernels in interpret mode on
the same numpy inputs, under both Π policies. Tolerance
``max|got − want| / max|want| < 1e-5`` (the JAX package's own in
`tests/test_kernels.py`): float32 sums of the denominator and of the runs
taken in another order.

Within the port, K5 (runs + fix-up) equals K6 + `segment_merge` bit for
bit on the adversarial run layouts of `tests/test_oriented_carry.py`.

The parity tests run at ranks 5, 8 and 40: on the card those take a
partial sub-warp, a full one and two columns per lane (``csrc/
phi_scan.cuh``); here they hold the plain versions at the same ranks.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core.encoding import delinearize_np as jdelinearize_np
from repro.core.mttkrp import krp_rows as jkrp_rows
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import heuristics as theur
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import plan as tplan
from repro_torch.kernels import _build, ref as tref
from repro_torch.kernels import cpapr_phi as tk7
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse.tensor import SparseTensor as TSparse

DIMS = (30, 24, 20)
R = 8
EPS = 1e-10


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def _port_tensor(ref):
    m = ref.meta
    return interop.alto_tensor(
        np.asarray(ref.words), np.asarray(ref.values),
        np.asarray(ref.part_start), np.asarray(ref.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")


def _port_view(at, ref_view):
    return interop.oriented_view(
        at.meta, ref_view.mode, np.asarray(ref_view.rows),
        np.asarray(ref_view.words), np.asarray(ref_view.values),
        np.asarray(ref_view.perm), device="cpu")


@functools.lru_cache(maxsize=None)
def _pair(rank: int):
    x = jsyn.blocked_tensor(DIMS, 900, block=6, n_blocks=6, seed=5,
                            count_data=True)
    jat = jalto.build(x, n_partitions=8)
    rng = np.random.default_rng(6)
    fs = [rng.random((I, rank)).astype(np.float32) + 0.1 for I in DIMS]
    Bs = [rng.random((I, rank)).astype(np.float32) for I in DIMS]
    return jat, _port_tensor(jat), fs, Bs


@pytest.fixture(scope="module")
def pair():
    return _pair(R)


RANKS = [5, R, 40]


def _pi(jat, words, fs, mode):
    """Π rows (numpy) of a word stream, from the JAX package's decode."""
    coords = jdelinearize_np(jat.meta.enc, np.asarray(words))
    return np.array(jkrp_rows(jnp.asarray(coords),
                              [jnp.asarray(f) for f in fs], mode))


def _operands(policy, pi, fs):
    """(JAX kwargs, port kwargs) for one Π policy."""
    if policy == "pre":
        return dict(pi=jnp.asarray(pi)), dict(pi=torch.from_numpy(pi))
    return (dict(factors=[jnp.asarray(f) for f in fs]),
            dict(factors=interop.factors(fs, device="cpu")))


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("route", ["carry", "partials"])
@pytest.mark.parametrize("block_m", [8, 32])
@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("mode", range(3))
def test_phi_oriented_matches_pallas_interpret(mode, policy, block_m, route,
                                               rank):
    jat, at, fs, Bs = _pair(rank)
    jview = jalto.oriented_view(jat, mode)
    view = _port_view(at, jview)
    jkw, tkw = _operands(policy, _pi(jat, jview.words, fs, mode), fs)
    jfn, tfn = {"carry": (jops.cpapr_phi_oriented_carry,
                          tops.cpapr_phi_oriented_carry),
                "partials": (jops.cpapr_phi_oriented,
                             tops.cpapr_phi_oriented)}[route]
    want = jfn(jview, jnp.asarray(Bs[mode]), eps=EPS, block_m=block_m,
               interpret=True, **jkw)
    got = tfn(view, torch.from_numpy(Bs[mode]), eps=EPS, block_m=block_m,
              **tkw)
    assert got.shape == (DIMS[mode], rank)
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("mode", range(3))
def test_phi_recursive_matches_pallas_interpret(mode, policy, rank):
    jat, at, fs, Bs = _pair(rank)
    jkw, tkw = _operands(policy, _pi(jat, jat.words, fs, mode), fs)
    want = jops.cpapr_phi(jat, jnp.asarray(Bs[mode]), mode, eps=EPS,
                          interpret=True, **jkw)
    got = tops.cpapr_phi(at, torch.from_numpy(Bs[mode]), mode, eps=EPS,
                         **tkw)
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("rank", RANKS)
@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("mode", range(3))
def test_phi_partials_match_reference_oracle(mode, policy, rank):
    """K7's (L, T, R) partials against the JAX package's `ref_phi_partials`
    (plain jnp, no Pallas)."""
    jat, at, fs, Bs = _pair(rank)
    jkw, tkw = _operands(policy, _pi(jat, jat.words, fs, mode), fs)
    m = at.meta
    want = jref.ref_phi_partials(jat.meta.enc, mode, m.temp_rows[mode], EPS,
                                 jat.words, jat.values, jat.part_start,
                                 jnp.asarray(Bs[mode]), **jkw)
    got = tk7.phi_partials(m.enc, mode, m.temp_rows[mode], EPS, at.words,
                           at.values, at.part_start,
                           torch.from_numpy(Bs[mode]), **tkw)
    assert got.shape == tuple(want.shape)
    assert _rel_err(got, want) < 1e-5


def _stream_tensor(row_counts, seed):
    rng = np.random.default_rng(seed)
    dims = (29, 13, 7)
    rows = np.repeat(np.arange(len(row_counts), dtype=np.int32), row_counts)
    coords = np.stack(
        [rows] + [rng.integers(0, I, size=rows.shape[0]).astype(np.int32)
                  for I in dims[1:]], axis=1)
    values = rng.integers(1, 5, size=rows.shape[0]).astype(np.float32)
    return TSparse(dims, coords, values)


def _layout_counts(layout, block_m, rng):
    """The adversarial run layouts of tests/test_oriented_carry.py."""
    counts = np.zeros(29, dtype=np.int64)
    if layout == "identical":
        counts[int(rng.integers(29))] = 4 * block_m + 3
    elif layout == "distinct":
        counts[rng.choice(29, size=min(29, 3 * block_m), replace=False)] = 1
    elif layout == "boundary_run":
        counts[:] = rng.integers(0, 3, size=29)
        counts[int(rng.integers(29))] = 3 * block_m + 2
    else:
        counts[:] = rng.integers(0, 2 * block_m, size=29)
        counts[0] = max(counts[0], 1)
    return counts


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("block_m", [8, 64])
@pytest.mark.parametrize("layout", ["identical", "distinct", "boundary_run",
                                    "mixed"])
def test_phi_carry_equals_partials_merge(layout, block_m, policy):
    rng = np.random.default_rng(block_m)
    x = _stream_tensor(_layout_counts(layout, block_m, rng), seed=block_m)
    at = talto.build(x, n_partitions=2, device="cpu")
    view = talto.oriented_view_device(at, 0)
    rng = np.random.default_rng(1)
    fs = [torch.from_numpy(rng.random((I, R)).astype(np.float32) + 0.05)
          for I in x.dims]
    B = torch.from_numpy(rng.random((x.dims[0], R)).astype(np.float32))
    kw = (dict(factors=fs) if policy == "otf" else dict(
        pi=tmttkrp.krp_rows(tref.ref_delinearize(at.meta.enc, view.words),
                            fs, 0)))
    carry = tops.cpapr_phi_oriented_carry(view, B, block_m=block_m, **kw)
    onehot = tops.cpapr_phi_oriented(view, B, block_m=block_m, **kw)
    assert torch.equal(carry, onehot)
    ref = tmttkrp.row_reduce_oriented(view, tmttkrp.phi_contributions(
        at.meta.enc, 0, view.words, view.values, view.rows, B, eps=EPS,
        **kw))
    assert float((carry - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("seed", range(3))
def test_pull_reduction_matches_index_add(seed):
    """The fixed-order pull against the `index_add_` pull it replaced,
    with partitions overlapping rows and intervals clamped at the last
    row."""
    rng = np.random.default_rng(seed)
    L, T, out_dim = 9, 7, 20
    start = torch.from_numpy(rng.integers(0, out_dim, size=L).astype(
        np.int32))
    temp = torch.from_numpy(rng.standard_normal((L, T, 5)).astype(
        np.float32))
    rows = (start.long()[:, None] + torch.arange(T)[None, :])
    temp[(rows >= out_dim)] = 0.0           # rows past the last hold zeros
    got = tops.pull_reduction(temp, start, out_dim)
    old = torch.zeros((out_dim, 5)).index_add_(
        0, rows.clamp_max(out_dim - 1).reshape(-1), temp.reshape(-1, 5))
    torch.testing.assert_close(got, old, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, tref.ref_pull_reduction(temp, start, out_dim))
    assert torch.equal(got, tmttkrp.pull_rows(temp, start, out_dim))


def test_carry_fixup_takes_one_or_two_slots():
    """One slot per piece (the pull's sorted pieces) or K1's two slots;
    any other layout is refused."""
    rows = torch.tensor([[0], [2], [2], [2], [5]], dtype=torch.int32)
    vals = torch.arange(15, dtype=torch.float32).reshape(5, 1, 3)
    got = tori.carry_fixup(rows, vals, torch.zeros((6, 3)))
    want = torch.zeros((6, 3)).index_add_(0, rows.reshape(-1).long(),
                                          vals.reshape(5, 3))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="slots"):
        tori.carry_fixup(rows.expand(5, 3).contiguous(),
                         vals.expand(5, 3, 3).contiguous(),
                         torch.zeros((6, 3)))


@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_execute_phi_routes_each_traversal(pair, policy):
    """execute_phi through forced traversals: the kernel backend (plain
    versions on the CPU) agrees with the reference backend."""
    jat, at, fs, Bs = pair
    views = {m: talto.oriented_view_device(at, m) for m in range(3)}
    for trav in theur.Traversal:
        modes = tuple(
            tplan.ModePlan(mode=m, traversal=trav, r_block=R, block_m=16,
                           temp_rows=at.meta.temp_rows[m], threads=64)
            for m in range(3))
        kern = tplan.ExecutionPlan(at.meta, R, "cuda", modes)
        refp = tplan.ExecutionPlan(at.meta, R, "reference", modes)
        for m in range(3):
            words = (views[m].words if theur.is_oriented(trav)
                     else at.words)
            kw = (dict(factors=interop.factors(fs, device="cpu"))
                  if policy == "otf"
                  else dict(pi=torch.from_numpy(_pi(jat, words, fs, m))))
            B = torch.from_numpy(Bs[m])
            got = tplan.execute_phi(kern, at, views[m], B, m, **kw)
            want = tplan.execute_phi(refp, at, views[m], B, m, **kw)
            assert _rel_err(got, want.numpy()) < 1e-5


def test_phi_wrappers_reject_bad_arguments(pair):
    _, at, fs, Bs = pair
    tf = interop.factors(fs, device="cpu")
    B = torch.from_numpy(Bs[0])
    view = talto.oriented_view_device(at, 0)
    rows, words, values, _ = tops.pad_sorted_stream(view.rows, view.words,
                                                    view.values, 8)
    enc = at.meta.enc
    with pytest.raises(ValueError, match="whole rank"):
        tori.phi_carry_runs(enc, 0, EPS, rows, words, values, B, tf,
                            block_m=8, r_block=4)
    with pytest.raises(ValueError, match="exactly one"):
        tori.phi_oriented_partials(enc, 0, EPS, rows, words, values, B,
                                   block_m=8)
    with pytest.raises(ValueError, match="exactly one"):
        tops.cpapr_phi(at, B, 0, factors=tf,
                       pi=torch.zeros((at.words.shape[0], R)))
    with pytest.raises(ValueError, match="shape"):
        tk7.phi_partials(enc, 0, at.meta.temp_rows[0], EPS, at.words,
                         at.values, at.part_start, B,
                         pi=torch.zeros((3, R)))
    with pytest.raises(ValueError, match="shape"):
        tori.phi_carry_runs(enc, 0, EPS, rows, words, values, B[:-1], tf,
                            block_m=8)


def test_plain_phi_versions_do_not_count_on_cpu(pair):
    _, at, fs, Bs = pair
    tf = interop.factors(fs, device="cpu")
    _build.reset_counts()
    tops.cpapr_phi(at, torch.from_numpy(Bs[0]), 0, factors=tf)
    tops.cpapr_phi_oriented_carry(talto.oriented_view_device(at, 1),
                                  torch.from_numpy(Bs[1]), factors=tf,
                                  block_m=8)
    tops.delinearize(at.meta.enc, at.words)
    c = _build.counts()
    assert set(c["launches"].values()) == {0}
    assert set(c["plain_on_cuda"].values()) == {0}
