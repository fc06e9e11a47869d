"""Port parity: MTTKRP through each traversal, and the kernels' contracts.

The port's kernel wrappers run their plain versions on CPU tensors; they
are held against the JAX package's Pallas kernels in interpret mode on the
same inputs, handed over through `repro_torch.interop`. Tolerance
``rtol=1e-5, atol=1e-5·max|ref|``: float32 sums taken in another order.

The carry contract: plain K1 (runs + fix-up) equals plain K2 followed by
`segment_merge` bit for bit (`torch.equal`) on the adversarial run
layouts of `tests/test_oriented_carry.py`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.kernels import ops as jops
from repro.sparse import synthetic as jsyn
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import heuristics as theur
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import plan as tplan
from repro_torch.core.encoding import delinearize
from repro_torch.kernels import _build, ref as tref
from repro_torch.kernels import mttkrp as tk3
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse.tensor import SparseTensor as TSparse

DIMS = (30, 24, 20)
R = 8


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    atol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)


def _factors(dims, seed, rank=R):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((I, rank)).astype(np.float32) for I in dims]


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


@pytest.fixture(scope="module")
def pair():
    x = jsyn.blocked_tensor(DIMS, 900, block=6, n_blocks=6, seed=5,
                            count_data=True)
    jat = jalto.build(x, n_partitions=8)
    fs = _factors(DIMS, seed=6)
    return jat, _port_tensor(jat), fs


@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("traversal", ["recursive", "oriented",
                                       "oriented_carry"])
def test_mttkrp_matches_pallas_interpret(pair, mode, traversal):
    jat, at, fs = pair
    jf = [jnp.asarray(f) for f in fs]
    tf = interop.factors(fs, device="cpu")
    if traversal == "recursive":
        ref = jops.mttkrp(jat, jf, mode, r_block=4, interpret=True)
        got = tops.mttkrp(at, tf, mode, r_block=4)
    else:
        jview = jalto.oriented_view(jat, mode)
        view = _port_view(at, jview)
        jfn, tfn = {"oriented": (jops.mttkrp_oriented, tops.mttkrp_oriented),
                    "oriented_carry": (jops.mttkrp_oriented_carry,
                                       tops.mttkrp_oriented_carry)
                    }[traversal]
        ref = jfn(jview, jf, block_m=16, r_block=8, interpret=True)
        got = tfn(view, tf, block_m=16, r_block=8)
    _close(got, ref)


def _stream_tensor(row_counts, seed):
    rng = np.random.default_rng(seed)
    dims = (29, 13, 7)
    rows = np.repeat(np.arange(len(row_counts), dtype=np.int32), row_counts)
    coords = np.stack(
        [rows] + [rng.integers(0, I, size=rows.shape[0]).astype(np.int32)
                  for I in dims[1:]], axis=1)
    values = rng.standard_normal(rows.shape[0]).astype(np.float32)
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


@pytest.mark.parametrize("block_m", [8, 64])
@pytest.mark.parametrize("layout", ["identical", "distinct", "boundary_run",
                                    "mixed"])
def test_carry_equals_partials_merge(layout, block_m):
    rng = np.random.default_rng(block_m)
    x = _stream_tensor(_layout_counts(layout, block_m, rng), seed=block_m)
    at = talto.build(x, n_partitions=2, device="cpu")
    view = talto.oriented_view_device(at, 0)
    rng = np.random.default_rng(1)
    fs = [torch.from_numpy(np.abs(rng.standard_normal((I, R))).astype(
        np.float32) + 0.05) for I in x.dims]
    carry = tops.mttkrp_oriented_carry(view, fs, block_m=block_m, r_block=4)
    onehot = tops.mttkrp_oriented(view, fs, block_m=block_m, r_block=4)
    assert torch.equal(carry, onehot)
    ref = tmttkrp.mttkrp_oriented(view, fs)
    scale = float(ref.abs().max())
    assert float((carry - ref).abs().max()) / scale < 1e-5


def test_reference_traversals_match_dense_oracle(pair):
    jat, at, fs = pair
    tf = interop.factors(fs, device="cpu")
    dense = talto.to_sparse(at).todense()
    for mode in range(3):
        oracle = tmttkrp.dense_mttkrp_reference(dense, tf, mode)
        view = talto.oriented_view_device(at, mode)
        coords = at.coords()[:at.nnz]
        for got in (tmttkrp.mttkrp_recursive(at, tf, mode),
                    tmttkrp.mttkrp_oriented(view, tf),
                    tmttkrp.mttkrp_coo(coords, at.values[:at.nnz], tf,
                                       mode)):
            _close(got, oracle.numpy())


def test_kernel_plain_versions_match_oracles(pair):
    _, at, fs = pair
    tf = interop.factors(fs, device="cpu")
    m = at.meta
    np.testing.assert_array_equal(tref.ref_delinearize(m.enc, at.words),
                                  delinearize(m.enc, at.words))
    for mode in range(3):
        temp = tk3.recursive_partials(m.enc, mode, m.temp_rows[mode],
                                      at.words, at.values, at.part_start,
                                      tf)
        oracle = tref.ref_mttkrp_partials(m.enc, mode, m.temp_rows[mode],
                                          at.words, at.values,
                                          at.part_start, tf)
        assert torch.equal(temp, oracle)
        _close(tops.pull_reduction(temp, at.part_start[:, mode],
                                   m.dims[mode]),
               tref.ref_pull_reduction(oracle, at.part_start[:, mode],
                                       m.dims[mode]).numpy())


@pytest.mark.parametrize("n", [0, 5, 16, 21])
def test_pad_sorted_stream_matches_reference(n):
    rng = np.random.default_rng(n)
    rows = np.sort(rng.integers(0, 9, size=n)).astype(np.int32)
    words = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    values = rng.standard_normal(n).astype(np.float32)
    pi = rng.standard_normal((n, 3)).astype(np.float32)
    jr, jw, jv, jp = jops.pad_sorted_stream(jnp.asarray(rows),
                                            jnp.asarray(words),
                                            jnp.asarray(values), 8,
                                            pi=jnp.asarray(pi))
    view = interop.oriented_view(None, 0, rows, words, values,
                                 np.arange(n), device="cpu")
    tr, tw, tv, tp = tops.pad_sorted_stream(view.rows, view.words,
                                            view.values, 8,
                                            pi=torch.from_numpy(pi))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_plan_routes_each_traversal(pair):
    """execute_mttkrp through forced traversals: the kernel backend (plain
    versions on the CPU) agrees with the reference backend."""
    _, at, fs = pair
    tf = interop.factors(fs, device="cpu")
    base = tplan.make_plan(at.meta, R, backend="cuda")
    views = {m: talto.oriented_view_device(at, m) for m in range(3)}
    for trav in theur.Traversal:
        modes = tuple(
            tplan.ModePlan(mode=m, traversal=trav, r_block=4, block_m=16,
                           temp_rows=at.meta.temp_rows[m], threads=64)
            for m in range(3))
        kern = tplan.ExecutionPlan(at.meta, R, "cuda", modes)
        refp = tplan.ExecutionPlan(at.meta, R, "reference", modes)
        for m in range(3):
            _close(tplan.execute_mttkrp(kern, at, views, tf, m),
                   tplan.execute_mttkrp(refp, at, views, tf, m).numpy())
    assert base.backend == "cuda"


def test_plain_versions_do_not_count_on_cpu(pair):
    _, at, fs = pair
    tf = interop.factors(fs, device="cpu")
    _build.reset_counts()
    tops.mttkrp(at, tf, 0)
    tops.mttkrp_oriented_carry(talto.oriented_view_device(at, 1), tf,
                               block_m=8)
    tops.mttkrp_oriented(talto.oriented_view_device(at, 2), tf, block_m=8)
    c = _build.counts()
    assert set(c["launches"].values()) == {0}
    assert set(c["plain_on_cuda"].values()) == {0}


def test_wrappers_reject_bad_arguments(pair):
    _, at, fs = pair
    tf = interop.factors(fs, device="cpu")
    view = talto.oriented_view_device(at, 0)
    rows, words, values, _ = tops.pad_sorted_stream(view.rows, view.words,
                                                    view.values, 8)
    with pytest.raises(ValueError, match="r_block"):
        tori.carry_runs(at.meta.enc, 0, rows, words, values, tf, block_m=8,
                        r_block=3)
    with pytest.raises(ValueError, match="block_m"):
        tori.oriented_partials(at.meta.enc, 0, rows[:-1], words[:-1],
                               values[:-1], tf, block_m=8)
    with pytest.raises(TypeError, match="dtype"):
        tori.carry_runs(at.meta.enc, 0, rows, words, values.double(), tf,
                        block_m=8)
    with pytest.raises(ValueError, match="factor"):
        tk3.recursive_partials(at.meta.enc, 0, at.meta.temp_rows[0],
                               at.words, at.values, at.part_start, tf[:2])


def test_timing_stats_counts_one_run_per_call():
    before = tops.timing_runs()
    med, iqr = tops.timing_stats(lambda: sum(range(1000)), warmup=2,
                                 iters=5, device="cpu")
    assert tops.timing_runs() == before + 1
    assert med > 0 and iqr >= 0
