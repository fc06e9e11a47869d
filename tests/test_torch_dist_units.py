"""Unit tests of the port's distributed seam (`repro_torch.dist.cpd`), the
cases of ``tests/test_dist_units.py`` plus the port against the JAX
package slice by slice.

The shard-local reductions are pure functions of a contiguous slice of
the row-sorted stream, so most cases cut the stream here and sum the
slices in this process, which is the sum ``all_reduce`` computes. The
collective wrappers run on a one-rank gloo group in this process (file
rendezvous in the test's directory); ``tests/test_torch_distributed.py``
runs several ranks. The kernel backend runs the kernels' plain versions
on these CPU tensors. Property cases run on the hermetic
``tests/proptest.py``.

Tolerances: sums of slices against the dense oracle within 1e-5 of its
largest entry (float32 sums in another order); the port's `local_mttkrp`
and `local_phi` against the JAX package's on the same slice within
``rtol=1e-5`` (``atol`` 1e-5 of the largest entry); Grams within 1e-4.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from proptest import given, settings, strategies as st
from repro.core import alto as jalto
from repro.core import autotune as jautotune
from repro.core import plan as jplan
from repro.dist import cpd as jcpd
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto, autotune, heuristics
from repro_torch.core import mttkrp as cm
from repro_torch.core import plan as plan_mod
from repro_torch.dist import cpd
from repro_torch.kernels import ops
from repro_torch.sparse import synthetic
from repro_torch.sparse.tensor import SparseTensor

TOL = 1e-5
BACKENDS = ["reference", "cuda"]


def _factors(dims, R, seed=0, positive=False):
    rng = np.random.default_rng(seed)
    fs = [rng.standard_normal((I, R)).astype(np.float32) for I in dims]
    return [torch.from_numpy(np.abs(A) if positive else A) for A in fs]


def _slices(plan, view, mode, D, pi=None):
    """The D contiguous slices of the mode's padded stream, as the ranks
    of a D-rank group cut it."""
    rows, words, values, pi = ops.pad_sorted_stream(
        view.rows, view.words, view.values, D * (
            plan.modes[mode].block_m if plan.backend == "cuda" else 1),
        pi=pi)
    for r in range(D):
        sl = cpd._slice(rows.shape[0], D, r)
        yield (rows[sl], words[sl], values[sl],
               None if pi is None else pi[sl])


def _sharded_sum(plan, view, factors, mode, D):
    out = None
    for rows, words, values, _ in _slices(plan, view, mode, D):
        part = cpd.local_mttkrp(plan, mode, rows, words, values, factors)
        # Full width, zeros off the slice's rows (above its last row too).
        off = torch.ones(part.shape[0], dtype=torch.bool)
        off[int(rows.min()):int(rows.max()) + 1] = False
        assert not bool(part[off].any())
        out = part if out is None else out + part
    return out


def _rel_err(out, ref):
    return float((out - ref).abs().max()) / (float(ref.abs().max()) + 1e-9)


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["uniform", "single_row", "tiny_nnz"])
def test_shard_boundary_carries(backend, case):
    """The slices' sum equals the dense oracle, with one row spanning
    every slice and slices made only of padding."""
    dims, R, D = (17, 9, 5), 6, 4
    if case == "uniform":
        x = synthetic.uniform_tensor(dims, 300, seed=0)
    elif case == "single_row":
        rng = np.random.default_rng(1)
        coords = np.stack([np.full(64, 4),
                           rng.integers(0, dims[1], 64),
                           rng.integers(0, dims[2], 64)], axis=1)
        x = SparseTensor(dims, coords.astype(np.int32),
                         rng.standard_normal(64).astype(np.float32)
                         ).deduplicate()
    else:       # fewer nonzeros than slices: padding-only slices
        coords = np.array([[0, 0, 0], [16, 8, 4]], np.int32)
        x = SparseTensor(dims, coords, np.array([1.5, -2.0], np.float32))
    at = alto.build_device(x, n_partitions=2, device="cpu")
    factors = _factors(dims, R)
    plan = plan_mod.make_plan(at.meta, R, backend=backend, shards=D)
    dense = x.todense()
    for mode in range(len(dims)):
        view = alto.oriented_view_device(at, mode)
        ref = cm.dense_mttkrp_reference(dense, factors, mode)
        out = _sharded_sum(plan, view, factors, mode, D)
        assert _rel_err(out, ref) < TOL, (case, backend, mode)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_shards=st.integers(1, 9),
       zipf=st.booleans())
def test_shard_carries_property(seed, n_shards, zipf):
    """Random streams, skewed ones included: the slices' sum equals the
    oracle for every mode and shard count, on both backends."""
    dims, R = (12, 8, 6), 5
    gen = synthetic.zipf_tensor if zipf else synthetic.uniform_tensor
    x = gen(dims, 150, seed=seed)
    at = alto.build_device(x, n_partitions=2, device="cpu")
    factors = _factors(dims, R, seed=seed % 100)
    dense = x.todense()
    for backend in BACKENDS:
        plan = plan_mod.make_plan(at.meta, R, backend=backend,
                                  shards=n_shards)
        for mode in range(3):
            view = alto.oriented_view_device(at, mode)
            ref = cm.dense_mttkrp_reference(dense, factors, mode)
            out = _sharded_sum(plan, view, factors, mode, n_shards)
            assert _rel_err(out, ref) < TOL


@settings(max_examples=10, deadline=None)
@given(rows=st.integers(1, 50), rank=st.integers(1, 8),
       n_shards=st.integers(1, 7), seed=st.integers(0, 2**31 - 1))
def test_sharded_gram_equivalence(rows, rank, n_shards, seed):
    """Row slices' Grams, zero-row padding included, sum to AᵀA."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((rows, rank)).astype(np.float32))
    pad = (-rows) % n_shards
    Ap = torch.cat([A, A.new_zeros((pad, rank))]) if pad else A
    acc = sum(cpd.local_gram(Ap[cpd._slice(Ap.shape[0], n_shards, s)])
              for s in range(n_shards))
    torch.testing.assert_close(acc, A.T @ A, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("phi", [False, True])
@pytest.mark.parametrize("carry", [True, False])
def test_slice_kernels_run_on_the_row_window(carry, phi, monkeypatch):
    """On the kernel backend a slice's kernels get its row window: rows
    relative to the slice's first row, ``n_rows`` (or the split's
    ``out_dim``) its last row − first row + 1, B cut to the window. The
    runs passes and the split store the zeros of the rows a stream skips
    one sub-warp per gap, so at the mode's full extent the rows below and
    above a slice went to one sub-warp each (DARPA mode 2 on 2 slices:
    ~200 ms a K1 launch, 600 ms a split, against ~1 ms). The result is
    the full-width run of the same kernels on the slice bit for bit, with
    zeros off the window."""
    from repro_torch.kernels import mttkrp_oriented as kori
    x = synthetic.uniform_tensor((40, 9, 7), 400, seed=6, count_data=True)
    at = alto.build_device(x, n_partitions=2, device="cpu")
    R, D, mode, eps = 4, 4, 0, 1e-10
    factors = _factors(x.dims, R, seed=3, positive=True)
    B = factors[mode] + 0.5
    trav = (heuristics.Traversal.ORIENTED_CARRY if carry
            else heuristics.Traversal.OUTPUT_ORIENTED)
    plan = plan_mod.make_plan(at.meta, R, backend="cuda", shards=D)
    plan = plan_mod.ExecutionPlan(**{**vars(plan), "modes": tuple(
        plan_mod.ModePlan(**{**vars(mp), "traversal": trav})
        for mp in plan.modes)})
    bm = plan.modes[mode].block_m
    seen = []
    for name in ("carry_runs", "phi_carry_runs", "segment_split",
                 "phi_oriented_partials"):
        real = getattr(kori, name)

        def spy(*a, _real=real, _name=name, **k):
            bound = inspect.signature(_real).bind(*a, **k)
            seen.append((_name, bound.arguments))
            return _real(*a, **k)
        monkeypatch.setattr(kori, name, spy)
    view = alto.oriented_view_device(at, mode)
    lows = []
    for rows, words, values, _ in _slices(plan, view, mode, D):
        lo, hi = int(rows[0]), int(rows[-1])
        lows.append(lo)
        seen.clear()
        if phi:
            got = cpd.local_phi(plan, mode, eps, rows, words, values, B,
                                factors=factors)
            calls = list(seen)
            full = (kori.phi_oriented_carry(
                at.meta.enc, mode, eps, rows, words, values, B,
                factors=factors, block_m=bm) if carry else
                ops.segment_merge(kori.phi_oriented_partials(
                    at.meta.enc, mode, eps, rows, words, values, B,
                    factors=factors, block_m=bm), rows, at.dims[mode]))
        else:
            got = cpd.local_mttkrp(plan, mode, rows, words, values, factors)
            calls = list(seen)
            full = (kori.mttkrp_oriented_carry(
                at.meta.enc, mode, rows, words, values, factors, bm)
                if carry else ops.segment_merge(kori.oriented_partials(
                    at.meta.enc, mode, rows, words, values, factors, bm),
                    rows, at.dims[mode]))
        assert torch.equal(got, full)
        assert not bool(got[:lo].any()) and not bool(got[hi + 1:].any())
        assert calls
        for name, arg in calls:
            window = arg.get("out_dim" if name == "segment_split"
                             else "n_rows")
            assert window == hi - lo + 1, name
            assert int(arg["rows"][0]) == 0
            assert int(arg["rows"][-1]) == hi - lo
            if "B" in arg:
                assert arg["B"].shape[0] == hi - lo + 1
    assert max(lows) > 0


def test_slice_windows_read_once_per_view():
    """`sharded_mttkrp` reads each view's slice windows back once
    (memoized per view), and they are each slice's `_row_window`, the
    padding and a padding-only slice included."""
    x = SparseTensor((20, 5, 4), np.array([[2, 0, 0], [2, 1, 1], [7, 2, 3],
                                            [19, 4, 0]], np.int32),
                     np.float32([1, 2, 3, 4]))
    at = alto.build_device(x, n_partitions=1, device="cpu")
    view = alto.oriented_view_device(at, 0)
    for D in (1, 2, 3, 5):
        rows, _, _, _ = ops.pad_sorted_stream(view.rows, view.words,
                                              view.values, D * 8)
        wins = cpd._slice_windows(view.rows, rows.shape[0], D)
        assert wins == [cpd._row_window(rows[cpd._slice(rows.shape[0], D,
                                                        r)])
                        for r in range(D)]
        assert cpd._slice_windows(view.rows, rows.shape[0], D) is wins


def test_row_window_checks():
    """A row window must fit the mode and is refused for a bucket."""
    from repro_torch.kernels import mttkrp_oriented as kori
    x = synthetic.uniform_tensor((10, 8, 6), 60, seed=1)
    at = alto.build_device(x, n_partitions=2, device="cpu")
    view = alto.oriented_view_device(at, 0)
    rows, words, values, _ = ops.pad_sorted_stream(view.rows, view.words,
                                                   view.values, 8)
    fs = _factors(x.dims, 4)
    with pytest.raises(ValueError, match="row window"):
        kori.carry_runs(at.meta.enc, 0, rows, words, values, fs, 8,
                        n_rows=11)
    with pytest.raises(ValueError, match="bucket"):
        kori.carry_runs(at.meta.enc, 0, rows[None], words[None],
                        values[None], [f[None] for f in fs], 8, n_rows=5)


def test_sharded_gram_on_group(group):
    """On one rank `sharded_gram` is ``A.T @ A`` bit for bit."""
    A = _factors((13,), 4)[0]
    assert torch.equal(cpd.sharded_gram(A, group=group), A.T @ A)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_mttkrp_on_group(group, backend):
    """`execute_mttkrp` routes a sharded plan through `sharded_mttkrp`;
    `build_views` gives it every mode; on one rank the result is the
    single-device run of the same plan bit for bit."""
    x = synthetic.uniform_tensor((11, 7, 5), 120, seed=2)
    at = alto.build_device(x, n_partitions=2, device="cpu")
    factors = _factors(x.dims, 4)
    plan = plan_mod.make_plan(at.meta, 4, backend=backend, shards=1)
    views = plan_mod.build_views(at, plan)
    assert set(views) == {0, 1, 2}
    single = plan_mod.ExecutionPlan(**{**vars(plan), "shards": None})
    dense = x.todense()
    for mode in range(3):
        out = plan_mod.execute_mttkrp(plan, at, views, factors, mode)
        assert torch.equal(out, plan_mod.execute_mttkrp(single, at, views,
                                                        factors, mode))
        ref = cm.dense_mttkrp_reference(dense, factors, mode)
        assert _rel_err(out, ref) < TOL


def _phi_case():
    dims, R = (14, 9, 6), 5
    x = synthetic.uniform_tensor(dims, 250, seed=4, count_data=True)
    at = alto.build_device(x, n_partitions=2, device="cpu")
    rng = np.random.default_rng(0)
    B = torch.from_numpy(np.abs(rng.standard_normal((dims[0], R))
                                ).astype(np.float32))
    return at, B, _factors(dims, R, seed=1, positive=True)


def _phi_oracle(at, view, B, factors, mode):
    coords = ops.delinearize(at.meta.enc, view.words)
    krp = cm.krp_rows(coords, factors, mode)
    denom = torch.clamp_min((B[view.rows.long()] * krp).sum(-1), 1e-10)
    contrib = (view.values / denom)[:, None] * krp
    return torch.zeros((at.dims[mode], B.shape[1])).index_add_(
        0, view.rows.long(), contrib), krp


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pre", [True, False])
def test_shard_phi_carries(backend, pre):
    """The Φ slices' sum equals the unsharded Φ, for both Π policies (Π
    cut with the stream) and both backends."""
    at, B, factors = _phi_case()
    mode, D = 0, 4
    view = alto.oriented_view_device(at, mode)
    ref, krp = _phi_oracle(at, view, B, factors, mode)
    plan = plan_mod.make_plan(at.meta, B.shape[1], backend=backend, shards=D)
    out = None
    for rows, words, values, pi in _slices(plan, view, mode, D,
                                           krp if pre else None):
        part = cpd.local_phi(plan, mode, 1e-10, rows, words, values, B,
                             factors=None if pre else factors, pi=pi)
        out = part if out is None else out + part
    assert _rel_err(out, ref) < TOL


@pytest.mark.parametrize("pre", [True, False])
def test_sharded_phi_on_group(group, pre):
    """`execute_phi` routes a sharded plan through `sharded_phi`; on one
    rank the result is the single-device run of the same plan bit for
    bit."""
    at, B, factors = _phi_case()
    mode = 0
    plan = plan_mod.make_plan(at.meta, B.shape[1], backend="cuda", shards=1)
    view = plan_mod.build_views(at, plan)[mode]
    single = plan_mod.ExecutionPlan(**{**vars(plan), "shards": None})
    ref, krp = _phi_oracle(at, view, B, factors, mode)
    kw = dict(pi=krp) if pre else dict(factors=factors)
    out = plan_mod.execute_phi(plan, at, view, B, mode, **kw)
    assert torch.equal(out, plan_mod.execute_phi(single, at, view, B, mode,
                                                 **kw))
    assert _rel_err(out, ref) < TOL


def test_sharded_plan_resolution():
    """A sharded plan orients every mode (one-hot or carry by the model),
    sizes ``block_m`` on one rank's share of the stream (never above the
    single-device plan's), and refuses to stream."""
    x = synthetic.blocked_tensor((64, 48, 32), 20_000, seed=0)
    at = alto.build_device(x, n_partitions=8, device="cpu")
    single = plan_mod.make_plan(at.meta, 16, backend="cuda")
    assert not all(heuristics.is_oriented(m.traversal) for m in single.modes)
    for D in (1, 2, 8):
        sp = plan_mod.make_plan(at.meta, 16, backend="cuda", shards=D)
        assert sp.shards == D and single.shards is None
        for n, (ms, mp) in enumerate(zip(single.modes, sp.modes)):
            assert heuristics.is_oriented(mp.traversal)
            assert mp.traversal is heuristics.choose_oriented_variant(
                at.meta, n, 16, dtype_bytes=4)
            assert mp.block_m <= ms.block_m
    # A DARPA-sized stream (meta only): each rank's card gets 1/D of it.
    meta = interop.alto_meta((22476, 22476, 23776223), 28_436_033, 1024,
                             (64, 64, 65536), (1.0, 1.0, 1.0))
    bms = [plan_mod.make_plan(meta, 16, backend="cuda", shards=D)
           .modes[0].block_m for D in (1, 2, 4, 8)]
    assert bms == [plan_mod.choose_block_m(meta, 16, D) for D in (1, 2, 4, 8)]
    assert bms == sorted(bms, reverse=True) and bms[0] > bms[-1]
    assert bms[0] == plan_mod.make_plan(meta, 16, backend="cuda"
                                        ).modes[0].block_m
    with pytest.raises(ValueError, match="streaming"):
        plan_mod.make_plan(at.meta, 16, backend="cuda", shards=2,
                           device_bytes=1)
    for bad in (0, -1, True, 1.5):
        with pytest.raises(ValueError):
            plan_mod.make_plan(at.meta, 16, backend="cuda", shards=bad)


def test_sharded_plan_hashing():
    """Sharded plans stay hashable: equal inputs give equal plans, and a
    one-rank sharded plan is not the single-device plan."""
    x = synthetic.uniform_tensor((10, 8, 6), 100, seed=1)
    at = alto.build_device(x, n_partitions=4, device="cpu")
    p1 = plan_mod.make_plan(at.meta, 4, shards=1, backend="cuda")
    p2 = plan_mod.make_plan(at.meta, 4, shards=1, backend="cuda")
    p0 = plan_mod.make_plan(at.meta, 4, backend="cuda")
    assert p1 == p2 and hash(p1) == hash(p2)
    assert p1 != p0 and p1 != plan_mod.make_plan(at.meta, 4, shards=2,
                                                 backend="cuda")
    cache = {p1: "sharded", p0: "local"}
    assert cache[p2] == "sharded" and len(cache) == 2


def test_sharded_route_needs_a_group():
    x = synthetic.uniform_tensor((10, 8, 6), 100, seed=1)
    at = alto.build_device(x, n_partitions=4, device="cpu")
    p = plan_mod.make_plan(at.meta, 4, shards=1, backend="cuda")
    with pytest.raises(RuntimeError, match="process group"):
        plan_mod.execute_mttkrp(p, at, plan_mod.build_views(at, p),
                                _factors(x.dims, 4), 0)


# ---------------------------------------------------------------------------
# The port's shard-local functions against the JAX package's
# ---------------------------------------------------------------------------

def _jax_and_port(dims, nnz, seed, count_data=False):
    x = jsyn.uniform_tensor(dims, nnz, seed=seed, count_data=count_data)
    jat = jalto.build(x, n_partitions=2)
    m = jat.meta
    at = interop.alto_tensor(
        np.asarray(jat.words), np.asarray(jat.values),
        np.asarray(jat.part_start), np.asarray(jat.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")
    return jat, at


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("D", [2, 3])
def test_local_mttkrp_matches_jax(backend, D):
    """The port's `local_mttkrp` on each slice against JAX
    `dist.cpd.local_mttkrp` (reference backend) on the same slice."""
    jat, at = _jax_and_port((13, 9, 7), 220, seed=3)
    fs = [np.asarray(A) for A in _factors(at.dims, 5, seed=2)]
    jp = jplan.make_plan(jat.meta, 5, mesh=jax.make_mesh((1,), ("data",)),
                         backend="reference")
    tp = plan_mod.make_plan(at.meta, 5, backend=backend, shards=D)
    for mode in range(3):
        view = alto.oriented_view_device(at, mode)
        for rows, words, values, _ in _slices(tp, view, mode, D):
            ref = jcpd.local_mttkrp(
                jp, mode, jnp.asarray(rows.numpy()),
                jnp.asarray(words.numpy().view(np.uint32)),
                jnp.asarray(values.numpy()), [jnp.asarray(A) for A in fs])
            got = cpd.local_mttkrp(tp, mode, rows, words, values,
                                   interop.factors(fs, device="cpu"))
            _close(got, ref)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pre", [True, False])
def test_local_phi_matches_jax(backend, pre):
    """The port's `local_phi` on each slice against JAX
    `dist.cpd.local_phi` (reference backend), under ALTO-OTF and ALTO-PRE
    (the slice's Π rows)."""
    jat, at = _jax_and_port((12, 8, 6), 200, seed=5, count_data=True)
    R, D, eps = 4, 3, 1e-10
    fs = [np.abs(np.asarray(A)) for A in _factors(at.dims, R, seed=4)]
    jp = jplan.make_plan(jat.meta, R, mesh=jax.make_mesh((1,), ("data",)),
                         backend="reference")
    tp = plan_mod.make_plan(at.meta, R, backend=backend, shards=D)
    tfs = interop.factors(fs, device="cpu")
    for mode in range(3):
        B = np.abs(fs[mode]) + np.float32(0.1)
        view = alto.oriented_view_device(at, mode)
        krp = cm.krp_rows(ops.delinearize(at.meta.enc, view.words), tfs,
                          mode) if pre else None
        for rows, words, values, pi in _slices(tp, view, mode, D, krp):
            ref = jcpd.local_phi(
                jp, mode, eps, jnp.asarray(rows.numpy()),
                jnp.asarray(words.numpy().view(np.uint32)),
                jnp.asarray(values.numpy()), jnp.asarray(B),
                factors=None if pre else [jnp.asarray(A) for A in fs],
                pi=jnp.asarray(pi.numpy()) if pre else None)
            got = cpd.local_phi(tp, mode, eps, rows, words, values,
                                torch.from_numpy(B),
                                factors=None if pre else tfs, pi=pi)
            _close(got, ref)


# ---------------------------------------------------------------------------
# The plan store's shard count
# ---------------------------------------------------------------------------

def _reuse_tensor():
    """Modes 0 and 2 reuse fibers: the static single-device plan routes
    them recursive."""
    x = synthetic.uniform_tensor((30, 4, 20), 900, seed=2, count_data=True)
    return alto.build_device(x, n_partitions=8, device="cpu")


def test_store_keeps_shards_apart(tmp_path):
    """A one-rank sharded plan has a key of its own; a single-device
    record with a recursive mode is a miss for a sharded lookup even
    under the sharded key."""
    at = _reuse_tensor()
    store = tmp_path / "plans.json"
    single = plan_mod.make_plan(at.meta, 4, backend="cuda")
    assert "recursive" in single.traversals()
    key0 = autotune.plan_key(at.meta, 4, "cuda", device="cpu")
    key1 = autotune.plan_key(at.meta, 4, "cuda", device="cpu", shards=1)
    assert key0 != key1
    record = autotune.serialize_plan(single)
    autotune.save_store({key0: record, key1: record}, store)
    assert autotune.lookup(at.meta, 4, backend="cuda", device="cpu",
                           path=store) == single
    assert autotune.lookup(at.meta, 4, backend="cuda", device="cpu",
                           path=store, shards=1) is None
    sharded = plan_mod.make_plan(at.meta, 4, backend="cuda", shards=1)
    autotune.save_store({key1: autotune.serialize_plan(sharded)}, store)
    assert autotune.lookup(at.meta, 4, backend="cuda", device="cpu",
                           path=store, shards=1) == sharded
    assert autotune.lookup(at.meta, 4, backend="cuda", device="cpu",
                           path=store) is None


def test_sharded_tune_on_group(group, tmp_path, monkeypatch):
    """``tune="search"`` on a sharded plan takes the exhaustive tuner;
    the winner is oriented on every mode, stored under the sharded key,
    and a second make is a store hit with no timing run; the
    single-device store entry is untouched."""
    from repro_torch.core import search
    monkeypatch.setattr(search, "search_plan", lambda *a, **k: pytest.fail(
        "the search ran for a sharded plan"))
    at = _reuse_tensor()
    store = tmp_path / "plans.json"
    p = plan_mod.make_plan(at.meta, 4, backend="cuda", shards=1,
                           tune="search", at=at, store_path=store)
    assert p.shards == 1
    assert all(heuristics.is_oriented(m.traversal) for m in p.modes)
    plans = autotune.load_store(store)
    assert list(plans) == [autotune.plan_key(at.meta, 4, "cuda",
                                             device="cpu", shards=1)]
    runs = ops.timing_runs()
    assert plan_mod.make_plan(at.meta, 4, backend="cuda", shards=1,
                              tune="force", device="cpu",
                              store_path=store) == p
    assert ops.timing_runs() == runs


def test_jax_one_device_mesh_key_collision(tmp_path):
    """The reference keys a one-device mesh plan as a single-device plan
    (``shards=1`` in both), so a stored single-device plan with recursive
    modes loads into a mesh plan, whose sharded MTTKRP then has no view
    for them and raises. The port keys them apart (above). The JAX
    package is left as it is: this records its behaviour."""
    store = tmp_path / "plans.json"
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=2, count_data=True)
    jat = jalto.build(x, n_partitions=8)
    # What a single-device tune stores when the static plan wins.
    single = jplan.make_plan(jat.meta, 4, backend="reference")
    assert "recursive" in single.traversals()
    jautotune.save_store({jautotune.plan_key(jat.meta, 4, "reference"):
                          jautotune.serialize_plan(single)}, store)
    mesh = jax.make_mesh((1,), ("data",))
    meshed = jplan.make_plan(jat.meta, 4, backend="reference", mesh=mesh,
                             tune="auto", store_path=store)
    assert meshed.mesh is not None
    assert meshed.traversals() == single.traversals()
    views = jplan.build_views(jat, meshed)
    fs = [jnp.ones((I, 4)) for I in jat.dims]
    with pytest.raises(ValueError, match="orient every mode"):
        jplan.execute_mttkrp(meshed, jat, views, fs, 0)
