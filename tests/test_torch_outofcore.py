"""Port parity: the out-of-core tier — chunk kernels K8 / K9, the chunked
executors, streaming plans, and the streamed drivers.

The port's kernel wrappers run their plain versions on CPU tensors. They
are held against the JAX package's chunked executors (Pallas in
interpret mode) on the same numpy inputs within ``rtol=1e-5,
atol=1e-5·max|ref|`` (float32 sums in another order), and — the bitwise
fence — against the port's own in-core carry path with ``torch.equal``,
on the adversarial layouts of `tests/test_outofcore.py` with chunks of 1,
2 and 3 blocks.

End to end: streamed `cp_als` and `cp_apr` equal the port's in-core runs
of the same plan bit for bit; streamed `cp_als` is within 1e-4 in fit of
the JAX package's IN-CORE `cp_als` (its chunked CP-ALS is not bitwise
with its in-core one, ROADMAP queue 3), streamed `cp_apr` within 1e-5
relative in log-likelihood of the JAX package's streamed `cp_apr`.

CPU ``index_add_`` sums are not bit-repeatable with several threads, so
every test here runs with one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro.core import plan as jplan
from repro.kernels import ops as jops
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import plan as tplan
from repro_torch.core import stream as tstream
from repro_torch.kernels import _build
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse.tensor import SparseTensor as TSparse

DIMS = (29, 13, 7)          # mode 0 is the reduction target
MODE = 0
BM = 8                      # the smallest block: the most boundaries
R = 8
EPS = 1e-10
LAYOUTS = ["span_all_chunks", "distinct", "duplicates_heavy", "mixed"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout_counts(layout, rng):
    """Row multiplicities of the adversarial chunk layouts."""
    counts = np.zeros(DIMS[0], dtype=np.int64)
    if layout == "span_all_chunks":     # one run across every chunk
        counts[int(rng.integers(DIMS[0]))] = 5 * BM + 3
    elif layout == "distinct":          # the carry closes at every boundary
        counts[rng.choice(DIMS[0], size=min(DIMS[0], 3 * BM),
                          replace=False)] = 1
    elif layout == "duplicates_heavy":  # few rows, runs over boundaries
        counts[rng.choice(DIMS[0], size=3, replace=False)] = rng.integers(
            BM, 3 * BM, size=3)
    else:
        counts[:] = rng.integers(0, 2 * BM, size=DIMS[0])
        counts[0] = max(counts[0], 1)
    return counts


def _coo(counts, seed, count_data=True):
    """(coords, values) whose mode-0 rows appear ``counts`` times."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(DIMS[0], dtype=np.int32), counts)
    coords = np.stack(
        [rows] + [rng.integers(0, I, size=rows.shape[0]).astype(np.int32)
                  for I in DIMS[1:]], axis=1)
    if count_data:
        values = rng.integers(1, 5, size=rows.shape[0]).astype(np.float32)
    else:
        values = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return coords, values


def _factors(seed, rank=R):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal((I, rank))).astype(np.float32) + 0.05
            for I in DIMS]


def _tensor(counts, seed, count_data=True):
    coords, values = _coo(counts, seed, count_data)
    return talto.build(TSparse(DIMS, coords, values), n_partitions=2,
                       device="cpu")


def _pi(at, words, fs, mode=MODE):
    return tmttkrp.krp_rows(tops.delinearize(at.meta.enc, words), fs,
                            mode).contiguous()


# ---------------------------------------------------------------------------
# The bitwise fence: chunked == in-core carry, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_block", [4, 8])
@pytest.mark.parametrize("chunk_blocks", [1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mttkrp_chunked_bitwise(layout, chunk_blocks, r_block):
    seed = LAYOUTS.index(layout) * 10 + chunk_blocks
    at = _tensor(_layout_counts(layout, np.random.default_rng(seed)), seed,
                 count_data=False)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(seed)]
    incore = tops.mttkrp_oriented_carry(view, fs, block_m=BM,
                                        r_block=r_block)
    chunked = tops.mttkrp_oriented_chunked(view, fs,
                                           chunk_m=chunk_blocks * BM,
                                           block_m=BM, r_block=r_block)
    assert torch.equal(incore, chunked)
    ref = tmttkrp.mttkrp_oriented(view, fs)
    assert float((chunked - ref).abs().max()) / float(ref.abs().max()) \
        < 1e-5


@pytest.mark.parametrize("policy", ["pre", "otf"])
@pytest.mark.parametrize("chunk_blocks", [1, 2, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_phi_chunked_bitwise(layout, chunk_blocks, policy):
    """Under ALTO-PRE the chunk's Π rows are rebuilt from its words: a
    padded element's row is not zero as in core, but its value is, so
    the result is still the in-core one bit for bit."""
    seed = 100 + LAYOUTS.index(layout) * 10 + chunk_blocks
    at = _tensor(_layout_counts(layout, np.random.default_rng(seed)), seed)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(seed)]
    B = fs[MODE] + 0.1
    kw = dict(pi=_pi(at, view.words, fs)) if policy == "pre" \
        else dict(factors=fs)
    incore = tops.cpapr_phi_oriented_carry(view, B, block_m=BM, **kw)
    chunked = tops.cpapr_phi_oriented_chunked(
        view, B, fs, pre=policy == "pre", chunk_m=chunk_blocks * BM,
        block_m=BM)
    assert torch.equal(incore, chunked)


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("kernel", ["carry_chunk", "phi_carry_chunk"])
def test_chunk_kernel_contract(kernel, final):
    """One K8 / K9 call on a mid-stream chunk: a carry-in joining the
    first run starts its chain, a non-final chunk hands its last run on,
    a final one stores it and leaves an empty carry."""
    at = _tensor(_layout_counts("mixed", np.random.default_rng(3)), 3)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(3)]
    rows, words, values, _ = tops.pad_sorted_stream(view.rows, view.words,
                                                    view.values, BM)
    s, e = 2 * BM, 5 * BM
    out = torch.zeros((DIMS[MODE], R))
    crow = rows[s:s + 1].clone()
    cval = torch.full((1, R), 0.25)
    if kernel == "carry_chunk":
        terms = tmttkrp.contributions(at.meta.enc, words[s:e], values[s:e],
                                      fs, MODE)
        got = tori.carry_chunk(at.meta.enc, MODE, rows[s:e], words[s:e],
                               values[s:e], fs, out, crow, cval,
                               block_m=BM, r_block=4, final=final)
    else:
        B = fs[MODE] + 0.1
        terms = tmttkrp.phi_contributions(at.meta.enc, MODE, words[s:e],
                                          values[s:e], rows[s:e], B,
                                          factors=fs, eps=EPS)
        got = tori.phi_carry_chunk(at.meta.enc, MODE, EPS, rows[s:e],
                                   words[s:e], values[s:e], B, out, crow,
                                   cval, factors=fs, block_m=BM,
                                   final=final)
    want = torch.zeros((DIMS[MODE], R)).index_add_(0, rows[s:e].long(),
                                                   terms)
    want[crow.long()] += cval
    last = int(rows[e - 1])
    if final:
        assert int(got[1]) == -1 and not bool(got[2].any())
    else:
        assert int(got[1]) == last
        np.testing.assert_allclose(got[2][0].numpy(), want[last].numpy(),
                                   rtol=1e-5)
        want[last] = 0.0
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_plain_chunk_chain_equals_plain_incore():
    """K8's plain version chained over the chunks is, piece for piece,
    K1's plain runs + fix-up."""
    at = _tensor(_layout_counts("duplicates_heavy",
                                np.random.default_rng(5)), 5)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(5)]
    enc = at.meta.enc
    rows, words, values, _ = tops.pad_sorted_stream(view.rows, view.words,
                                                    view.values, BM)
    o, r, v = tori.carry_runs_plain(enc, MODE, rows, words, values, fs, BM)
    want = tori.carry_fixup_plain(r, v, o)
    out = torch.zeros((DIMS[MODE], R))
    crow, cval = torch.full((1,), -1, dtype=torch.int32), torch.zeros(1, R)
    bounds = tops._chunk_bounds(rows.shape[0], 2 * BM)
    for i, (s, e) in enumerate(bounds):
        out, crow, cval = tori.carry_chunk_plain(
            enc, MODE, rows[s:e], words[s:e], values[s:e], fs, out, crow,
            cval, BM, i == len(bounds) - 1)
    assert torch.equal(out, want)


def test_padded_last_run_under_pre():
    """The final run is padded (replicated row, value 0): in-core Π pads
    zero rows, a chunk rebuilds non-zero ones; both add +0.0."""
    counts = np.zeros(DIMS[0], dtype=np.int64)
    counts[[2, 9, 28]] = [3, 4, 2 * BM + 2]
    at = _tensor(counts, 11)
    view = talto.oriented_view_device(at, MODE)
    hs = tstream.ensure_host(view)
    assert hs.padded_len(BM) > hs.length          # the last run is padded
    assert int(hs.rows[hs.padded_len(BM) - 1]) == 28
    fs = [torch.from_numpy(f) for f in _factors(11)]
    B = fs[MODE] + 0.1
    incore = tops.cpapr_phi_oriented_carry(view, B, block_m=BM,
                                           pi=_pi(at, view.words, fs))
    for cb in (1, 3):
        assert torch.equal(incore, tops.cpapr_phi_oriented_chunked(
            hs, B, fs, pre=True, chunk_m=cb * BM, block_m=BM))


def test_short_tail_and_degenerate_streams():
    """A stream that is not a multiple of the chunk (short last chunk),
    a single nonzero, an all-padding tensor."""
    fs = [torch.from_numpy(f) for f in _factors(9)]
    for counts in (np.full(DIMS[0], 3), np.eye(DIMS[0], dtype=np.int64)[11],
                   np.zeros(DIMS[0], dtype=np.int64)):
        at = _tensor(counts, 9, count_data=False)
        view = talto.oriented_view_device(at, MODE)
        incore = tops.mttkrp_oriented_carry(view, fs, block_m=BM,
                                            r_block=8)
        for chunk_m in (BM, 2 * BM, 4 * BM, 8 * BM):
            assert torch.equal(incore, tops.mttkrp_oriented_chunked(
                view, fs, chunk_m=chunk_m, block_m=BM, r_block=8))


def test_chunk_m_must_align_and_chunks_must_hold_a_block():
    at = _tensor(np.full(DIMS[0], 2), 0)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(0)]
    with pytest.raises(ValueError, match="multiple of"):
        tops.mttkrp_oriented_chunked(view, fs, chunk_m=BM + 1, block_m=BM)
    empty = torch.zeros((0,), dtype=torch.int32)
    with pytest.raises(ValueError, match="empty chunk"):
        tori.carry_chunk(at.meta.enc, MODE, empty,
                         torch.zeros((0, 1), dtype=torch.int32),
                         torch.zeros(0), fs, torch.zeros(DIMS[0], R),
                         torch.full((1,), -1, dtype=torch.int32),
                         torch.zeros(1, R), block_m=BM)


def test_chunk_count_matches_executed_chunks():
    at = _tensor(_layout_counts("mixed", np.random.default_rng(4)), 4)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(4)]
    for chunk_m in (BM, 2 * BM, 4 * BM):
        before = tops.chunk_stats()
        tops.mttkrp_oriented_chunked(view, fs, chunk_m=chunk_m, block_m=BM)
        after = tops.chunk_stats()
        want = tplan.chunk_count(at.meta, chunk_m)
        assert after["chunks"] - before["chunks"] == want
        assert after["prefetches"] - before["prefetches"] == want - 1
    tops.chunk_stats_clear()
    assert tops.chunk_stats() == {"chunks": 0, "prefetches": 0}


def test_reference_chunked_tolerance():
    at = _tensor(_layout_counts("duplicates_heavy",
                                np.random.default_rng(7)), 7)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(7)]
    ref = tmttkrp.mttkrp_oriented(view, fs)
    got = tops.mttkrp_oriented_chunked_reference(view, fs, chunk_m=13)
    assert float((got - ref).abs().max()) / float(ref.abs().max()) < 1e-5
    B = fs[MODE] + 0.1
    for pre in (True, False):
        want = tops.cpapr_phi_oriented_carry(
            view, B, block_m=BM,
            **(dict(pi=_pi(at, view.words, fs)) if pre
               else dict(factors=fs)))
        got = tops.cpapr_phi_oriented_chunked_reference(view, B, fs,
                                                        pre=pre, chunk_m=13)
        assert float((got - want).abs().max()) / float(want.abs().max()) \
            < 1e-5


def test_memmapped_stream_chunks_bitwise(tmp_path):
    at = _tensor(_layout_counts("mixed", np.random.default_rng(2)), 2)
    view = talto.oriented_view_device(at, MODE)
    fs = [torch.from_numpy(f) for f in _factors(2)]
    hs = tstream.to_memmap(tstream.host_stream(at, MODE), tmp_path)
    assert hs.directory is not None and not hs.pinned
    assert torch.equal(
        tops.mttkrp_oriented_chunked(hs, fs, chunk_m=2 * BM, block_m=BM),
        tops.mttkrp_oriented_carry(view, fs, block_m=BM))


def test_no_plain_version_counted_on_the_cpu():
    """The CPU path runs the plain versions; only a plain version on a
    CUDA tensor counts (none here)."""
    _build.reset_counts()
    at = _tensor(np.full(DIMS[0], 2), 1)
    fs = [torch.from_numpy(f) for f in _factors(1)]
    tops.mttkrp_oriented_chunked(talto.oriented_view_device(at, MODE), fs,
                                 chunk_m=BM, block_m=BM)
    counts = _build.counts()
    assert counts["plain_on_cuda"]["carry_chunk"] == 0
    assert counts["launches"]["carry_chunk"] == 0


# ---------------------------------------------------------------------------
# Against the JAX package's chunked executors (interpret mode)
# ---------------------------------------------------------------------------

def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _pair(layout, seed):
    coords, values = _coo(_layout_counts(layout, np.random.default_rng(seed)),
                          seed)
    jat = jalto.build(JSparse(DIMS, coords, values), n_partitions=2)
    tat = talto.build(TSparse(DIMS, coords, values), n_partitions=2,
                      device="cpu")
    return jat, tat


@pytest.mark.parametrize("layout", ["span_all_chunks", "mixed"])
def test_mttkrp_chunked_matches_pallas_interpret(layout):
    jat, tat = _pair(layout, 21)
    fs = _factors(21)
    jview = jalto.oriented_view(jat, MODE)
    want = jops.mttkrp_oriented_chunked(jview, [jnp.asarray(f) for f in fs],
                                        chunk_m=3 * BM, block_m=BM,
                                        r_block=4, interpret=True)
    got = tops.mttkrp_oriented_chunked(
        talto.oriented_view_device(tat, MODE), interop.factors(fs, "cpu"),
        chunk_m=3 * BM, block_m=BM, r_block=4)
    _close(got, want)


@pytest.mark.parametrize("policy", ["pre", "otf"])
@pytest.mark.parametrize("layout", ["span_all_chunks", "mixed"])
def test_phi_chunked_matches_pallas_interpret(layout, policy):
    jat, tat = _pair(layout, 22)
    fs = _factors(22)
    B = fs[MODE] + 0.1
    want = jops.cpapr_phi_oriented_chunked(
        jalto.oriented_view(jat, MODE), jnp.asarray(B),
        [jnp.asarray(f) for f in fs], pre=policy == "pre", eps=EPS,
        chunk_m=2 * BM, block_m=BM, interpret=True)
    got = tops.cpapr_phi_oriented_chunked(
        talto.oriented_view_device(tat, MODE), torch.from_numpy(B),
        interop.factors(fs, "cpu"), pre=policy == "pre", eps=EPS,
        chunk_m=2 * BM, block_m=BM)
    _close(got, want)


# ---------------------------------------------------------------------------
# Streaming plans through the plan layer and the drivers
# ---------------------------------------------------------------------------

def _streaming_pair(seed=6, scale=4, rank=4):
    """A tensor, its port streaming plan (several chunks) and the JAX
    package's for the same budget (vmem_limit=0 gives JAX's block 8,
    the port's block for a stream this short)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, scale * 2, size=DIMS[0])
    counts[3] = scale * BM
    coords, values = _coo(counts, seed)
    jat = jalto.build(JSparse(DIMS, coords, values), n_partitions=2)
    tat = interop.alto_tensor(
        np.asarray(jat.words), np.asarray(jat.values),
        np.asarray(jat.part_start), np.asarray(jat.part_end),
        dims=jat.meta.dims, nnz=jat.meta.nnz,
        n_partitions=jat.meta.n_partitions, temp_rows=jat.meta.temp_rows,
        fiber_reuse=jat.meta.fiber_reuse, device="cpu")
    budget = (tplan.streaming_resident_bytes(tat.meta, rank)
              + 2 * tplan.stream_elem_bytes(tat.meta) * 2 * tplan.MIN_BLOCK_M)
    tp = tplan.make_plan(tat.meta, rank, backend="cuda",
                         device_bytes=budget)
    jp = jplan.make_plan(jat.meta, rank, backend="pallas", interpret=True,
                         vmem_limit=0, device_bytes=budget)
    return jat, tat, jp, tp


def test_streaming_plan_matches_reference():
    jat, tat, jp, tp = _streaming_pair()
    assert [m.block_m for m in tp.modes] == [m.block_m for m in jp.modes]
    assert tp.streaming == tplan.StreamPlan(**dataclasses.asdict(
        jp.streaming))
    assert tp.streaming.n_chunks >= 3
    assert tp.traversals() == jp.traversals() == ("oriented_carry",) * 3


def test_execute_routes_through_chunked():
    _, at, _, tp = _streaming_pair()
    views = tplan.build_views(at, tp)
    assert all(isinstance(v, tstream.HostStream) for v in views.values())
    fs = [torch.from_numpy(f[:, :4].copy()) for f in _factors(1)]
    before = tops.chunk_stats()["chunks"]
    out = tplan.execute_mttkrp(tp, at, views, fs, MODE)
    assert tops.chunk_stats()["chunks"] - before == tp.streaming.n_chunks
    assert torch.equal(out, tops.mttkrp_oriented_carry(
        talto.oriented_view_device(at, MODE), fs,
        block_m=tp.modes[MODE].block_m, r_block=tp.modes[MODE].r_block))
    ref = tplan.execute_mttkrp(dataclasses.replace(tp, backend="reference"),
                               at, views, fs, MODE)
    assert float((ref - out).abs().max()) / float(out.abs().max()) < 1e-5
    B = torch.ones((DIMS[MODE], 4))
    with pytest.raises(ValueError, match="factors"):
        tplan.execute_phi(tp, at, views[MODE], B, MODE,
                          pi=torch.ones((1, 4)))


def test_streamed_cp_als_bitwise_and_near_reference():
    jat, at, jp, tp = _streaming_pair()
    fs = [np.random.default_rng(8).random((I, 4)).astype(np.float32)
          for I in DIMS]
    rs = tcpals.cp_als(at, 4, n_iters=4, tol=0.0, plan=tp,
                       factors=interop.factors(fs, "cpu"))
    ri = tcpals.cp_als(at, 4, n_iters=4, tol=0.0,
                       plan=dataclasses.replace(tp, streaming=None),
                       factors=interop.factors(fs, "cpu"))
    assert rs.fits == ri.fits
    assert torch.equal(rs.lam, ri.lam)
    assert all(torch.equal(a, b) for a, b in zip(rs.factors, ri.factors))
    ref = jcpals.cp_als(jat, 4, n_iters=4, tol=0.0,
                        plan=dataclasses.replace(jp, streaming=None),
                        warm_start=[jnp.asarray(f) for f in fs])
    np.testing.assert_allclose(rs.fits, ref.fits, rtol=0, atol=1e-4)


@pytest.mark.parametrize("policy", ["pre", "otf"])
def test_streamed_cp_apr_bitwise_and_near_reference(policy):
    jat, at, jp, tp = _streaming_pair()
    rng = np.random.default_rng(9)
    fs = [rng.random((I, 4)).astype(np.float32) + 0.1 for I in DIMS]
    lam = np.full(4, float(np.asarray(jat.values).sum()) / 4, np.float32)
    params = tcpapr.CpaprParams(k_max=2, l_max=3)
    runs = [tcpapr.cp_apr(at, 4, params, pi_policy=policy, track_ll=True,
                          plan=p, warm_start=(torch.from_numpy(lam),
                                              interop.factors(fs, "cpu")))
            for p in (tp, dataclasses.replace(tp, streaming=None))]
    rs, ri = runs
    assert rs.log_likelihoods == ri.log_likelihoods
    assert rs.kkt_violations == ri.kkt_violations
    assert rs.n_inner_total == ri.n_inner_total
    assert torch.equal(rs.lam, ri.lam)
    assert all(torch.equal(a, b) for a, b in zip(rs.factors, ri.factors))
    ref = jcpapr.cp_apr(jat, 4, params=jcpapr.CpaprParams(k_max=2, l_max=3),
                        pi_policy=policy, track_ll=True, plan=jp,
                        warm_start=(jnp.asarray(lam),
                                    [jnp.asarray(f) for f in fs]))
    assert rs.n_inner_total == int(ref.n_inner_total)
    np.testing.assert_allclose(rs.log_likelihoods, ref.log_likelihoods,
                               rtol=1e-5, atol=0)


def test_streamed_runs_are_genuinely_chunked():
    _, at, _, tp = _streaming_pair()
    before = tops.chunk_stats()["chunks"]
    tcpals.cp_als(at, 4, n_iters=1, plan=tp)
    assert tops.chunk_stats()["chunks"] - before \
        == len(DIMS) * tp.streaming.n_chunks
