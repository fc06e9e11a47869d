"""The redesigned K3 (recursive MTTKRP: a CTA per ALTO partition, its Temp
window in shared memory) and K6 (the Φ partials through K5's runs pass),
their host side and their contracts, on the CPU.

The kernels run only on the card (`chip_smoke.py`); here:

1. K3's plain path against the JAX package's ``mttkrp_partials_pallas``
   in interpret mode at ranks 5, 16 and 40 (tolerance ``rtol=1e-5,
   atol=1e-5·max|ref|``: the Pallas kernel sums through a one-hot matmul,
   in another order);
2. a plain mirror of K3's walk (row windows, staging tiles, each Temp row
   owned by one sub-warp adding its tile's terms in slot order) equal bit
   for bit to `recursive_partials_plain`, under hypothesis, with a model
   of its stores: every Temp entry is stored exactly once;
3. the window rule K3 and K7 share (`common.window_rows`), with and
   without B rows;
4. a plain mirror of the Φ runs pass in K6's slot layout equal bit for
   bit to `phi_oriented_partials_plain`, and in K5's carry layout equal to
   `phi_carry_runs_plain` with every output row written exactly once
   (gap zeros, inner runs, the fix-up's stores); K5 equal to K6 +
   segment_merge on the CPU;
5. the small CP-APR that `chip_smoke.py` checks the card against, bit
   for bit repeatable on the CPU under 1 and 4 threads.

Sums on one CPU thread (the plain versions' ``index_add_`` then runs in
index order).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import alto as jalto
from repro.kernels import mttkrp as jk3
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import plan as tplan
from repro_torch.core.encoding import delinearize
from repro_torch.kernels import common
from repro_torch.kernels import mttkrp as tk3
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn
from repro_torch.sparse.tensor import SparseTensor
from torch_mirrors import runs_pass_mirror

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMEM = 232_448          # one CTA's opt-in shared memory on an H100
EPS = 1e-10
MIRROR = settings(max_examples=40, deadline=None, derandomize=True,
                  database=None)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factors(dims, rank, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((I, rank)).astype(np.float32) for I in dims]


# ---------------------------------------------------------------------------
# 1. K3's plain path against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair():
    x = jsyn.blocked_tensor((30, 24, 20), 900, block=6, n_blocks=6, seed=5,
                            count_data=True)
    jat = jalto.build(x, n_partitions=8)
    m = jat.meta
    at = interop.alto_tensor(
        np.asarray(jat.words), np.asarray(jat.values),
        np.asarray(jat.part_start), np.asarray(jat.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")
    return jat, at


@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("rank", [5, 16, 40])
def test_k3_plain_matches_pallas_interpret(jax_pair, rank, mode):
    jat, at = jax_pair
    fs = _factors(at.dims, rank, seed=rank)
    m = at.meta
    ref = np.asarray(jk3.mttkrp_partials_pallas(
        jat.meta.enc, mode, m.temp_rows[mode], jat.words, jat.values,
        jat.part_start, [jnp.asarray(f) for f in fs], interpret=True))
    got = tk3.recursive_partials(m.enc, mode, m.temp_rows[mode], at.words,
                                 at.values, at.part_start,
                                 interop.factors(fs, device="cpu"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# 2. A plain mirror of K3's walk, and its stores
# ---------------------------------------------------------------------------

def k3_mirror(enc, mode, temp_rows, words, values, part_start, factors,
              r_block, window, tile, lanes):
    """What ``mttkrp_partials_smem_kernel`` computes, step by step in
    float32, and how often it stores each Temp entry: per partition and
    rank tile, per window of ``window`` rows a zeroed window; per tile of
    ``tile`` nonzeros, the terms of the nonzeros whose row falls in the
    window; then sub-warp q (of ``threads // lanes``, 128 threads) adds
    the tile's terms of the window rows with row % n_sub == q in slot
    order; at the window's end each entry is stored."""
    L = part_start.shape[0]
    chunk = words.shape[0] // L
    R = factors[0].shape[1]
    n_sub = 128 // lanes
    terms = tmttkrp.contributions(enc, words, values, factors, mode)
    rows = delinearize(enc, words)[:, mode].long()
    temp = torch.full((L, temp_rows, R), float("nan"))
    stores = torch.zeros((L, temp_rows, R), dtype=torch.int64)
    for l in range(L):
        start = int(part_start[l, mode])
        for c0 in range(0, R, r_block):
            cols = slice(c0, c0 + r_block)
            for w0 in range(0, temp_rows, window):
                h = min(window, temp_rows - w0)
                s_temp = torch.zeros((h, r_block))
                for t0 in range(0, chunk, tile):
                    n = min(tile, chunk - t0)
                    idx = l * chunk + t0 + torch.arange(n)
                    local = rows[idx] - start - w0
                    live = (local >= 0) & (local < h)
                    for q in range(n_sub):
                        for j in range(n):
                            lr = int(local[j])
                            if live[j] and lr % n_sub == q:
                                s_temp[lr] = s_temp[lr] + terms[idx[j], cols]
                temp[l, w0:w0 + h, cols] = s_temp
                stores[l, w0:w0 + h, cols] += 1
    return temp, stores


@st.composite
def recursive_cases(draw):
    dims = tuple(draw(st.integers(2, 12)) for _ in range(draw(
        st.integers(2, 4))))
    nnz = draw(st.integers(1, 120))
    n_parts = draw(st.integers(1, 6))
    rank, r_block = draw(st.sampled_from([(1, 1), (5, 5), (5, 1), (8, 8),
                                          (8, 4), (12, 4)]))
    mode = draw(st.integers(0, len(dims) - 1))
    window = draw(st.sampled_from([1, 3, None]))
    tile = draw(st.sampled_from([1, 8, 16, 128]))
    seed = draw(st.integers(0, 2 ** 16))
    return dims, nnz, n_parts, rank, r_block, mode, window, tile, seed


def _recursive_inputs(dims, nnz, n_parts, rank, seed):
    x = tsyn.uniform_tensor(dims, nnz, seed=seed)
    at = talto.build_device(x, n_partitions=n_parts, device="cpu")
    fs = [torch.from_numpy(f) for f in _factors(dims, rank, seed)]
    return at, fs


@MIRROR
@given(case=recursive_cases())
def test_k3_mirror_equals_plain_and_stores_once(case):
    dims, nnz, n_parts, rank, r_block, mode, window, tile, seed = case
    at, fs = _recursive_inputs(dims, nnz, n_parts, rank, seed)
    m = at.meta
    T = m.temp_rows[mode]
    args = (m.enc, mode, T, at.words, at.values, at.part_start, fs)
    lanes, _ = tori.lane_map(r_block)
    temp, stores = k3_mirror(*args, r_block, window or T, tile, lanes)
    assert torch.equal(temp, tk3.recursive_partials_plain(*args))
    assert bool((stores == 1).all())


@pytest.mark.parametrize("window", [1, 3, None])
def test_k3_wrapper_window_and_out_change_nothing_on_cpu(window):
    at, fs = _recursive_inputs((9, 7, 11), 300, 5, 8, seed=2)
    m = at.meta
    args = (m.enc, 1, m.temp_rows[1], at.words, at.values, at.part_start, fs)
    plain = tk3.recursive_partials_plain(*args)
    assert torch.equal(tk3.recursive_partials_windowed(*args, window=window),
                       plain)
    out = torch.full(plain.shape, float("nan"))
    got = tk3.recursive_partials(*args, r_block=4, out=out)
    assert got is out and torch.equal(out, plain)


def test_k3_wrapper_rejects_bad_arguments():
    at, fs = _recursive_inputs((9, 7, 11), 300, 5, 8, seed=2)
    m = at.meta
    args = (m.enc, 1, m.temp_rows[1], at.words, at.values, at.part_start, fs)
    with pytest.raises(ValueError, match="window"):
        tk3.recursive_partials_windowed(*args, window=0)
    with pytest.raises(ValueError, match="r_block"):
        tk3.recursive_partials(*args, r_block=3)
    with pytest.raises(ValueError, match="out"):
        tk3.recursive_partials(*args, out=torch.empty((1, 1, 8)))


def _store_counts(T, R, r_block, window, vec4):
    """The kernel's closing store loop, per window and rank tile: thread k
    of the window stores entry (k // q, 4·(k % q) + i), i < 4, with q =
    r_block / 4 float4s a row (``vec4``), or entry (k // r_block, k %
    r_block); the count of stores of each Temp entry."""
    counts = np.zeros((T, R), dtype=np.int64)
    for c0 in range(0, R, r_block):
        for w0 in range(0, T, window):
            h = min(window, T - w0)
            if vec4:
                q = r_block // 4
                for k in range(h * q):
                    r, c = w0 + k // q, c0 + 4 * (k % q)
                    counts[r, c:c + 4] += 1
            else:
                for k in range(h * r_block):
                    counts[w0 + k // r_block, c0 + k % r_block] += 1
    return counts


@pytest.mark.parametrize("T", [1, 2, 127, 300])
@pytest.mark.parametrize("window", [1, 3, 64, None])
@pytest.mark.parametrize("R,r_block,vec4", [(16, 16, True), (16, 4, True),
                                            (40, 8, True), (16, 16, False),
                                            (5, 5, False), (5, 1, False)])
def test_k3_stores_every_temp_entry_once(T, window, R, r_block, vec4):
    counts = _store_counts(T, R, r_block, window or T, vec4)
    assert bool((counts == 1).all())


# ---------------------------------------------------------------------------
# 3. The window rule K3 and K7 share
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b_rows", [False, True])
@pytest.mark.parametrize("limit", [48 * 1024, H100_SMEM])
@pytest.mark.parametrize("cols", [1, 4, 16, 40, 128])
@pytest.mark.parametrize("temp_rows", [1, 127, 5_000, 1_000_000])
def test_window_rows_cover_temp_with_and_without_b(temp_rows, cols, limit,
                                                   b_rows):
    h = common.window_rows(temp_rows, cols, limit, b_rows)
    assert 1 <= h <= temp_rows
    assert -(-temp_rows // h) * h >= temp_rows
    tile = common.tile_nnz(cols)
    assert common.smem_bytes(h, cols, tile, b_rows) <= limit
    if h < temp_rows:
        assert common.smem_bytes(h + 1, cols, tile, b_rows) > limit


@pytest.mark.parametrize("cols", [1, 16, 40, 128])
def test_k3_windows_hold_twice_k7s_rows(cols):
    """Without B rows a window holds about twice K7's rows at the same
    width; Chicago's mode 0 (T = 127, r_block 16) fits one K3 window."""
    k3 = common.window_rows(10 ** 7, cols, H100_SMEM, False)
    k7 = common.window_rows(10 ** 7, cols, H100_SMEM, True)
    assert 2 * k7 <= k3 <= 2 * k7 + 2
    assert common.window_rows(127, 16, H100_SMEM, False) == 127


@pytest.mark.parametrize("b_rows", [False, True])
def test_window_rows_refuse_a_limit_without_one_row(b_rows):
    tile = common.tile_nnz(16)
    limit = common.smem_bytes(1, 16, tile, b_rows)
    assert common.window_rows(10, 16, limit, b_rows) == 1
    with pytest.raises(ValueError, match="shared memory"):
        common.window_rows(10, 16, limit - 1, b_rows)


def test_kernels_size_shared_memory_by_the_shared_rule():
    """K3 launches with the rule without B rows, K7 with them, both
    through ``partials_smem_bytes`` (csrc/alto_scan.cuh)."""
    assert ("partials_smem_bytes(p.r_block, p.window, p.tile, false)"
            in (CSRC / "mttkrp.cu").read_text())
    assert ("partials_smem_bytes(p.a.rank, p.window, p.tile, true)"
            in (CSRC / "cpapr_phi.cu").read_text())


# ---------------------------------------------------------------------------
# 4. The Φ runs pass: K6's slots and K5's write set
# ---------------------------------------------------------------------------

@st.composite
def phi_layouts(draw):
    block_m = draw(st.sampled_from([1, 4, 8, 16]))
    n_rows = draw(st.integers(1, 30))
    counts = draw(st.lists(st.sampled_from([0, 0, 1, 2, 3, 9, 40]),
                           min_size=n_rows, max_size=n_rows))
    if sum(counts) == 0:
        counts[draw(st.integers(0, n_rows - 1))] = 1
    rank = draw(st.sampled_from([1, 5, 16]))
    policy = draw(st.sampled_from(["otf", "pre"]))
    return block_m, counts, rank, policy, draw(st.integers(0, 2 ** 16))


def _phi_stream(counts, rank, policy, block_m, seed):
    rng = np.random.default_rng(seed)
    dims = (len(counts), 5, 3)
    rows = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    coords = np.stack([rows] + [rng.integers(0, I, rows.shape[0]).astype(
        np.int32) for I in dims[1:]], axis=1)
    vals = (rng.random(rows.shape[0]) * 3 + 1).astype(np.float32)
    at = talto.build_device(SparseTensor(dims, coords, vals),
                            n_partitions=1, device="cpu")
    view = talto.oriented_view_device(at, 0)
    fs = [torch.from_numpy(np.abs(f) + 0.05)
          for f in _factors(dims, rank, seed)]
    B = fs[0] * 2.0
    pi = tmttkrp.krp_rows(delinearize(at.meta.enc, view.words), fs, 0)
    operands = {"factors": fs} if policy == "otf" else {"pi": pi}
    return at, view, B, operands


@MIRROR
@given(layout=phi_layouts())
def test_phi_runs_pass_mirror_in_both_layouts(layout):
    block_m, counts, rank, policy, seed = layout
    at, view, B, operands = _phi_stream(counts, rank, policy, block_m, seed)
    enc = at.meta.enc
    rows, words, values, pi = tops.pad_sorted_stream(
        view.rows, view.words, view.values, block_m, pi=operands.get("pi"))
    kw = dict(factors=operands.get("factors"), pi=pi)
    args = (enc, 0, EPS, rows, words, values, B)
    terms = tmttkrp.phi_contributions(enc, 0, words, values, rows, B,
                                      eps=EPS, **kw)
    slots, slot_stores = runs_pass_mirror(terms, rows, block_m, len(counts),
                                          True)
    assert bool((slot_stores == 1).all())
    assert torch.equal(slots, tori.phi_oriented_partials_plain(
        *args, **kw, block_m=block_m))
    out, crow, cval, stores = runs_pass_mirror(terms, rows, block_m,
                                               len(counts), False)
    p_out, p_crow, p_cval = tori.phi_carry_runs_plain(*args, **kw,
                                                      block_m=block_m)
    assert torch.equal(crow, p_crow) and torch.equal(cval, p_cval)
    carried = torch.zeros(len(counts), dtype=torch.bool)
    carried[crow[crow >= 0].long()] = True
    # The runs pass stores every row the fix-up does not, once each.
    assert bool((stores[~carried] == 1).all())
    assert bool((stores[carried] == 0).all())
    assert torch.equal(out[~carried], p_out[~carried])
    # The wrapper into a NaN-filled out writes the same set, and K5 into
    # one equals K5.
    nan = torch.full(p_out.shape, float("nan"))
    w_out, _, _ = tori.phi_carry_runs(*args, **kw, block_m=block_m, out=nan)
    assert torch.equal(w_out.isnan(), carried[:, None].expand_as(w_out))
    k5 = tori.phi_oriented_carry(*args, **kw, block_m=block_m)
    assert torch.equal(tori.phi_oriented_carry(
        *args, **kw, block_m=block_m,
        out=torch.full(p_out.shape, float("nan"))), k5)


@pytest.mark.parametrize("policy", ["otf", "pre"])
@pytest.mark.parametrize("rank", [5, 16, 40])
@pytest.mark.parametrize("block_m", [8, 64])
def test_k5_equals_k6_plus_merge_on_cpu(block_m, rank, policy):
    rng = np.random.default_rng(block_m + rank)
    counts = rng.integers(0, 2 * block_m, size=29)
    counts[3] += 3 * block_m + 2                   # a run across slices
    at, view, B, operands = _phi_stream(list(counts), rank, policy, block_m,
                                        seed=rank)
    kw = dict(operands, eps=EPS, block_m=block_m)
    k5 = tops.cpapr_phi_oriented_carry(view, B, **kw)
    assert torch.equal(k5, tops.cpapr_phi_oriented(view, B, **kw))
    # Against the terms summed in float64: rtol 1e-5, float32 run sums.
    terms = tmttkrp.phi_contributions(at.meta.enc, 0, view.words,
                                      view.values, view.rows, B, eps=EPS,
                                      **operands)
    ref = torch.zeros(k5.shape, dtype=torch.float64).index_add_(
        0, view.rows.long(), terms.double())
    np.testing.assert_allclose(k5.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# 5. The small CP-APR of chip_smoke.py, repeatable on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_small_cp_apr_on_cpu_repeats_under_any_thread_count(policy):
    """``phase_small_cp_apr``'s tensor, plan and rank (the CPU side of the
    card check): equal bits under 1 and 4 CPU threads and on a rerun."""
    x = tsyn.blocked_tensor((60, 24, 77, 32), 20_000, block=8, n_blocks=20,
                            seed=1, count_data=True)
    at = talto.build_device(x, n_partitions=64, device="cpu")
    g = torch.Generator()
    g.manual_seed(9)
    fs = [torch.rand((I, 16), generator=g) + 0.05 for I in x.dims]
    p = tplan.make_plan(at.meta, 16, backend="cuda")
    results = []
    for threads in (1, 4, 1):
        torch.set_num_threads(threads)
        res = tcpapr.cp_apr(at, 16, tcpapr.CpaprParams(k_max=2, l_max=10),
                            pi_policy=policy, track_ll=True,
                            warm_start=[f.clone() for f in fs], plan=p)
        results.append(res)
    first = results[0]
    for res in results[1:]:
        assert res.log_likelihoods == first.log_likelihoods
        assert res.kkt_violations == first.kkt_violations
        assert all(torch.equal(a, b)
                   for a, b in zip(res.factors, first.factors))
