"""The redesigned K2 (the MTTKRP partials through K1's runs pass) and the
split of `segment_merge` on the card, their host side and their contracts,
on the CPU.

The kernels run only on the card (`chip_smoke.py`); here:

1. a plain mirror of K1's runs pass in K2's slot layout
   (`torch_mirrors.runs_pass_mirror`, fed with
   `core.mttkrp.contributions`), rank tile by rank tile, equal bit for bit
   to `oriented_partials_plain` under hypothesis over adversarial run
   layouts and rank tiles, every slot stored once; the same loop in the
   carry layout equals K1's plain first pass;
2. a plain mirror of the split kernel's walk (`torch_mirrors.
   split_mirror`: a warp per slice, rows 32 at a time, run starts by
   ballot, round-robin over the sub-warps) equal to `split_block_runs`,
   reading only the used slots, and with the fix-up's stores writing
   every output row exactly once;
3. the wrappers on CPU tensors: K2's rank tiles and ``out=`` change no
   bit, a rank tile that does not divide the rank is refused; the split
   writes every row but the carried ones; the C entries take the
   arguments their bindings pass;
4. parity with the JAX package: K2's plain partials against
   ``mttkrp_oriented_partials_pallas`` in interpret mode at ranks 5 and
   16 and ``block_m`` 8 and 64, and the port's `segment_merge` against
   ``repro.kernels.ops.segment_merge`` on the same partials (tolerance
   ``rtol=1e-5, atol=1e-5·max|ref|``: the Pallas kernel sums through a
   one-hot matmul, in another order).

Sums on one CPU thread (the plain versions' ``index_add_`` then runs in
index order).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import alto as jalto
from repro.kernels import mttkrp_oriented as jori
from repro.kernels import ops as jops
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.kernels import _build, common
from repro_torch.kernels import mttkrp_oriented as tori
from repro_torch.kernels import ops as tops
from repro_torch.sparse.tensor import SparseTensor
from torch_mirrors import runs_pass_mirror, split_mirror

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
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


def _stream(counts, rank, block_m, seed):
    """A mode-0 stream whose row r holds counts[r] nonzeros, padded to
    ``block_m``: (encoding, rows, words, values, factors)."""
    rng = np.random.default_rng(seed)
    dims = (len(counts), 5, 3)
    rows = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    coords = np.stack([rows] + [rng.integers(0, I, rows.shape[0]).astype(
        np.int32) for I in dims[1:]], axis=1)
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    at = talto.build_device(SparseTensor(dims, coords, vals),
                            n_partitions=1, device="cpu")
    view = talto.oriented_view_device(at, 0)
    fs = [torch.from_numpy(f) for f in _factors(dims, rank, seed)]
    rows, words, values, _ = tops.pad_sorted_stream(
        view.rows, view.words, view.values, block_m)
    return at.meta.enc, rows, words, values, fs


@st.composite
def onehot_layouts(draw):
    """Run layouts with skipped rows (gaps, leading and trailing), runs
    longer than a slice, slices longer than a 32-row window and shorter,
    and rank tiles of K1's lane maps."""
    block_m = draw(st.sampled_from([1, 4, 8, 40, 64]))
    n_rows = draw(st.integers(1, 30))
    counts = draw(st.lists(st.sampled_from([0, 0, 1, 2, 3, 9, 40]),
                           min_size=n_rows, max_size=n_rows))
    if sum(counts) == 0:
        counts[draw(st.integers(0, n_rows - 1))] = 1
    rank, r_block = draw(st.sampled_from([(1, 1), (5, 5), (5, 1), (16, 16),
                                          (16, 8), (16, 4), (40, 8)]))
    return block_m, counts, rank, r_block, draw(st.integers(0, 2 ** 16))


def _carried(crow, n_rows):
    carried = torch.zeros(n_rows, dtype=torch.bool)
    carried[crow[crow >= 0].long()] = True
    return carried


# ---------------------------------------------------------------------------
# 1. K2: K1's runs pass in the slot layout
# ---------------------------------------------------------------------------

@MIRROR
@given(layout=onehot_layouts())
def test_k2_mirror_equals_plain_and_stores_every_slot_once(layout):
    block_m, counts, rank, r_block, seed = layout
    enc, rows, words, values, fs = _stream(counts, rank, block_m, seed)
    args = (enc, 0, rows, words, values, fs)
    terms = tmttkrp.contributions(enc, words, values, fs, 0)
    slots, stores = runs_pass_mirror(terms, rows, block_m, len(counts), True,
                                     r_block)
    assert bool((stores == 1).all())
    assert torch.equal(slots, tori.oriented_partials_plain(*args, block_m))
    # The same loop in the carry layout is K1's first pass.
    out, crow, cval, _ = runs_pass_mirror(terms, rows, block_m, len(counts),
                                          False, r_block)
    p_out, p_crow, p_cval = tori.carry_runs_plain(*args, block_m)
    assert torch.equal(crow, p_crow) and torch.equal(cval, p_cval)
    carried = _carried(crow, len(counts))
    assert torch.equal(out[~carried], p_out[~carried])


# ---------------------------------------------------------------------------
# 2. The split of segment_merge
# ---------------------------------------------------------------------------

@MIRROR
@given(layout=onehot_layouts())
def test_split_mirror_equals_split_block_runs_and_writes_rows_once(layout):
    block_m, counts, rank, _, seed = layout
    enc, rows, words, values, fs = _stream(counts, rank, block_m, seed)
    n = len(counts)
    part = tori.oriented_partials_plain(enc, 0, rows, words, values, fs,
                                        block_m)
    lanes, _ = tori.lane_map(common.rank_tile(rank))
    out, crow, cval, stores, reads = split_mirror(part, rows, n, lanes)
    p_out, p_crow, p_cval = tori.split_block_runs(part, rows, n)
    assert torch.equal(crow, p_crow) and torch.equal(cval, p_cval)
    carried = _carried(crow, n)
    assert torch.equal(out[~carried], p_out[~carried])
    assert bool(out[carried].isnan().all())
    # With the fix-up's one store per carried row: every row once.
    assert torch.equal(stores + carried.long(),
                       torch.ones(n, dtype=torch.int64))
    # Only the used slots are read, each once.
    seg = tori.run_rank_segments(rows.reshape(-1, block_m))
    used = torch.arange(block_m)[None, :] <= seg[:, -1:]
    assert torch.equal(reads, used.long())
    assert torch.equal(tori.carry_fixup_plain(crow, cval, out.clone()),
                       tops.segment_merge(part, rows, n))


def test_split_mirror_walks_each_slice_in_32_row_windows():
    """A slice of 70 rows, each its own run: three windows, the starts of
    each window shared round-robin by the sub-warps, slots 0..69 read
    once, the first and last runs carried."""
    counts = [1] * 70
    enc, rows, words, values, fs = _stream(counts, 16, 70, seed=3)
    part = tori.oriented_partials_plain(enc, 0, rows, words, values, fs, 70)
    out, crow, cval, stores, reads = split_mirror(part, rows, 70, 4)
    assert crow.tolist() == [[0, 69]]
    assert bool((reads == 1).all())
    assert stores.tolist() == [0] + [1] * 68 + [0]


# ---------------------------------------------------------------------------
# 3. The wrappers on CPU tensors, and the C entries' arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r_block", [None, 8, 16])
def test_k2_wrapper_rank_tiles_and_out_change_nothing_on_cpu(r_block):
    counts = list(np.random.default_rng(4).integers(0, 30, size=25))
    enc, rows, words, values, fs = _stream(counts, 16, 64, seed=4)
    args = (enc, 0, rows, words, values, fs)
    plain = tori.oriented_partials_plain(*args, 64)
    assert torch.equal(tori.oriented_partials(*args, block_m=64,
                                              r_block=r_block), plain)
    out = torch.full(plain.shape, float("nan"))
    got = tori.oriented_partials(*args, block_m=64, r_block=r_block, out=out)
    assert got is out and torch.equal(out, plain)


@pytest.mark.parametrize("r_block", [3, 5, 32, 160])
def test_k2_wrapper_rejects_a_rank_tile_that_does_not_divide_the_rank(
        r_block):
    enc, rows, words, values, fs = _stream([3, 0, 5, 9], 16, 8, seed=1)
    with pytest.raises(ValueError, match="r_block"):
        tori.oriented_partials(enc, 0, rows, words, values, fs, block_m=8,
                               r_block=r_block)


def test_k2_wrapper_rejects_slots_of_another_shape():
    enc, rows, words, values, fs = _stream([3, 0, 5, 9], 16, 8, seed=1)
    with pytest.raises(ValueError, match="out"):
        tori.oriented_partials(enc, 0, rows, words, values, fs, block_m=8,
                               out=torch.empty((1, 8, 16)))


@pytest.mark.parametrize("block_m", [8, 64])
def test_segment_split_wrapper_leaves_the_carried_rows_on_cpu(block_m):
    counts = [0, 2] + list(np.random.default_rng(block_m).integers(
        0, 2 * block_m, size=27)) + [0, 0]
    counts[5] += 3 * block_m + 2                       # a run across slices
    enc, rows, words, values, fs = _stream(counts, 16, block_m, seed=7)
    part = tori.oriented_partials_plain(enc, 0, rows, words, values, fs,
                                        block_m)
    n = len(counts)
    nan = torch.full((n, 16), float("nan"))
    out, crow, cval = tori.segment_split(part, rows, n, out=nan)
    p_out, p_crow, p_cval = tori.split_block_runs(part, rows, n)
    assert out is nan
    assert torch.equal(crow, p_crow) and torch.equal(cval, p_cval)
    carried = _carried(crow, n)
    assert torch.equal(out.isnan(), carried[:, None].expand_as(out))
    assert torch.equal(out[~carried], p_out[~carried])
    assert torch.equal(tori.carry_fixup(crow, cval, out),
                       tops.segment_merge(part, rows, n))
    with pytest.raises(ValueError, match="rows"):
        tori.segment_split(part, rows[:-1], n)
    with pytest.raises(TypeError, match="dtype"):
        tori.segment_split(part.double(), rows, n)


def _c_params(source: str, fn: str) -> int:
    sig = re.search(r"\bint " + fn + r"\(([^)]*)\)", source).group(1)
    return len(sig.split(","))


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in
                                    _build.SIGNATURES.items() for fn in fns])
def test_c_entries_take_the_arguments_their_bindings_pass(lib, fn):
    source = (CSRC / f"{lib}.cu").read_text()
    assert _c_params(source, fn) == len(_build.SIGNATURES[lib][fn])


# ---------------------------------------------------------------------------
# 4. Parity with the JAX package
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


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("mode", range(3))
@pytest.mark.parametrize("block_m", [8, 64])
@pytest.mark.parametrize("rank", [5, 16])
def test_k2_and_segment_merge_match_the_jax_package(jax_pair, rank, block_m,
                                                    mode):
    jat, at = jax_pair
    fs = _factors(at.dims, rank, seed=rank + mode)
    jview = jalto.oriented_view(jat, mode)
    jr, jw, jv, _ = jops.pad_sorted_stream(jview.rows, jview.words,
                                           jview.values, block_m)
    ref = jori.mttkrp_oriented_partials_pallas(
        jat.meta.enc, mode, jr, jw, jv, [jnp.asarray(f) for f in fs],
        block_m=block_m, interpret=True)
    view = interop.oriented_view(
        at.meta, mode, np.asarray(jview.rows), np.asarray(jview.words),
        np.asarray(jview.values), np.asarray(jview.perm), device="cpu")
    rows, words, values, _ = tops.pad_sorted_stream(
        view.rows, view.words, view.values, block_m)
    got = tori.oriented_partials(at.meta.enc, mode, rows, words, values,
                                 interop.factors(fs, device="cpu"),
                                 block_m=block_m)
    _close(got, ref)
    n = at.dims[mode]
    _close(tops.segment_merge(got, rows, n),
           jops.segment_merge(jnp.asarray(got.numpy()), jr, n))


def test_split_mirror_gives_each_start_its_run_rank_slot():
    """A start's slot is the count of starts before it in the slice, the
    slot `run_rank_segments` gives its run: rows 0, 2, 3, 7, 9 take slots
    0..4, the inner runs 2, 3 and 7 land in out, rows 1, 4-6 and 8 get
    zeros."""
    rows = torch.tensor([0, 0, 2, 2, 2, 3, 7, 7, 7, 9, 9, 9],
                        dtype=torch.int32)
    part = torch.arange(12 * 2, dtype=torch.float32).reshape(1, 12, 2)
    seg = tori.run_rank_segments(rows.reshape(1, 12))[0]
    starts = [0] + [i for i in range(1, 12) if rows[i] != rows[i - 1]]
    assert [int(seg[i]) for i in starts] == list(range(len(starts)))
    out, crow, cval, stores, reads = split_mirror(part, rows, 10, 4)
    assert crow.tolist() == [[0, 9]]
    assert torch.equal(cval[0], part[0, [0, 4]])
    for row, j in ((2, 1), (3, 2), (7, 3)):
        assert torch.equal(out[row], part[0, j])
    assert bool((out[[1, 4, 5, 6, 8]] == 0).all())
    assert stores.tolist() == [0, 1, 1, 1, 1, 1, 1, 1, 1, 0]
    assert reads.tolist() == [[1] * 5 + [0] * 7]
