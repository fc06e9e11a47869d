"""The redesigned Φ kernels' host side: K7's Temp window height (the rule
`common.window_rows` shares with K3, here with B rows), the byte
decode tables of the OTF kernels, the cached pull order, and the absence
of float atomics from the CUDA sources (the bitwise contracts depend on
a fixed summation order).

The kernels themselves run only on the card (`chip_smoke.py`); here their
wrappers run the plain versions, which must not depend on the window.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core.encoding import delinearize_np as jdelinearize_np
from repro.sparse import synthetic as jsyn
from repro_torch.core import alto as talto
from repro_torch.core import encoding as tenc
from repro_torch.core import mttkrp as tmttkrp
from repro_torch.core import views as tviews
from repro_torch.kernels import common
from repro_torch.kernels import cpapr_phi as tk7
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")
H100_SMEM = 232_448          # one CTA's opt-in shared memory on an H100


# ---------------------------------------------------------------------------
# K7's window height
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [48 * 1024, H100_SMEM])
@pytest.mark.parametrize("rank", [1, 5, 16, 40, 1024])
@pytest.mark.parametrize("temp_rows", [1, 2, 127, 5_000, 1_000_000])
def test_window_rows_cover_temp_within_the_byte_limit(temp_rows, rank,
                                                      limit):
    h = common.window_rows(temp_rows, rank, limit, True)
    assert 1 <= h <= temp_rows
    assert -(-temp_rows // h) * h >= temp_rows          # windows cover T
    tile = common.tile_nnz(rank)
    assert common.smem_bytes(h, rank, tile, True) <= limit
    if h < temp_rows:                                   # the most that fit
        assert common.smem_bytes(h + 1, rank, tile, True) > limit


def test_window_rows_take_all_of_a_small_temp():
    """Chicago's mode 0 (T = 127, R = 16) fits one window on an H100: 25
    KB."""
    assert common.window_rows(127, 16, H100_SMEM, True) == 127
    assert common.window_rows(1, 16, H100_SMEM, True) == 1
    assert common.smem_bytes(127, 16, common.tile_nnz(16), True) == 24_960


def test_window_rows_refuse_a_limit_without_one_row():
    rank = 16
    tile = common.tile_nnz(rank)
    limit = common.smem_bytes(1, rank, tile, True)
    assert common.window_rows(10, rank, limit, True) == 1
    with pytest.raises(ValueError, match="shared memory"):
        common.window_rows(10, rank, limit - 1, True)


@pytest.mark.parametrize("rank", [1, 5, 16, 32, 40, 128, 1024])
def test_tile_nnz_bounds(rank):
    tile = common.tile_nnz(rank)
    assert 8 <= tile <= 128 and tile % 8 == 0
    assert tile * rank * 4 <= max(common.TILE_BYTES, 8 * rank * 4)


@pytest.mark.parametrize("window", [1, 3, None])
@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_windowed_partials_equal_one_window_on_cpu(window, policy):
    x = tsyn.blocked_tensor((30, 24, 20), 700, block=5, n_blocks=6, seed=3,
                            count_data=True)
    at = talto.build_device(x, n_partitions=6, device="cpu")
    rng = np.random.default_rng(4)
    fs = [torch.from_numpy(rng.random((I, 5)).astype(np.float32) + 0.1)
          for I in x.dims]
    B = torch.from_numpy(rng.random((x.dims[0], 5)).astype(np.float32))
    m = at.meta
    kw = (dict(factors=fs) if policy == "otf" else dict(
        pi=tmttkrp.krp_rows(at.coords(), fs, 0).contiguous()))
    args = (m.enc, 0, m.temp_rows[0], 1e-10, at.words, at.values,
            at.part_start, B)
    one = tk7.phi_partials(*args, **kw)
    assert torch.equal(tk7.phi_partials_windowed(*args, **kw,
                                                 window=window), one)


def test_windowed_partials_reject_an_empty_window():
    x = tsyn.blocked_tensor((30, 24, 20), 300, block=5, n_blocks=6, seed=3,
                            count_data=True)
    at = talto.build_device(x, n_partitions=4, device="cpu")
    fs = [torch.ones((I, 4)) for I in x.dims]
    m = at.meta
    with pytest.raises(ValueError, match="window"):
        tk7.phi_partials_windowed(m.enc, 0, m.temp_rows[0], 1e-10, at.words,
                                  at.values, at.part_start, fs[0],
                                  factors=fs, window=0)


# ---------------------------------------------------------------------------
# Byte decode tables (alto_coord_table)
# ---------------------------------------------------------------------------

def _table_decode(enc, words: np.ndarray) -> np.ndarray:
    """What alto_coord_table computes, in numpy: the OR of four lookups
    per word and mode."""
    t = common.decode_table_np(enc)
    w = words.astype(np.uint32).reshape(words.shape[0], enc.n_words)
    out = np.zeros((w.shape[0], enc.ndim), dtype=np.uint32)
    for m in range(enc.ndim):
        for k in range(enc.n_words):
            for j in range(4):
                out[:, m] |= t[m, k, j][(w[:, k] >> (8 * j)) & 255]
    return out.astype(np.int32)


@pytest.mark.parametrize("dims", [(6186, 24, 77, 32),
                                  (22476, 22476, 23_776_223),
                                  (3, 5, 7, 11, 13), (1 << 20, 3, 1 << 12),
                                  (1, 9, 1), (2, 2)])
def test_decode_tables_match_the_encoding(dims):
    """The tables decode every mode of random coordinates exactly, and
    agree with the JAX package's decode of the same words."""
    enc = tenc.make_encoding(dims)
    rng = np.random.default_rng(len(dims))
    coords = np.stack([rng.integers(0, d, 3000) for d in dims],
                      axis=1).astype(np.int32)
    words = tenc.linearize_np(enc, coords)
    got = _table_decode(enc, words)
    assert np.array_equal(got, coords)
    assert np.array_equal(got, tenc.delinearize_np(enc, words))
    jx = jsyn.uniform_tensor(dims, 50, seed=2) if np.prod(dims) > 60 \
        else None
    if jx is not None:
        jat = jalto.build(jx, n_partitions=2)
        jw = np.asarray(jat.words)
        assert np.array_equal(_table_decode(enc, jw),
                              jdelinearize_np(jat.meta.enc, jw))


def test_decode_table_is_cached_per_device():
    enc = tenc.make_encoding((30, 24, 20))
    a = common.decode_table(enc, "cpu")
    assert a is common.decode_table(enc, torch.device("cpu"))
    assert a.dtype == torch.int32
    assert a.shape == (3, enc.n_words, 4, 256)


# ---------------------------------------------------------------------------
# The pull order, cached per (tensor, mode)
# ---------------------------------------------------------------------------

@pytest.fixture()
def tensor():
    tviews.cache_clear()
    x = tsyn.blocked_tensor((40, 24, 20), 900, block=6, n_blocks=6, seed=8,
                            count_data=True)
    yield talto.build_device(x, n_partitions=8, device="cpu"), x
    tviews.cache_clear()


def test_cached_pull_order_equals_a_fresh_sort(tensor):
    """The cached order is a fresh reach build: the distinct (row,
    partition) pairs of the stream's coordinates of the mode."""
    at, _ = tensor
    m = at.meta
    for mode in range(3):
        got = tviews.get_pull_order(at, mode)
        rows, order = tmttkrp.reach_pieces(
            at.coords()[:, mode], at.part_start[:, mode], m.temp_rows[mode])
        assert torch.equal(got.rows[:, 0].long(), rows)
        assert torch.equal(got.order, order)
        assert got.rows.dtype == torch.int32 and got.rows.is_contiguous()


def test_second_pull_does_no_sort(tensor):
    """The recursive Φ and MTTKRP routes sort the pull's pieces once per
    (tensor, mode); later calls reuse the order, with equal bits."""
    at, x = tensor
    rng = np.random.default_rng(9)
    fs = [torch.from_numpy(rng.random((I, 4)).astype(np.float32) + 0.1)
          for I in x.dims]
    B = fs[0] * 2.0
    first = tops.cpapr_phi(at, B, 0, factors=fs)
    sorts = tmttkrp.pull_sorts()
    again = tops.cpapr_phi(at, B, 0, factors=fs)
    mttkrp = tops.mttkrp(at, fs, 0)
    assert tmttkrp.pull_sorts() == sorts
    assert torch.equal(first, again)
    temp = tk7.phi_partials(at.meta.enc, 0, at.meta.temp_rows[0], 1e-10,
                            at.words, at.values, at.part_start, B,
                            factors=fs)
    assert torch.equal(first, tops.pull_reduction(
        temp, at.part_start[:, 0], at.meta.dims[0]))
    assert torch.equal(mttkrp, tmttkrp.mttkrp_recursive(at, fs, 0))
    sorts = tmttkrp.pull_sorts()
    tops.cpapr_phi(at, fs[1] * 2.0, 1, factors=fs)     # a new mode sorts
    assert tmttkrp.pull_sorts() == sorts + 1


def test_pull_order_follows_partitioning_and_invalidation(tensor):
    at, x = tensor
    order = tviews.get_pull_order(at, 0)
    assert tviews.get_pull_order(at, 0) is order
    retiled = talto.build_device(x, n_partitions=4, device="cpu")
    other = tviews.get_pull_order(retiled, 0)
    rows = retiled.coords()[:, 0].reshape(4, -1).tolist()
    assert other.order.shape[0] == sum(len(set(r)) for r in rows)
    assert other.order.shape[0] != order.order.shape[0]
    assert tviews.invalidate(at, modes=[0]) >= 1
    sorts = tmttkrp.pull_sorts()
    tviews.get_pull_order(at, 0)
    assert tmttkrp.pull_sorts() == sorts + 1


# ---------------------------------------------------------------------------
# No float atomics in the CUDA sources
# ---------------------------------------------------------------------------

_ATOMIC_CALL = re.compile(
    r"\b(?:atomicAdd|atomicAdd_block|atomicAdd_system|unsafeAtomicAdd|"
    r"atomicSub|atomicExch)\s*\(")
_ATOMIC_PTX = re.compile(r"\b(?:red|atom)\.[a-z0-9_.]*\.f(?:16|32|64)\b")


def _code(text: str) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_cuda_sources_have_no_float_atomics():
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert len(sources) >= 9
    for path in sources:
        code = _code(path.read_text())
        assert not _ATOMIC_CALL.search(code), f"{path.name} adds atomically"
        assert not _ATOMIC_PTX.search(code), f"{path.name}: PTX float atomic"


def test_the_atomic_scan_finds_one():
    """The scan above sees an atomic add, in C++ or in inline PTX, and
    skips comments."""
    assert _ATOMIC_CALL.search(_code("x; atomicAdd (p + r, v);"))
    assert _ATOMIC_PTX.search(_code('asm("red.global.add.f32 [%0], %1;")'))
    assert not _ATOMIC_CALL.search(_code("// atomicAdd(p, v)\n/* atomicAdd(q) */"))
