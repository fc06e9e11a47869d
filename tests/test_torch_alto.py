"""Port parity: ALTO format generation and oriented views, bit for bit.

Streams, padded tails, partition boxes, temp_rows, fiber reuse and view
rows/words/values/perm of the port's `build`, `build_device`,
`oriented_view` and `oriented_view_device` must equal the JAX package's
numpy `build` / `oriented_view` exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.sparse import synthetic as jsyn
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import encoding as tenc
from repro_torch.core import views as tviews
from repro_torch.sparse.tensor import SparseTensor as TSparse

CASES = [
    # (generator, kwargs, n_partitions): 1 word, 2 words, 4 words,
    # nnz not a multiple of L, duplicate coordinates
    ("blocked_tensor", dict(dims=(60, 24, 77, 32), nnz=3000, block=8,
                            n_blocks=12, count_data=True), 16),
    ("uniform_tensor", dict(dims=(22476, 3000, 50000), nnz=2001), 8),
    ("uniform_tensor", dict(dims=(1 << 20, 1 << 20, 1 << 20, 1 << 18),
                            nnz=777), 5),
    ("zipf_tensor", dict(dims=(30, 24, 20), nnz=500), 7),
]


def _tensor(case, seed=0):
    name, kw, L = case
    x = getattr(jsyn, name)(seed=seed, **kw)
    return x, L


def _assert_same_tensor(at, ref):
    np.testing.assert_array_equal(tenc.words_to_np(at.words),
                                  np.asarray(ref.words))
    np.testing.assert_array_equal(at.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(at.part_start.numpy(),
                                  np.asarray(ref.part_start))
    np.testing.assert_array_equal(at.part_end.numpy(),
                                  np.asarray(ref.part_end))
    assert at.meta.nnz == ref.meta.nnz
    assert at.meta.n_partitions == ref.meta.n_partitions
    assert at.meta.temp_rows == ref.meta.temp_rows
    assert at.meta.fiber_reuse == ref.meta.fiber_reuse


@pytest.mark.parametrize("builder", ["build", "build_device"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0] + str(c[2]))
def test_build_bitwise(case, builder):
    x, L = _tensor(case)
    ref = jalto.build(x, n_partitions=L)
    at = getattr(talto, builder)(TSparse(x.dims, x.coords, x.values),
                                 n_partitions=L, device="cpu")
    _assert_same_tensor(at, ref)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0] + str(c[2]))
def test_oriented_views_bitwise(case):
    x, L = _tensor(case, seed=1)
    ref_at = jalto.build(x, n_partitions=L)
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=L, device="cpu")
    for mode in range(len(x.dims)):
        ref = jalto.oriented_view(ref_at, mode)
        for view in (talto.oriented_view(at, mode),
                     talto.oriented_view_device(at, mode)):
            np.testing.assert_array_equal(view.rows.numpy(),
                                          np.asarray(ref.rows))
            np.testing.assert_array_equal(tenc.words_to_np(view.words),
                                          np.asarray(ref.words))
            np.testing.assert_array_equal(view.values.numpy(),
                                          np.asarray(ref.values))
            np.testing.assert_array_equal(view.perm.numpy(),
                                          np.asarray(ref.perm))


def test_empty_and_duplicate_inputs():
    dims = (9, 7, 5)
    empty = JSparse(dims, np.zeros((0, 3), np.int32), np.zeros(0, np.float32))
    for builder in ("build", "build_device"):
        at = getattr(talto, builder)(TSparse(dims, empty.coords,
                                             empty.values),
                                     n_partitions=4, device="cpu")
        _assert_same_tensor(at, jalto.build(empty, n_partitions=4))
    c = np.array([[1, 2, 3], [1, 2, 3], [0, 0, 0], [1, 2, 3]], np.int32)
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ref = jalto.build(JSparse(dims, c, v), n_partitions=3)
    at = talto.build_device(TSparse(dims, c, v), n_partitions=3,
                            device="cpu")
    _assert_same_tensor(at, ref)


def test_interop_carries_reference_state():
    x, L = _tensor(CASES[0])
    ref = jalto.build(x, n_partitions=L)
    m = ref.meta
    at = interop.alto_tensor(
        np.asarray(ref.words), np.asarray(ref.values),
        np.asarray(ref.part_start), np.asarray(ref.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")
    _assert_same_tensor(at, ref)
    built = talto.build(TSparse(x.dims, x.coords, x.values), n_partitions=L,
                        device="cpu")
    assert at.meta == built.meta
    rv = jalto.oriented_view(ref, 2)
    view = interop.oriented_view(at.meta, 2, np.asarray(rv.rows),
                                 np.asarray(rv.words), np.asarray(rv.values),
                                 np.asarray(rv.perm), device="cpu")
    assert torch.equal(view.words, talto.oriented_view(at, 2).words)
    back = talto.to_sparse(at)
    np.testing.assert_array_equal(back.todense(), x.todense())


def test_view_cache_fingerprint_and_bounds(monkeypatch):
    tviews.cache_clear()
    x, L = _tensor(CASES[3])
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=L, device="cpu")
    same = talto.build_device(TSparse(x.dims, x.coords, x.values),
                              n_partitions=L, device="cpu")
    assert same is not at
    v1 = tviews.get_view(at, 1)
    assert tviews.get_view(same, 1) is v1   # content-keyed
    assert tviews.cache_stats()["builds"] == 1
    other = talto.build_device(TSparse(x.dims, x.coords, x.values * 2),
                               n_partitions=L, device="cpu")
    assert tviews.get_view(other, 1) is not v1
    key = tviews.mode_fingerprint(at, 1)
    assert key[:-2] == tviews.mode_fingerprint(same, 1)[:-2]
    assert key[-2] == "cpu"                 # the device is part of the key
    monkeypatch.setenv("REPRO_VIEW_CACHE_SIZE", "2")
    for mode in range(3):
        tviews.get_view(at, mode)
    stats = tviews.cache_stats()
    assert stats["size"] == 2 and stats["hits"] >= 1
    assert tviews.invalidate(at) == 2
    tviews.cache_clear()
