"""Port parity: the HiCOO and CSF baseline formats
(`repro_torch.sparse.baselines`) against the JAX package's.

* Every structure array — HiCOO's ``bptr``, ``bcoords``, ``ecoords``,
  values and ``blk_of_nnz``, each CSF tree's ``mode_order``, ``fids``,
  ``parent`` and values — is the JAX package's bit for bit, and so are
  `hicoo_coords` and every ``storage_bytes`` (HiCOO, one CSF tree,
  CSF-ALL, `AltoTensor`).
* Each mode's `mttkrp_hicoo` and `CsfAll.mttkrp` is within
  ``rtol=1e-5, atol=1e-6·max|JAX|`` of the JAX function on the same
  factors (float32 sums in other orders) and within 1e-4 relative of the
  dense oracle (`tests/test_baseline_formats.py`'s tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from proptest import given, settings, strategies as st

from repro.core import alto as jalto
from repro.sparse import baselines as jb
from repro.sparse import synthetic as jsyn
from repro_torch.core import alto as talto
from repro_torch.core import mttkrp as tm
from repro_torch.sparse import baselines as tb
from repro_torch.sparse import synthetic as tsyn

CASES = [
    ("uniform_tensor", (40, 60, 30), 2000, {}),
    ("blocked_tensor", (64, 64, 64), 3000, {}),
    ("uniform_tensor", (20, 16, 12, 8), 1500, {}),
    ("blocked_tensor", (48, 40, 36, 24), 2500, dict(block=6, n_blocks=12)),
]
IDS = ["uniform3", "blocked3", "uniform4", "blocked4"]


def _tensors(case):
    name, dims, nnz, kw = case
    return (getattr(jsyn, name)(dims, nnz, seed=3, **kw),
            getattr(tsyn, name)(dims, nnz, seed=3, **kw))


def _factors(dims, R=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((I, R)).astype(np.float32) for I in dims]


def _close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("bits", [2, 4, 7])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_hicoo_structure_bitwise(case, bits):
    jx, tx = _tensors(case)
    jh = jb.build_hicoo(jx, block_bits=bits)
    th = tb.build_hicoo(tx, block_bits=bits, device="cpu")
    for field in ("bptr", "bcoords", "ecoords"):
        a, b = getattr(th, field), getattr(jh, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th.values.numpy(), np.asarray(jh.values))
    np.testing.assert_array_equal(th.blk_of_nnz.numpy(),
                                  np.asarray(jh.blk_of_nnz))
    assert th.blk_of_nnz.dtype == torch.int32
    coords = tb.hicoo_coords(th)
    assert coords.dtype == torch.int32
    np.testing.assert_array_equal(coords.numpy(),
                                  np.asarray(jb.hicoo_coords(jh)))
    assert (th.nnz, th.n_blocks) == (jh.nnz, jh.n_blocks)
    assert th.storage_bytes() == jh.storage_bytes()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_csf_structure_bitwise(case):
    jx, tx = _tensors(case)
    jall, tall = jb.CsfAll(jx), tb.CsfAll(tx, device="cpu")
    for jt, tt in zip(jall.trees, tall.trees):
        assert tt.mode_order == jt.mode_order
        assert len(tt.fids) == len(jt.fids) == len(tt.parent)
        for a, b in zip(tt.fids + tt.parent, jt.fids + jt.parent):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tt.fids_dev + tt.parent_dev, tt.fids + tt.parent):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(tt.values.numpy(),
                                      np.asarray(jt.values))
        assert tt.storage_bytes() == jt.storage_bytes()
    assert tall.storage_bytes() == jall.storage_bytes()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mttkrp_against_jax_and_dense(case):
    jx, tx = _tensors(case)
    fs = _factors(tx.dims)
    jf = [jnp.asarray(f) for f in fs]
    tf = [torch.from_numpy(f) for f in fs]
    jh, th = jb.build_hicoo(jx, block_bits=4), tb.build_hicoo(
        tx, block_bits=4, device="cpu")
    jall, tall = jb.CsfAll(jx), tb.CsfAll(tx, device="cpu")
    dense = torch.from_numpy(tx.todense())
    for mode in range(tx.ndim):
        got_h = tb.mttkrp_hicoo(th, tf, mode)
        got_c = tall.mttkrp(tf, mode)
        _close(got_h, jb.mttkrp_hicoo(jh, jf, mode))
        _close(got_c, jall.mttkrp(jf, mode))
        ref = tm.dense_mttkrp_reference(dense, tf, mode)
        scale = float(ref.abs().max()) + 1e-9
        for got in (got_h, got_c):
            assert got.shape == ref.shape and got.dtype == torch.float32
            assert float((got - ref).abs().max()) / scale < 1e-4, mode


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_alto_storage_bytes_equal(case):
    jx, tx = _tensors(case)
    jat = jalto.build(jx, n_partitions=8)
    at = talto.build_device(tx, n_partitions=8, device="cpu")
    assert at.storage_bytes() == jat.storage_bytes()
    enc = at.meta.enc
    assert at.storage_bytes() == tx.nnz * (enc.runtime_index_bits() // 8
                                           + 4)
    for word_bits in (16, 32, 64):
        assert enc.storage_bits_coo(word_bits) == \
            jat.meta.enc.storage_bits_coo(word_bits)
        assert enc.storage_bits_alto(word_bits) == \
            jat.meta.enc.storage_bits_alto(word_bits)


def test_storage_orderings():
    """Fig. 12's orderings hold for the port's structures: CSF-ALL
    largest (N copies), ALTO never above COO, HiCOO below COO only on
    dense blocks."""
    blocked = tsyn.blocked_tensor((256, 256, 256), 60_000, block=16,
                                  n_blocks=12, seed=0)
    hyper = tsyn.uniform_tensor((2**15, 2**15, 2**15), 20_000, seed=0)
    for x, dense_blocks in ((blocked, True), (hyper, False)):
        at = talto.build_device(x, n_partitions=8, device="cpu")
        enc = at.meta.enc
        coo = x.nnz * (enc.storage_bits_coo(32) // 8 + 4)
        csf = tb.CsfAll(x, device="cpu").storage_bytes()
        hic = tb.build_hicoo(x, block_bits=7, device="cpu").storage_bytes()
        assert at.storage_bytes() <= coo
        assert csf > coo
        if dense_blocks:
            assert hic < coo
        else:
            assert hic > at.storage_bytes()


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), bits=st.sampled_from([2, 4, 7]))
def test_hicoo_roundtrip_property(seed, bits):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(8, 200, size=3))
    x = tsyn.uniform_tensor(dims, 500, seed=seed)
    h = tb.build_hicoo(x, block_bits=bits, device="cpu")
    coords = tb.hicoo_coords(h).numpy()
    assert sorted(map(tuple, coords.tolist())) == \
        sorted(map(tuple, x.coords.tolist()))
    # each nonzero's block holds it, and the blocks are in key order
    blk = h.blk_of_nnz.numpy()
    np.testing.assert_array_equal(coords >> bits, h.bcoords[blk])
    assert np.all(np.diff(h.bptr) > 0) and h.bptr[-1] == x.nnz


def test_baselines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    x = tsyn.uniform_tensor((8, 6, 5), 40, seed=0)
    for build in (tb.build_hicoo, tb.build_csf, tb.CsfAll):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(x)
