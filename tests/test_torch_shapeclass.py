"""Port parity: shape classes (`core.shapeclass`), the class plan and its
plan-store key.

`classify`, `pad_to_class`, `canonical_meta` and `canonicalize_tensor`
must equal the JAX package's: class dims and nnz, the padded COO bit for
bit (value-0 copies of the last element; the zero coordinate for an empty
tensor), the canonical meta field by field, and the canonicalized
tensor's stream and boxes bit for bit. The class plan routes every mode
output-oriented, and its store key depends on the class alone.
"""
import numpy as np
import pytest

from repro.core import alto as jalto
from repro.core import shapeclass as jsc
from repro.sparse import synthetic as jsyn
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch.core import alto as talto
from repro_torch.core import autotune as tautotune
from repro_torch.core import encoding as tenc
from repro_torch.core import heuristics as theur
from repro_torch.core import plan as tplan
from repro_torch.core import shapeclass as tsc
from repro_torch.sparse.tensor import SparseTensor as TSparse

RANK = 4


def _empty(dims):
    return JSparse(tuple(dims), np.zeros((0, len(dims)), np.int32),
                   np.zeros((0,), np.float32))


TENSORS = {
    "empty": lambda: _empty((6, 5, 4)),
    "single": lambda: JSparse((6, 5, 4), np.array([[2, 3, 1]], np.int32),
                              np.array([2.5], np.float32)),
    "uniform_9x7x5": lambda: jsyn.uniform_tensor((9, 7, 5), 90, seed=1),
    "uniform_12x6x8": lambda: jsyn.uniform_tensor((12, 6, 8), 100, seed=2),
    "pow2_16x8x8": lambda: jsyn.uniform_tensor((16, 8, 8), 128, seed=3),
    "four_modes": lambda: jsyn.uniform_tensor((33, 5, 17, 3), 300, seed=4,
                                              count_data=True),
}


def _port(x):
    return TSparse(x.dims, x.coords, x.values)


def _assert_same_meta(got, ref):
    assert got.enc.dims == ref.enc.dims
    assert got.enc.mode_bits == ref.enc.mode_bits
    assert got.enc.bit_mode == ref.enc.bit_mode
    assert got.enc.bit_pos == ref.enc.bit_pos
    assert [tuple(vars(r).values()) for r in got.enc.runs] == \
        [tuple(vars(r).values()) for r in ref.enc.runs]
    assert (got.nnz, got.n_partitions, got.temp_rows) == \
        (ref.nnz, ref.n_partitions, ref.temp_rows)
    np.testing.assert_array_equal(got.fiber_reuse, ref.fiber_reuse)


@pytest.mark.parametrize("L", [1, 8, 16])
@pytest.mark.parametrize("name", sorted(TENSORS))
def test_class_and_padding_match_the_jax_package(name, L):
    x = TENSORS[name]()
    ref = jsc.classify(x, RANK, n_partitions=L)
    got = tsc.classify(_port(x), RANK, n_partitions=L)
    assert (got.dims, got.nnz, got.n_partitions, got.rank, got.dtype) == \
        (ref.dims, ref.nnz, ref.n_partitions, ref.rank, ref.dtype)
    assert got.nnz % L == 0 and got.admits(_port(x))
    xp_ref = jsc.pad_to_class(x, ref)
    xp = tsc.pad_to_class(_port(x), got)
    assert xp.dims == xp_ref.dims
    np.testing.assert_array_equal(xp.coords, np.asarray(xp_ref.coords))
    np.testing.assert_array_equal(xp.values.view(np.uint32),
                                  np.asarray(xp_ref.values).view(np.uint32))
    assert not xp.values[x.nnz:].any()
    _assert_same_meta(tsc.canonical_meta(got), jsc.canonical_meta(ref))


@pytest.mark.parametrize("name", ["empty", "single", "uniform_12x6x8",
                                  "four_modes"])
def test_canonicalized_tensor_matches_the_jax_package(name):
    x = TENSORS[name]()
    sc_j = jsc.classify(x, RANK)
    sc_t = tsc.classify(_port(x), RANK)
    ref = jsc.canonicalize_tensor(
        jalto.build(jsc.pad_to_class(x, sc_j), n_partitions=sc_j.n_partitions,
                    compute_reuse=False), sc_j)
    at = tsc.canonicalize_tensor(
        talto.build_device(tsc.pad_to_class(_port(x), sc_t),
                           n_partitions=sc_t.n_partitions,
                           compute_reuse=False, device="cpu"), sc_t)
    _assert_same_meta(at.meta, ref.meta)
    np.testing.assert_array_equal(tenc.words_to_np(at.words),
                                  np.asarray(ref.words))
    np.testing.assert_array_equal(at.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(at.part_start.numpy(),
                                  np.asarray(ref.part_start))
    np.testing.assert_array_equal(at.part_end.numpy(),
                                  np.asarray(ref.part_end))


def test_pad_and_canonicalize_refuse_a_foreign_tensor():
    x = _port(TENSORS["uniform_12x6x8"]())
    small = tsc.ShapeClass(dims=(8, 8, 8), nnz=128, n_partitions=8,
                           rank=RANK)
    assert not small.admits(x)
    with pytest.raises(ValueError, match="does not fit"):
        tsc.pad_to_class(x, small)
    sc = tsc.classify(x, RANK)
    raw = talto.build_device(x, n_partitions=8, device="cpu")
    with pytest.raises(ValueError, match="pad_to_class"):
        tsc.canonicalize_tensor(raw, sc)


def test_class_plan_key_is_tenant_independent():
    xs = [_port(TENSORS[n]()) for n in ("uniform_9x7x5", "uniform_12x6x8",
                                        "pow2_16x8x8")]
    scs = {tsc.classify(x, RANK) for x in xs}
    assert len(scs) == 1
    (sc,) = scs
    key = tautotune.class_plan_key(sc, "cuda", device="cpu")
    assert key == tautotune.plan_key(tsc.canonical_meta(sc), RANK, "cuda",
                                     device="cpu")
    bigger = tsc.ShapeClass(dims=sc.dims, nnz=2 * sc.nnz,
                            n_partitions=sc.n_partitions, rank=RANK)
    assert tautotune.class_plan_key(bigger, "cuda", device="cpu") != key
    other_rank = tsc.ShapeClass(dims=sc.dims, nnz=sc.nnz,
                                n_partitions=sc.n_partitions, rank=RANK + 1)
    assert tautotune.class_plan_key(other_rank, "cuda", device="cpu") != key


@pytest.mark.parametrize("dims,nnz", [((16, 8, 8), 128),
                                      ((4096, 4096, 65536), 262144),
                                      ((32768, 32768, 4194304), 65536)])
def test_class_plan_routes_every_mode_oriented(dims, nnz):
    sc = tsc.ShapeClass(dims=dims, nnz=nnz, n_partitions=8, rank=16)
    p = tplan.make_class_plan(sc, backend="cuda")
    assert p.meta == tsc.canonical_meta(sc)
    assert all(theur.is_oriented(m.traversal) for m in p.modes)
    if dims[2] > 2 * nnz:        # hyper-sparse: one-hot on the long mode
        assert p.traversals() == ("oriented_carry", "oriented_carry",
                                  "oriented")
        assert p.pi_policy is theur.PiPolicy.PRE
