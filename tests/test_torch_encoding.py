"""Port parity: ALTO encoding and bit work, torch vs the JAX package.

Words, sort order and distinct counts must match the reference bit for
bit. Also holds the port's package rules: no import of JAX or of the JAX
package, and no quiet CPU fallback when CUDA is absent.
"""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import encoding as jenc
from repro.core import mttkrp as jmttkrp
from repro.kernels import ops as jops
from repro_torch.core import alto as talto
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import encoding as tenc
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn

ROOT = pathlib.Path(__file__).resolve().parent.parent

# 1, 2 and 4 index words; a length-1 mode; a non-power-of-two mix.
SHAPES = [(30, 24, 20), (6186, 24, 77, 32), (22476, 22476, 2 ** 20),
          (1 << 20, 1 << 20, 1 << 20, 1 << 20, 7), (5, 1, 9)]


def _coords(dims, n, seed):
    rng = np.random.default_rng(seed)
    c = np.stack([rng.integers(0, I, size=n) for I in dims], axis=1)
    return c.astype(np.int32)


@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_make_encoding_matches(dims):
    ours, ref = tenc.make_encoding(dims), jenc.make_encoding(dims)
    assert ours.n_words == ref.n_words
    assert (ours.mode_bits, ours.bit_mode, ours.bit_pos) == \
        (ref.mode_bits, ref.bit_mode, ref.bit_pos)
    assert [dataclasses.astuple(r) for r in ours.runs] == \
        [dataclasses.astuple(r) for r in ref.runs]
    np.testing.assert_array_equal(ours.mode_masks(), ref.mode_masks())


@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_linearize_delinearize_bitwise(dims):
    enc = tenc.make_encoding(dims)
    coords = _coords(dims, 500, seed=1)
    ref = jenc.linearize_np(jenc.make_encoding(dims), coords)
    words = tenc.linearize(enc, torch.from_numpy(coords))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(tenc.words_to_np(words), ref)
    np.testing.assert_array_equal(tenc.linearize_np(enc, coords), ref)
    back = tenc.delinearize(enc, words)
    np.testing.assert_array_equal(back.numpy(), coords)
    np.testing.assert_array_equal(tenc.delinearize_np(enc, ref), coords)
    for m in range(len(dims)):
        np.testing.assert_array_equal(
            tenc.extract_mode(enc, words, m).numpy(), coords[:, m])
        np.testing.assert_array_equal(
            tenc.extract_mode_np(enc, ref, m),
            jenc.extract_mode(jenc.make_encoding(dims), ref, m))


@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_sort_by_key_stable_order(dims):
    enc = tenc.make_encoding(dims)
    coords = _coords(dims, 400, seed=2)
    coords = np.concatenate([coords, coords[::3]])     # duplicate keys
    ref_words = jenc.linearize_np(jenc.make_encoding(dims), coords)
    ref_order = jenc.sort_key_np(ref_words)
    words = tenc.linearize(enc, torch.from_numpy(coords))
    idx = torch.arange(coords.shape[0])
    srt, order = tenc.sort_by_key(words, idx)
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_array_equal(tenc.words_to_np(srt),
                                  ref_words[ref_order])
    assert tenc.count_distinct(words) == jenc.count_distinct_np(ref_words)
    assert tenc.count_distinct_np(ref_words) == \
        jenc.count_distinct_np(ref_words)


@pytest.mark.parametrize("block_m", [64, 1024])
@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_delinearize_kernel_matches_pallas(dims, block_m):
    """K4 through `ops.delinearize` (its plain version on the CPU) equals
    the JAX package's Pallas decode in interpret mode, bit for bit; 500
    words, a ragged last tile of the port's kernel, unpadded."""
    coords = _coords(dims, 500, seed=4)
    words = jenc.linearize_np(jenc.make_encoding(dims), coords)
    ref = jops.delinearize(jenc.make_encoding(dims), jnp.asarray(words),
                           block_m=block_m, interpret=True)
    got = tops.delinearize(tenc.make_encoding(dims),
                           tenc.words_from_np(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), coords)


@pytest.mark.parametrize("rank", [5, 16])
@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_pi_rows_matches_jax_pi_build(dims, rank):
    """`ops.pi_rows` (its plain version on the CPU) equals, for every
    mode, the JAX package's ALTO-PRE Π build (`src/repro/core/cpapr.py`:
    `alto.delinearize`, then `mttkrp.krp_rows`) bit for bit; 500 words,
    factors drawn at the rows they address."""
    coords = _coords(dims, 500, seed=6)
    words = jenc.linearize_np(jenc.make_encoding(dims), coords)
    rng = np.random.default_rng(rank)
    factors = []
    for m, d in enumerate(dims):
        A = np.zeros((d, rank), dtype=np.float32)
        A[coords[:, m]] = rng.standard_normal((500, rank)).astype(np.float32)
        factors.append(A)
    jcoords = jalto.delinearize(jenc.make_encoding(dims), jnp.asarray(words))
    enc = tenc.make_encoding(dims)
    for mode in range(len(dims)):
        ref = jmttkrp.krp_rows(jcoords, [jnp.asarray(A) for A in factors],
                               mode)
        got = tops.pi_rows(enc, tenc.words_from_np(words),
                           [torch.from_numpy(A) for A in factors], mode)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_high_bit_words_sort_unsigned():
    """Words with bit 31 set must sort above those without (the int32
    storage must not leak a signed order)."""
    w = np.array([[0, 0x80000000], [5, 0x7FFFFFFF], [1, 0xFFFFFFFF],
                  [0xFFFFFFFF, 0x80000000], [2, 0]], dtype=np.uint32)
    srt, order = tenc.sort_by_key(tenc.words_from_np(w), torch.arange(5))
    np.testing.assert_array_equal(order.numpy(), jenc.sort_key_np(w))
    assert tenc.count_distinct(tenc.words_from_np(w)) == 5


def test_synthetic_generators_identical():
    """The same seed gives the same tensor in both packages."""
    from repro.sparse import synthetic as jsyn
    for name in ("uniform_tensor", "blocked_tensor", "zipf_tensor"):
        a = getattr(tsyn, name)((40, 30, 20), 600, seed=3, count_data=True)
        b = getattr(jsyn, name)((40, 30, 20), 600, seed=3, count_data=True)
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.values, b.values)
    a, fa = tsyn.lowrank_gaussian((20, 10, 8), 3, 300, seed=4)
    b, fb = jsyn.lowrank_gaussian((20, 10, 8), 3, 300, seed=4)
    np.testing.assert_array_equal(a.values, b.values)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        sorted((ROOT / "examples").glob("torch_*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                           "ml_dtypes")]
    assert bad == []


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    x = tsyn.uniform_tensor((8, 6, 5), 40, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        talto.build_device(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        talto.build(x)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcpals.init_factors(x.dims, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcpapr.init_factors(x.dims, 2)
    at = talto.build_device(x, device="cpu")
    assert at.words.device.type == "cpu"
