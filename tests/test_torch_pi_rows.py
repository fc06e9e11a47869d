"""The ALTO-PRE Π build (`kernels.delinearize.pi_rows`, `ops.pi_rows`):
decode, gather and multiply in one pass.

1. On CPU tensors the wrapper and the plain version equal `krp_rows` on
   the bit-by-bit decode (`kernels.ref.ref_delinearize`) bit for bit, at
   N = 3 and 4, W = 1, 2 and 4, R = 5, 16 and 40, every mode, M = 0 and a
   ragged M; and so does each tenant of a bucket of 3 stacked along the
   tenant axis.
2. The wrapper raises on what the kernel does not take, stacked operands
   whose tenant counts differ included.
3. On the card (marked ``card``; skips without one) the kernel equals the
   plain version bit for bit on the same cases, under each decode route,
   on a repeat, and on the one-float column path of a misaligned factor,
   one launch a call; a stacked launch is one launch and equals its
   tenants' solo launches bit for bit.
4. ``cp_apr(pi_policy="pre")`` builds Π through `ops.pi_rows` once a mode
   update, and its λ and factors equal bit for bit those of a run whose Π
   comes from `krp_rows` on the decoded coordinates (CPU and card).

No JAX here: the card's tests run in this file. The JAX package's Π
build is held against `ops.pi_rows` in `test_torch_encoding.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import alto as talto
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import encoding as tenc
from repro_torch.core.mttkrp import krp_rows
from repro_torch.kernels import _build, ops
from repro_torch.kernels import delinearize as tk4
from repro_torch.kernels.mttkrp_oriented import tenant_loop
from repro_torch.kernels.ref import ref_delinearize
from repro_torch.sparse import synthetic as tsyn

# (N, W) -> dims: each mode as many bits as the word count needs.
SHAPES = {
    (3, 1): (30, 24, 20),
    (3, 2): (22476, 22476, 23_776_223),
    (3, 4): ((1 << 21) + 1, (1 << 21) + 1, (1 << 20) + 1),
    (4, 1): (6186, 24, 77, 32),
    (4, 2): (4097, 4097, 4097, 4097),
    (4, 4): ((1 << 16) + 1,) * 4,
}
RAGGED_M = 1283          # no multiple of a tile or of 4
CASES = [(nw, R, M) for nw in SHAPES for R in (5, 16, 40)
         for M in (0, RAGGED_M)]
T = 3                    # tenants of a stacked case
STACKED = [case + (T,) for case in CASES]


@pytest.fixture
def card():
    """The CUDA device, for a test marked ``card``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(case):
    (n, w), R, M = case[:3]
    return f"N{n}-W{w}-R{R}-M{M}" + "".join(f"-T{t}" for t in case[3:])


def _case(nw, R, M, device="cpu", seed=0):
    """An encoding, M words of random coordinates and N factors whose rows
    at those coordinates are drawn (the rest are never read: a factor of
    2 M rows stays mostly unbacked)."""
    dims = SHAPES[nw]
    enc = tenc.make_encoding(dims)
    assert (enc.ndim, enc.n_words) == nw
    rng = np.random.default_rng(seed + R + M)
    coords = np.stack([rng.integers(0, d, M) for d in dims],
                      axis=1).astype(np.int32)
    words = tenc.words_from_np(tenc.linearize_np(enc, coords)).to(device)
    factors = []
    for m, d in enumerate(dims):
        A = torch.empty((d, R), dtype=torch.float32)
        rows = torch.from_numpy(coords[:, m].astype(np.int64))
        A[rows] = torch.from_numpy(
            rng.standard_normal((M, R)).astype(np.float32))
        factors.append(A.to(device))
    return enc, words, factors


def _stacked_case(nw, R, M, tenants, device="cpu"):
    """`_case` for each of ``tenants`` seeds, stacked: words ``(T, M, W)``
    and factors ``(T, I_m, R)`` holding each tenant's drawn rows (the rest
    are never read), with the tenants' own ``(words, factors)``."""
    solos = [_case(nw, R, M, seed=100 * t) for t in range(tenants)]
    enc = solos[0][0]
    words = torch.stack([w for _, w, _ in solos]).to(device)
    factors = []
    for m, d in enumerate(SHAPES[nw]):
        A = torch.empty((tenants, d, R), dtype=torch.float32, device=device)
        for t, (_, w, fs) in enumerate(solos):
            rows = ref_delinearize(enc, w)[:, m].long().unique()
            A[t, rows.to(device)] = fs[m][rows].to(device)
        factors.append(A)
    return enc, words, factors, [(w, fs) for _, w, fs in solos]


def _expected(enc, words, factors, mode):
    coords = ref_delinearize(enc, words.cpu())
    return krp_rows(coords, [f.cpu() for f in factors], mode).contiguous()


# ---------------------------------------------------------------------------
# 1. CPU: bit for bit krp_rows on the bit decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES + STACKED, ids=_ids)
def test_pi_rows_equal_krp_rows_of_the_bit_decode(case):
    """A stacked case: each tenant's rows are those of its own words and
    factors."""
    if len(case) == 4:
        enc, words, factors, solos = _stacked_case(*case)
        lead = (case[3],)
    else:
        enc, words, factors = _case(*case)
        solos, lead = [(words, factors)], ()
    M, R = case[2], case[1]
    for mode in range(enc.ndim):
        want = torch.stack([_expected(enc, w, fs, mode) for w, fs in solos])
        got = ops.pi_rows(enc, words, factors, mode)
        assert got.shape == lead + (M, R) and got.dtype == torch.float32
        assert got.is_contiguous()
        assert torch.equal(got, want.reshape(got.shape))
        for w, fs in solos:
            assert torch.equal(tk4.pi_rows_plain(enc, w, fs, mode),
                               _expected(enc, w, fs, mode))


# ---------------------------------------------------------------------------
# 2. What the wrapper refuses
# ---------------------------------------------------------------------------

def _bad_dtype_words(enc, w, fs):
    return w.long(), fs, 0, TypeError


def _bad_dtype_factor(enc, w, fs):
    return w, [fs[0].double()] + fs[1:], 1, TypeError


def _bad_shape_factor(enc, w, fs):
    return w, fs[:1] + [fs[1][:-1].contiguous()] + fs[2:], 0, ValueError


def _bad_shape_words(enc, w, fs):
    return w[:, :1].contiguous().repeat(1, 2), fs, 0, ValueError


def _non_contiguous_factor(enc, w, fs):
    A = fs[2]
    return w, fs[:2] + [A.t().contiguous().t()], 0, ValueError


def _bad_mode(enc, w, fs):
    return w, fs, 3, ValueError


def _stack(x, tenants):
    return torch.stack([x] * tenants)


def _bad_tenants_factor(enc, w, fs):
    """Three tenants' words and factors but one factor of two tenants."""
    stacked = [_stack(f, 3) for f in fs]
    stacked[1] = stacked[1][:2].contiguous()
    return _stack(w, 3), stacked, 0, ValueError


def _tenants_words_factors(enc, w, fs):
    """Three tenants' words, two tenants' factors."""
    return _stack(w, 3), [_stack(f, 2) for f in fs], 0, ValueError


def _stacked_factors_solo_words(enc, w, fs):
    return w, [_stack(f, 3) for f in fs], 0, ValueError


def _words_of_four_axes(enc, w, fs):
    return _stack(_stack(w, 3), 2), [_stack(f, 3) for f in fs], 0, ValueError


@pytest.mark.parametrize("bad", [_bad_dtype_words, _bad_dtype_factor,
                                 _bad_shape_factor, _bad_shape_words,
                                 _non_contiguous_factor, _bad_mode,
                                 _bad_tenants_factor, _tenants_words_factors,
                                 _stacked_factors_solo_words,
                                 _words_of_four_axes],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_pi_rows_rejects(bad):
    enc, words, factors = _case((3, 1), 4, 50)
    w, fs, mode, err = bad(enc, words, factors)
    with pytest.raises(err):
        ops.pi_rows(enc, w, fs, mode)


# ---------------------------------------------------------------------------
# 3. The card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_pi_rows_kernel_equals_plain_on_the_card(card, case, monkeypatch):
    """Under the ``"smem"`` decode route, then under ``"l1"``, which a
    shared-memory limit of 0 bytes makes `choose_route` pick."""
    enc, words, factors = _case(*case, device=card)
    for mode in range(enc.ndim):
        plain = tk4.pi_rows_plain(enc, words, factors, mode)
        _build.reset_counts()
        got = ops.pi_rows(enc, words, factors, mode)
        again = ops.pi_rows(enc, words, factors, mode)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["pi_rows"] == 2
        assert _build.PLAIN_ON_CUDA["pi_rows"] == 0
        assert torch.equal(got, plain) and torch.equal(again, got)
    monkeypatch.setattr(tk4.common, "smem_limit", lambda device: 0)
    for mode in range(enc.ndim):
        assert torch.equal(ops.pi_rows(enc, words, factors, mode),
                           tk4.pi_rows_plain(enc, words, factors, mode))


@pytest.mark.card
@pytest.mark.parametrize("R", [16, 40])
def test_pi_rows_one_float_columns_of_a_misaligned_factor(card, R):
    """A factor 4 bytes off a 16-byte boundary takes the one-float column
    path, with the same bits."""
    enc, words, factors = _case((3, 2), R, RAGGED_M, device=card)
    A = factors[1]
    flat = torch.empty(A.numel() + 1, dtype=A.dtype, device=card)
    shifted = flat[1:].view(A.shape)
    shifted.copy_(A)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    moved = [factors[0], shifted, factors[2]]
    for mode in (0, 2):
        assert torch.equal(ops.pi_rows(enc, words, moved, mode),
                           tk4.pi_rows_plain(enc, words, factors, mode))


@pytest.mark.card
@pytest.mark.parametrize("case", STACKED, ids=_ids)
def test_pi_rows_stacked_launch_equals_its_solo_launches_on_the_card(
        card, case, monkeypatch):
    """One launch for the bucket, equal bit for bit to each tenant's solo
    launch and to the plain version, under each decode route."""
    enc, words, factors, _ = _stacked_case(*case, device=card)
    lead = (case[3],)

    def check():
        for mode in range(enc.ndim):
            _build.reset_counts()
            got = ops.pi_rows(enc, words, factors, mode)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["pi_rows"] == 1
            assert got.shape == lead + (case[2], case[1])
            solo = torch.stack([ops.pi_rows(enc, words[t],
                                            [f[t] for f in factors], mode)
                                for t in range(case[3])])
            assert torch.equal(got, solo)
            plain = tenant_loop(tk4.pi_rows_plain, lead, enc, words,
                                factors, mode)
            assert torch.equal(got, plain)
            assert _build.PLAIN_ON_CUDA["pi_rows"] == case[3]
    check()
    monkeypatch.setattr(tk4.common, "smem_limit", lambda device: 0)
    check()


# ---------------------------------------------------------------------------
# 4. CP-APR under ALTO-PRE builds Π through ops.pi_rows
# ---------------------------------------------------------------------------

def _apr_pre(at, monkeypatch, pi_fn):
    calls = []

    def counted(enc, words, factors, mode):
        calls.append(mode)
        return pi_fn(enc, words, factors, mode)
    monkeypatch.setattr(ops, "pi_rows", counted)
    lam0, f0 = tcpapr.init_factors(at.dims, 4, seed=5,
                                   total=float(at.values.sum()),
                                   device=at.device)
    res = tcpapr.cp_apr(at, 4, tcpapr.CpaprParams(k_max=3, l_max=4),
                        pi_policy="pre", factors=[f.clone() for f in f0],
                        lam=lam0.clone())
    return res, calls


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.card)])
def test_cp_apr_pre_builds_pi_through_pi_rows(device, request,
                                              monkeypatch):
    if device == "cuda":
        request.getfixturevalue("card")
    x = tsyn.uniform_tensor((30, 24, 20), 900, seed=2, count_data=True)
    at = talto.build_device(x, n_partitions=8, device=device)
    kernel = ops.pi_rows
    res, calls = _apr_pre(at, monkeypatch, kernel)
    assert res.pi_policy == "pre"
    assert calls == list(range(at.meta.enc.ndim)) * res.n_outer

    def unfused(enc, words, factors, mode):
        return krp_rows(ops.delinearize(enc, words), factors,
                        mode).contiguous()
    ref, _ = _apr_pre(at, monkeypatch, unfused)
    assert torch.equal(res.lam, ref.lam)
    for a, b in zip(res.factors, ref.factors):
        assert torch.equal(a, b)
    assert res.kkt_violations == ref.kkt_violations
