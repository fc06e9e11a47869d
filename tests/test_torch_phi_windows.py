"""K7's Temp windows: a Temp taller than one shared-memory window.

K7 (`kernels.cpapr_phi`) holds a partition's Temp and the window's B rows
in shared memory, ``window`` rows at a time, and walks the partition once
per window that its own rows reach (at most `window_passes`), storing
zeros in the rest. Any window height must give the same bits, for one
tensor and for tenants stacked on the tenant axis, and so must the
recursive Φ after its pull (`kernels.ops.cpapr_phi`), on a 4-mode blocked
tensor whose every mode is routed recursive, as FROSTT Enron's are.

The window is a card-only notion: on the CPU the plain version has none.
The CPU tests here hold the pass count, the routing of the tensor and the
spans ``repro.phi.partials`` and ``repro.phi.pull`` of each Φ; the
tests marked ``card`` (the ``card`` fixture below skips them without a
CUDA device) run the kernel: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_phi_windows.py``. No JAX here.
"""
import pytest
import torch

from repro_torch import trace
from repro_torch.core import alto as talto
from repro_torch.core import heuristics
from repro_torch.core import plan as tplan
from repro_torch.kernels import _build, common, ops
from repro_torch.kernels import cpapr_phi as tk7
from repro_torch.sparse import synthetic as tsyn
from repro_torch.sparse.tensor import SparseTensor

EPS = 1e-10
# Three blocks of side 10 at density about 0.6 once duplicates are summed:
# fiber reuse about 5.9 on every mode, above the recursive threshold (4),
# and Temps of 17 to 105 rows in 8 partitions.
DIMS = (64, 48, 200, 40)
NNZ = 27000
L = 8


@pytest.fixture
def card():
    """The CUDA device, for a test marked ``card``; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tensor(device, R=16, seed=3, nnz=None):
    """The blocked tensor of ``seed`` (its first ``nnz`` nonzeros when
    given), its factors and a B per mode."""
    x = tsyn.blocked_tensor(DIMS, NNZ, block=10, n_blocks=3, seed=seed,
                            count_data=True)
    if nnz is not None:
        x = SparseTensor(x.dims, x.coords[:nnz], x.values[:nnz])
    at = talto.build_device(x, n_partitions=L, device=device)
    g = torch.Generator().manual_seed(seed)
    fs = [(torch.rand((I, R), generator=g) + 0.1).to(device) for I in DIMS]
    Bs = [(torch.rand((I, R), generator=g) + 0.1).to(device) for I in DIMS]
    return at, fs, Bs


def _smem_for(window: int, R: int) -> int:
    """The shared memory under which `common.window_rows` gives K7
    ``window`` rows at rank R."""
    tile = common.tile_nnz(R)
    return common.smem_bytes(window, R, tile, True)


@pytest.mark.parametrize("T, window, passes", [
    (1, 1, 1), (127, 1748, 1), (1748, 1748, 1), (1749, 1748, 2),
    (8880, 1748, 6), (10, 3, 4)])
def test_window_passes(T, window, passes):
    assert tk7.window_passes(T, window) == passes


@pytest.mark.parametrize("window", [1, 2, 5, 17])
def test_smem_for_gives_the_window(window):
    assert common.window_rows(10 ** 6, 16, _smem_for(window, 16),
                              True) == window


def test_every_mode_routes_recursive_under_otf():
    at, _, _ = _tensor("cpu")
    plan = tplan.plan_for(at, 16, backend="cuda")
    assert all(r > heuristics.BUFFERED_ACCUM_COST
               for r in at.meta.fiber_reuse), at.meta.fiber_reuse
    assert plan.traversals() == ("recursive",) * 4
    assert plan.pi_policy is heuristics.PiPolicy.OTF
    assert min(at.meta.temp_rows) > 7, at.meta.temp_rows


def test_phi_partials_and_pull_spans():
    at, fs, Bs = _tensor("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for mode in range(4):
            ops.cpapr_phi(at, Bs[mode], mode, factors=fs)
    spans = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(trace.PREFIX)}
    assert spans == {"repro.phi.partials": 4, "repro.phi.pull": 4}


@pytest.mark.card
@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_k7_windows_equal_one_window_on_the_card(card, mode, policy):
    at, fs, Bs = _tensor(card)
    T = at.meta.temp_rows[mode]
    operands = (dict(factors=fs) if policy == "otf"
                else dict(pi=ops.pi_rows(at.meta.enc, at.words, fs, mode)))

    def k7(window):
        return tk7.phi_partials_windowed(
            at.meta.enc, mode, T, EPS, at.words, at.values, at.part_start,
            Bs[mode], window=window, **operands)
    whole = k7(T)
    for window in (1, 3, 7, T // 2, T - 1):
        got = k7(window)
        assert torch.equal(got, whole), (mode, policy, window)
    plain = tk7.phi_partials_plain(
        at.meta.enc, mode, T, EPS, at.words.cpu(), at.values.cpu(),
        at.part_start.cpu(), Bs[mode].cpu(),
        **{k: ([f.cpu() for f in v] if k == "factors" else v.cpu())
           for k, v in operands.items()})
    torch.testing.assert_close(whole.cpu(), plain, rtol=1e-5,
                               atol=1e-6 * float(plain.abs().max()))


@pytest.mark.card
@pytest.mark.parametrize("mode", range(4))
def test_phi_and_its_pull_through_windows_on_the_card(card, mode,
                                                      monkeypatch):
    """The whole recursive Φ (K7 and the pull) with the card's shared
    memory cut so that K7's window is a few rows: the same bits as in one
    window, and the passes counted."""
    at, fs, Bs = _tensor(card)
    T = at.meta.temp_rows[mode]
    whole = ops.cpapr_phi(at, Bs[mode], mode, factors=fs)
    for window in (2, 5, T // 2):
        monkeypatch.setattr(common, "smem_limit",
                            lambda dev, w=window: _smem_for(w, 16))
        _build.reset_counts()
        got = ops.cpapr_phi(at, Bs[mode], mode, factors=fs)
        torch.cuda.synchronize(card)
        assert torch.equal(got, whole), (mode, window)
        c = _build.counts()
        assert c["launches"]["phi_partials_passes"] == 1
        assert c["elements"]["phi_partials_passes"] == -(-T // window)


@pytest.mark.card
@pytest.mark.parametrize("mode", range(4))
def test_k7_windows_on_the_tenant_axis_on_the_card(card, mode):
    """Two tenants of one length whose partitions reach different rows,
    stacked in one launch: each tenant's Temp is its solo launch's, bit
    for bit, at every window height."""
    pair = [_tensor(card, seed=s, nnz=17000) for s in (3, 4)]
    enc = pair[0][0].meta.enc
    T = max(at.meta.temp_rows[mode] for at, _, _ in pair)
    stacked = [torch.stack([p[0].words for p in pair]),
               torch.stack([p[0].values for p in pair]),
               torch.stack([p[0].part_start for p in pair]),
               torch.stack([p[2][mode] for p in pair])]
    factors = [torch.stack([p[1][m] for p in pair]) for m in range(4)]
    for window in (3, T // 2, T):
        got = tk7.phi_partials_windowed(enc, mode, T, EPS, *stacked,
                                        factors=factors, window=window)
        for z, (at, fs, Bs) in enumerate(pair):
            solo = tk7.phi_partials_windowed(
                enc, mode, T, EPS, at.words, at.values, at.part_start,
                Bs[mode], factors=fs, window=T)
            assert torch.equal(got[z], solo), (mode, window, z)
