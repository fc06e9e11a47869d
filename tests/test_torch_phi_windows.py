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


# Temp rows of FROSTT Enron's mode 0 at rank 16: taller than one window of
# the H100's 227 KB a CTA (`H100_SMEM`), so K7 widens its CTA there.
ENRON_T = 5983
H100_SMEM = 232448
CHICAGO_T = 127


def _threads(kind: str, limit: int) -> int:
    """K7's CTA: the plan's 128 threads (``"plan"``), or the wide CTA
    `common.k7_launch` picks for Enron's mode 0 under ``limit`` bytes
    (``"wide"``)."""
    if kind == "plan":
        return 128
    threads, tile, _ = common.k7_launch(ENRON_T, 16, limit, 128)
    assert threads > 128 and tile == common.k7_tile(16, threads)
    return threads


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


@pytest.mark.parametrize("R", [5, 8, 16])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_k7_launch_keeps_the_plan_where_the_sm_is_full(R, threads):
    """Chicago's mode 0: a window of 127 rows leaves an SM 16 warps or
    more at the plan's CTA, which K7 keeps, with today's tile and
    window."""
    assert common.k7_launch(CHICAGO_T, R, H100_SMEM, threads) == (
        threads, common.tile_nnz(R), CHICAGO_T)


@pytest.mark.parametrize("T, launch", [
    (ENRON_T, (512, 512, 1544)), (5426, (512, 512, 1544)),
    (5590, (512, 512, 1544)), (1144, (512, 512, 1144)),
    (600, (256, 256, 600))])
def test_k7_launch_widens_a_cta_short_of_warps(T, launch):
    """Enron's Temps: at the plan's 128 threads the window leaves one CTA
    of 4 warps an SM (a Temp of 600 rows: two CTAs, 8 warps); the wide
    CTA gives the SM 16 warps, a tile of whole rounds of its sub-warps' U
    nonzeros, and a window that fits the CTA's shared memory."""
    plan_window = common.window_rows(T, 16, H100_SMEM, True)
    assert common.ctas_per_sm(
        common.smem_bytes(plan_window, 16, common.tile_nnz(16), True),
        H100_SMEM) * 4 < common.K7_SM_WARPS
    assert common.k7_launch(T, 16, H100_SMEM, 128) == launch
    threads, tile, window = launch
    # Rank 16's lane map (phi_dispatch, phi_unroll): sub-warps of 4 lanes,
    # 2 nonzeros each in flight.
    assert tile % (threads // 4 * 2) == 0
    assert tile == common.k7_tile(16, threads)
    smem = common.smem_bytes(window, 16, tile, True)
    assert smem <= H100_SMEM
    assert window == common.window_rows(T, 16, H100_SMEM, True, tile)
    assert common.ctas_per_sm(smem, H100_SMEM) * threads // 32 \
        >= common.K7_SM_WARPS


@pytest.mark.parametrize("max_threads, launch", [
    (1024, (512, 512, 1544)), (512, (512, 512, 1544)),
    (384, (256, 256, 1680)), (128, (128, 128, 1748))])
def test_k7_launch_stays_within_the_kernels_threads(max_threads, launch):
    """A kernel whose registers allow fewer threads a CTA (ranks above
    512 at the H100's 64 K registers an SM) widens only as far as
    ``max_threads``: to the most warps an SM within it."""
    assert common.k7_launch(ENRON_T, 16, H100_SMEM, 128,
                            max_threads) == launch


@pytest.mark.parametrize("limit", [H100_SMEM, 166912, 101376, 49152])
@pytest.mark.parametrize("T", [1, 127, 1144, ENRON_T, 100000])
def test_k7_launch_keeps_the_reach_check_at_every_rank(limit, T):
    """The launcher's check that the staging tile holds the reach
    reduction, an int a warp (``tile·(R+1) ≥ threads/32``), holds for
    every launch the rule picks, at ranks 1..1024; and the shape fits."""
    for R in range(1, 1025):
        try:
            common.window_rows(T, R, limit, True)
        except ValueError:
            with pytest.raises(ValueError):
                common.k7_launch(T, R, limit, 128)
            continue
        threads, tile, window = common.k7_launch(T, R, limit, 128)
        assert tile * (R + 1) >= threads // 32, (R, threads, tile)
        assert 1 <= window <= T
        assert common.smem_bytes(window, R, tile, True) <= limit
        assert (threads, tile) == (128, common.tile_nnz(R)) or (
            threads in common.K7_WIDE_THREADS
            and tile == common.k7_tile(R, threads))


@pytest.mark.parametrize("R, threads, tile", [
    (16, 64, 128), (16, 128, 128), (16, 256, 256), (16, 512, 512),
    (16, 1024, 1024), (5, 512, 512), (40, 512, 384), (128, 1024, 256),
    (1024, 100, 8), (1024, 1024, 64), (3, 2000, 1024)])
def test_k7_tile_scales_with_the_cta(R, threads, tile):
    """A CTA of ``threads`` (whole warps, at most 1,024) stages
    `common.tile_nnz` nonzeros for each 128 threads, at least one such
    tile."""
    assert common.k7_tile(R, threads) == tile


class _FakeK7:
    """Stands in for the built ``cpapr_phi`` library: records the launch
    shape each ``alto_phi_partials`` call gets."""

    def __init__(self):
        self.shapes = []

    def alto_phi_partials(self, *args):
        window, tile, threads = args[18:21]
        self.shapes.append((threads, tile, window))
        return 0


@pytest.mark.parametrize("limit, wide", [(H100_SMEM, False), (40960, True)])
def test_phi_partials_wide_counts_the_widened_launches(monkeypatch, limit,
                                                       wide):
    """The wrapper's launch path with a stand-in library: K7 takes
    `common.k7_launch`'s shape, and ``phi_partials_wide`` counts each
    launch in a CTA wider than the plan's, its threads as elements: none
    where the Temps leave the SM full (Chicago's case, the H100's 227 KB),
    every launch where a window fills the CTA's shared memory (Enron's)."""
    at, fs, Bs = _tensor("cpu")
    fake = _FakeK7()
    monkeypatch.setattr(common, "on_cuda", lambda *t: True)
    monkeypatch.setattr(common, "smem_limit", lambda dev: limit)
    monkeypatch.setattr(common, "k7_max_threads", lambda R, dev: 1024)
    monkeypatch.setattr(common, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_build, "library", lambda name: fake)
    _build.reset_counts()
    for mode in range(4):
        tk7.phi_partials(at.meta.enc, mode, at.meta.temp_rows[mode], EPS,
                         at.words, at.values, at.part_start, Bs[mode],
                         factors=fs, threads=128)
    want = [common.k7_launch(T, 16, limit, 128) for T in at.meta.temp_rows]
    assert fake.shapes == want
    c = _build.counts()
    assert c["launches"]["phi_partials"] == 4
    n_wide = 4 if wide else 0
    assert all((t > 128) == wide for t, _, _ in fake.shapes)
    assert c["launches"]["phi_partials_wide"] == n_wide
    assert c["elements"]["phi_partials_wide"] == sum(
        t for t, _, _ in fake.shapes if t > 128)


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
@pytest.mark.parametrize("shape", ["plan", "wide"])
@pytest.mark.parametrize("mode", range(4))
@pytest.mark.parametrize("policy", ["otf", "pre"])
def test_k7_windows_equal_one_window_on_the_card(card, mode, policy, shape):
    """K7 in one window of the plan's CTA against every window height in
    the CTA of ``shape`` (`_threads`): the same bits."""
    at, fs, Bs = _tensor(card)
    T = at.meta.temp_rows[mode]
    operands = (dict(factors=fs) if policy == "otf"
                else dict(pi=ops.pi_rows(at.meta.enc, at.words, fs, mode)))

    def k7(window, threads):
        return tk7.phi_partials_windowed(
            at.meta.enc, mode, T, EPS, at.words, at.values, at.part_start,
            Bs[mode], threads=threads, window=window, **operands)
    whole = k7(T, _threads("plan", 0))
    threads = _threads(shape, common.smem_limit(card))
    for window in (1, 3, 7, T // 2, T - 1, T):
        got = k7(window, threads)
        assert torch.equal(got, whole), (mode, policy, window, threads)
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
@pytest.mark.parametrize("shape", ["plan", "wide"])
@pytest.mark.parametrize("mode", range(4))
def test_k7_windows_on_the_tenant_axis_on_the_card(card, mode, shape):
    """Two tenants of one length whose partitions reach different rows,
    stacked in one launch in the CTA of ``shape``: each tenant's Temp is
    its solo launch's in one window of the plan's CTA, bit for bit, at
    every window height."""
    pair = [_tensor(card, seed=s, nnz=17000) for s in (3, 4)]
    enc = pair[0][0].meta.enc
    T = max(at.meta.temp_rows[mode] for at, _, _ in pair)
    stacked = [torch.stack([p[0].words for p in pair]),
               torch.stack([p[0].values for p in pair]),
               torch.stack([p[0].part_start for p in pair]),
               torch.stack([p[2][mode] for p in pair])]
    factors = [torch.stack([p[1][m] for p in pair]) for m in range(4)]
    solo = [tk7.phi_partials_windowed(
        enc, mode, T, EPS, at.words, at.values, at.part_start, Bs[mode],
        factors=fs, window=T) for at, fs, Bs in pair]
    threads = _threads(shape, common.smem_limit(card))
    for window in (3, T // 2, T):
        got = tk7.phi_partials_windowed(enc, mode, T, EPS, *stacked,
                                        factors=factors, threads=threads,
                                        window=window)
        for z in range(len(pair)):
            assert torch.equal(got[z], solo[z]), (mode, window, z, threads)
