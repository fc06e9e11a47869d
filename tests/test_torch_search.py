"""Port parity: the budgeted plan search (`repro_torch.core.search`).

Against the JAX package (`repro.core.search`): the ridge cost model fit on
the same samples predicts the same times, the chunk ladders and the
neighbour order of the store records are equal, and `cp_als` /
`cp_apr` under ``tune="search"`` stay within 1e-4 in fit and 1e-5
relative in log-likelihood of the JAX package's static runs from the
same start. The port's own contracts mirror the JAX package's
`tests/test_search.py`: same seed and store give the same plan, the
budget matches the timing counter, a zero budget with a cold store is
the static plan and with a warm one a model-picked plan, repair lands in
the pool, the features are finite, the JSONL log, and a searched
streaming plan's CP-ALS / CP-APR equal its in-core twin's bit for bit.

Search behaviour is timed by a deterministic fake (`_fake_timer`, a pure
function of the candidate); the tensors live on the CPU, where a
``"cuda"`` backend runs the kernels' plain versions. CPU sums are
bit-repeatable with one thread only, so the bitwise tests use one.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import alto as jalto
from repro.core import cpals as jcpals
from repro.core import cpapr as jcpapr
from repro.core import plan as jplan
from repro.core import search as jsearch
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import autotune, heuristics, search
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import plan as tplan
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn
from repro_torch.sparse.tensor import SparseTensor as TSparse

RANK = 8
DIMS = (29, 13, 7)


@pytest.fixture
def store(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(autotune.PLAN_CACHE_ENV, str(path))
    monkeypatch.delenv(search.TUNE_LOG_ENV, raising=False)
    monkeypatch.delenv("REPRO_DEVICE_BYTES", raising=False)
    return path


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensor(seed=3, dims=DIMS, nnz=150, count_data=False):
    x = tsyn.uniform_tensor(dims, nnz, seed=seed, count_data=count_data)
    return talto.build_device(x, n_partitions=2, device="cpu")


def _fake_time(mp, streaming):
    t = 1e-3 * mp.r_block * (1.0 + math.log2(mp.block_m))
    t *= 128.0 / mp.threads
    if mp.traversal is heuristics.Traversal.ORIENTED_CARRY:
        t *= 0.5
    if streaming is not None:
        t *= 1.0 + 0.01 * streaming.n_chunks
    return t


def _fake_timer(monkeypatch, fn=_fake_time):
    """The search's timers replaced by a pure function of the candidate:
    deterministic fitness, no clock."""
    def fake_mttkrp(cand_plan, at, views, factors, mode):
        return fn(cand_plan.modes[mode], cand_plan.streaming), 1e-6

    def fake_phi(cand_plan, at, view, B, factors, pi, mode, eps=1e-10):
        return fn(cand_plan.modes[mode], cand_plan.streaming), 1e-6

    monkeypatch.setattr(search, "_time_mttkrp", fake_mttkrp)
    monkeypatch.setattr(search, "_time_phi", fake_phi)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_cost_model_matches_reference(seed, monkeypatch):
    """Fit on the same samples (of the JAX package's feature count), the
    two models predict the same times within 1e-12 relative."""
    rng = np.random.default_rng(seed)
    n = jsearch.N_FEATURES
    monkeypatch.setattr(search, "N_FEATURES", n)
    X = rng.standard_normal((40, n))
    X[:, 0] = 1.0
    X[:, 5] = 2.5                     # a constant column
    y = np.exp(rng.standard_normal(40) - 6.0)
    ours, ref = search.CostModel(), jsearch.CostModel()
    for i, (f, s) in enumerate(zip(X, y)):
        ours.add_sample(list(f), float(s))
        ref.add_sample(list(f), float(s))
        if i + 1 < search.MODEL_MIN_SAMPLES:
            assert not ours.fit() and not ref.fit()
    ours.add_sample([1.0] * (n - 1), 1.0)     # malformed: skipped by both
    ref.add_sample([1.0] * (n - 1), 1.0)
    assert ours.fit() and ref.fit()
    assert ours.n_samples == ref.n_samples == 40
    for f in rng.standard_normal((10, n)):
        a, b = ours.predict(list(f)), ref.predict(list(f))
        assert abs(a - b) <= 1e-12 * abs(b)


def _metas(seed=3, dims=DIMS, nnz=150):
    x = jsyn.uniform_tensor(dims, nnz, seed=seed)
    jat = jalto.build(x, n_partitions=2)
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=2, device="cpu")
    return jat, at


@pytest.mark.parametrize("align", [8, 64, 256])
@pytest.mark.parametrize("blocks", [2, 16, 200])
def test_chunk_ladder_matches_reference(align, blocks):
    jat, at = _metas(nnz=3000)
    budget = (tplan.streaming_resident_bytes(at.meta, RANK)
              + 2 * tplan.stream_elem_bytes(at.meta) * 8 * blocks)
    ours = search.chunk_ladder(at.meta, RANK, budget, align)
    assert ours == jsearch.chunk_ladder(jat.meta, RANK, budget, align)
    assert ours and ours[0] == tplan.choose_chunk_m(at.meta, RANK, budget,
                                                    align)
    assert all(c % align == 0 for c in ours)
    assert all(a > b for a, b in zip(ours, ours[1:]))


def test_store_neighbors_order_matches_reference():
    def rec(dims, nnz, rank, objective="mttkrp"):
        return {"dims": list(dims), "nnz": nnz, "rank": rank,
                "modes": [{}], "tuned": {"objective": objective}}
    jat, at = _metas()
    plans = {
        "near": rec((30, 12, 8), 160, RANK),
        "far": rec((4096, 2048, 1024), 100000, RANK),
        "mid": rec((60, 30, 9), 900, RANK),
        "other_rank": rec((29, 13, 7), 150, 32),
        "wrong_ndim": rec((30, 12), 160, RANK),
        "wrong_obj": rec((29, 13, 7), 150, RANK, "phi"),
        "no_modes": {"dims": [29, 13, 7], "nnz": 150, "modes": []},
    }
    for objective in ("mttkrp", "phi"):
        for limit in (1, 3, 10):
            ours = search.store_neighbors(plans, at.meta, RANK,
                                          objective=objective, limit=limit)
            ref = jsearch.store_neighbors(plans, jat.meta, RANK,
                                          objective=objective, limit=limit)
            assert [id(r) for r in ours] == [id(r) for r in ref]
    assert search.store_neighbors(plans, at.meta, RANK)[0] is plans["near"]


def _pair(count_data=False, seed=2):
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=seed,
                            count_data=count_data)
    jat = jalto.build(x, n_partitions=8)
    m = jat.meta
    at = interop.alto_tensor(
        np.asarray(jat.words), np.asarray(jat.values),
        np.asarray(jat.part_start), np.asarray(jat.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")
    return jat, at


def test_cp_als_tune_search_matches_reference_static(store, monkeypatch):
    _fake_timer(monkeypatch)
    jat, at = _pair()
    fs = [np.random.default_rng(7).random((I, 4)).astype(np.float32)
          for I in at.dims]
    got = tcpals.cp_als(at, 4, n_iters=5, tol=0.0, tune="search",
                        factors=interop.factors(fs, device="cpu"))
    assert got.plan != tplan.make_plan(at.meta, 4, backend="cuda")
    ref = jcpals.cp_als(jat, 4, n_iters=5, tol=0.0,
                        factors=[jnp.asarray(f) for f in fs],
                        plan=jplan.make_plan(jat.meta, 4, backend="pallas",
                                             interpret=True))
    np.testing.assert_allclose(got.fits, ref.fits, rtol=0, atol=1e-4)
    assert store.exists()


def test_cp_apr_tune_search_matches_reference_static(store, monkeypatch):
    _fake_timer(monkeypatch)
    jat, at = _pair(count_data=True)
    rng = np.random.default_rng(9)
    fs = [rng.random((I, 4)).astype(np.float32) + 0.1 for I in at.dims]
    lam = np.full(4, float(np.asarray(jat.values).sum()) / 4, np.float32)
    got = tcpapr.cp_apr(at, 4, tcpapr.CpaprParams(k_max=3, l_max=5),
                        track_ll=True, tune="search",
                        warm_start=(torch.from_numpy(lam),
                                    interop.factors(fs, "cpu")))
    plans = json.loads(store.read_text())["plans"]
    assert [r["tuned"]["objective"] for r in plans.values()] == ["phi"]
    ref = jcpapr.cp_apr(jat, 4, params=jcpapr.CpaprParams(k_max=3, l_max=5),
                        track_ll=True,
                        plan=jplan.make_plan(jat.meta, 4, backend="pallas",
                                             interpret=True),
                        warm_start=(jnp.asarray(lam),
                                    [jnp.asarray(f) for f in fs]))
    np.testing.assert_allclose(got.log_likelihoods, ref.log_likelihoods,
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Determinism and budgets
# ---------------------------------------------------------------------------

def test_same_seed_same_store_identical_plan(store, monkeypatch):
    _fake_timer(monkeypatch)
    at = _tensor()
    kw = dict(backend="cuda", budget_runs=10, seed=7, persist=False)
    p1, r1 = search.search_plan(at, RANK, **kw)
    p2, r2 = search.search_plan(at, RANK, **kw)
    assert p1 == p2
    assert r1.winners == r2.winners and r1.runs_used == r2.runs_used


def test_rerun_is_a_store_hit_with_zero_timing_runs(store):
    at = _tensor()
    plan, rep = search.search_plan(at, RANK, backend="cuda", budget_runs=4,
                                   seed=0)
    assert rep.runs_used <= 4 and rep.store == str(store)
    runs = tops.timing_runs()
    again = tplan.make_plan(at.meta, RANK, backend="cuda", tune="search",
                            at=at)
    assert tops.timing_runs() == runs
    assert again == plan


def test_budget_is_respected_and_matches_the_counter(store):
    at = _tensor()
    before = tops.timing_runs()
    _, rep = search.search_plan(at, RANK, backend="cuda", budget_runs=5,
                                seed=1, persist=False)
    assert 0 < rep.runs_used <= 5
    assert tops.timing_runs() - before == rep.runs_used


def test_seconds_budget_stops_the_search(store, monkeypatch):
    _fake_timer(monkeypatch)
    at = _tensor()
    _, rep = search.search_plan(at, RANK, backend="cuda", budget_s=0.0,
                                seed=0, persist=False)
    assert rep.runs_used == 0 and all(w.is_static for w in rep.winners)
    _, rep = search.search_plan(at, RANK, backend="cuda", budget_s=1e-12,
                                seed=0, persist=False)
    assert rep.runs_used == 1 and rep.generations == 1


def test_tie_breaks_keep_the_static_gene(store, monkeypatch):
    _fake_timer(monkeypatch, fn=lambda mp, s: 1e-3)
    at = _tensor()
    plan, rep = search.search_plan(at, RANK, backend="cuda", budget_runs=12,
                                   seed=3, persist=False)
    assert all(w.is_static for w in rep.winners)
    assert plan == tplan.make_plan(at.meta, RANK, backend="cuda")


@pytest.mark.parametrize("gain,wins", [(0.30, True), (0.03, False)])
def test_static_gene_kept_unless_beaten_beyond_the_noise(store, monkeypatch,
                                                         gain, wins):
    """Every gene but the static one `gain` faster: the search moves off
    the static gene only when that beats `autotune.MIN_GAIN`."""
    at = _tensor()
    static = [tplan.static_mode_plan(at.meta, n, RANK) for n in range(3)]
    _fake_timer(monkeypatch, fn=lambda mp, s: (
        1e-3 if mp == static[mp.mode] else 1e-3 * (1 - gain)))
    plan, rep = search.search_plan(at, RANK, backend="cuda", budget_runs=12,
                                   seed=3, persist=False)
    assert rep.runs_used > len(static)
    assert all(not w.is_static for w in rep.winners) == wins
    assert all(w.is_static for w in rep.winners) != wins
    if not wins:
        assert plan == tplan.make_plan(at.meta, RANK, backend="cuda")


@pytest.mark.parametrize("gain,smaller", [(0.30, True), (0.03, False)])
def test_chunk_ladder_keeps_its_first_rung_within_the_noise(
        store, one_thread, monkeypatch, gain, smaller):
    """Chunks below the byte model's `gain` faster: the streaming search
    leaves the ladder's first rung only when that beats
    `autotune.MIN_GAIN`."""
    at = _stream_tensor(seed=5)
    kw = dict(backend="cuda", budget_runs=40, seed=2, persist=False,
              device_bytes=(tplan.streaming_resident_bytes(at.meta, 4)
                            + 2 * tplan.stream_elem_bytes(at.meta)
                            * (2 * tplan.MIN_BLOCK_M)))
    _fake_timer(monkeypatch, fn=lambda mp, s: 1e-3)
    _, flat = search.search_plan(at, 4, **kw)
    first = max(flat.chunk_times)
    assert len(flat.chunk_times) >= 2 and flat.chunk_m == first
    _fake_timer(monkeypatch, fn=lambda mp, s: (
        1e-3 * (1 - gain) if s is not None and s.chunk_m < first else 1e-3))
    _, rep = search.search_plan(at, 4, **kw)
    assert max(rep.chunk_times) == first
    assert (rep.chunk_m < first) == smaller


def test_zero_budget_cold_store_returns_static(store, monkeypatch):
    _fake_timer(monkeypatch)
    at = _tensor()
    plan, rep = search.search_plan(at, RANK, backend="cuda", budget_runs=0,
                                   seed=0, persist=False)
    assert rep.runs_used == 0 and not rep.warm_start
    assert all(w.is_static for w in rep.winners)
    assert plan == tplan.make_plan(at.meta, RANK, backend="cuda")


def test_zero_budget_warm_model_transfers_across_tensors(store,
                                                         monkeypatch):
    _fake_timer(monkeypatch)
    search.search_plan(_tensor(), RANK, backend="cuda",
                       budget_runs=max(12, search.MODEL_MIN_SAMPLES), seed=0)
    b = _tensor(seed=9, dims=(31, 11, 6), nnz=200)
    runs = tops.timing_runs()
    plan, rep = search.search_plan(b, RANK, backend="cuda", budget_runs=0,
                                   seed=0)
    assert tops.timing_runs() == runs and rep.runs_used == 0
    assert rep.model_samples >= search.MODEL_MIN_SAMPLES
    assert rep.warm_start and rep.model_used and rep.neighbors >= 1
    for mp in plan.modes:
        assert mp in search.mode_pool(b.meta, mp.mode, RANK, backend="cuda")


def test_model_learns_only_from_its_device_kind(store, monkeypatch):
    _fake_timer(monkeypatch)
    search.search_plan(_tensor(), RANK, backend="cuda", budget_runs=12,
                       seed=0)
    plans = autotune.load_store()
    assert search.model_from_store(plans, "cpu").n_samples >= 12
    other = search.model_from_store(plans, "NVIDIA H100 80GB HBM3")
    assert other.n_samples == 0 and not other.ready


def test_exhaustive_runs_train_the_model_too(store):
    at = _tensor()
    autotune.tune_plan(at, RANK, backend="cuda", max_candidates=6)
    model = search.model_from_store(autotune.load_store(), "cpu")
    assert model.n_samples >= 6
    assert model.ready == (model.n_samples >= search.MODEL_MIN_SAMPLES)
    record = next(iter(autotune.load_store().values()))
    assert len(record["samples"]) <= search.MAX_RECORD_SAMPLES
    assert all(len(s["f"]) == search.N_FEATURES for s in record["samples"])


def test_record_samples_stay_capped(store, monkeypatch):
    _fake_timer(monkeypatch)
    at = _tensor()
    for seed in range(3):
        search.search_plan(at, RANK, backend="cuda", budget_runs=30,
                           seed=seed)
    (record,) = autotune.load_store().values()
    assert len(record["samples"]) == search.MAX_RECORD_SAMPLES


# ---------------------------------------------------------------------------
# Pools, repair, features
# ---------------------------------------------------------------------------

POOLS = {}


def _pool(streaming, objective="mttkrp"):
    key = (streaming, objective)
    if key not in POOLS:
        POOLS[key] = search.mode_pool(_tensor().meta, 0, RANK,
                                      backend="cuda", objective=objective,
                                      streaming=streaming)
    return POOLS[key]


@settings(max_examples=60, deadline=None)
@given(trav=st.sampled_from(list(heuristics.Traversal)),
       rb=st.integers(1, 256), bm=st.integers(1, 4096),
       th=st.one_of(st.none(), st.integers(1, 2048)),
       streaming=st.booleans(), objective=st.sampled_from(["mttkrp", "phi"]))
def test_any_mutation_repairs_into_the_pool(trav, rb, bm, th, streaming,
                                            objective):
    pool = _pool(streaming, objective)
    i = search.repair(pool, trav, rb, bm, th)
    g = pool[i]
    assert RANK % g.r_block == 0
    assert tplan.MIN_BLOCK_M <= g.block_m <= tplan.MAX_BLOCK_M
    assert g.block_m & (g.block_m - 1) == 0
    if streaming:
        assert g.traversal is heuristics.Traversal.ORIENTED_CARRY


def test_pool_members_snap_to_themselves():
    for streaming in (False, True):
        pool = _pool(streaming)
        for i, g in enumerate(pool):
            assert search.repair(pool, g.traversal, g.r_block, g.block_m,
                                 g.threads) == i


def test_pools_static_first_and_deduped():
    at = _tensor()
    static = tplan.static_mode_plan(at.meta, 0, RANK)
    assert _pool(False)[0] == static
    assert _pool(True)[0] == tplan.static_mode_plan(at.meta, 0, RANK,
                                                    force_carry=True)
    phi = _pool(False, "phi")
    keys = [(g.traversal, g.block_m, g.threads) for g in phi]
    assert len(keys) == len(set(keys)) < len(_pool(False))
    ref = search.mode_pool(at.meta, 0, RANK, backend="reference",
                           streaming=True)
    assert len(ref) == 1


@pytest.mark.parametrize("objective", ["mttkrp", "phi"])
def test_gene_features_shape_and_finiteness(objective):
    at = _tensor()
    for mode in range(3):
        for g in search.mode_pool(at.meta, mode, RANK, backend="cuda",
                                  objective=objective):
            for cm in (0, 128):
                f = search.gene_features(at.meta, RANK, mode, g.traversal,
                                         g.r_block, g.block_m, g.threads,
                                         chunk_m=cm, objective=objective)
                assert len(f) == search.N_FEATURES
                assert all(np.isfinite(f))


def test_gene_features_see_waves_and_slot_traffic():
    """K8 on a short chunk runs under one wave; the one-hot partials move
    more bytes than the carry at the same tiles."""
    meta = interop.alto_meta((22476, 22476, 23_776_223), 28_436_033, 1024,
                             (64, 64, 64), (1.0, 1.0, 1.0))
    carry, onehot = (heuristics.Traversal.ORIENTED_CARRY,
                     heuristics.Traversal.OUTPUT_ORIENTED)
    assert search.gene_waves(meta, 16, 2, carry, 16, 256, 128,
                             chunk_m=3_554_560) < 1.0
    assert search.gene_waves(meta, 16, 2, carry, 16, 32, 128,
                             chunk_m=3_554_560) > 1.0
    assert search.gene_bytes(meta, 16, 2, onehot, 16, 256) > \
        search.gene_bytes(meta, 16, 2, carry, 16, 256)
    assert search.gene_bytes(meta, 16, 2, carry, 4, 256) > \
        search.gene_bytes(meta, 16, 2, carry, 16, 256)


# ---------------------------------------------------------------------------
# The JSONL log
# ---------------------------------------------------------------------------

def test_log_disabled_without_env(store):
    logger = search.TuneLogger()
    assert not logger.enabled
    logger.write("measure", x=1)


def test_every_measurement_is_logged(store, tmp_path, monkeypatch):
    log = tmp_path / "tune.jsonl"
    monkeypatch.setenv(search.TUNE_LOG_ENV, str(log))
    _fake_timer(monkeypatch)
    _, rep = search.search_plan(_tensor(), RANK, backend="cuda",
                                budget_runs=6, seed=0)
    lines = [json.loads(ln) for ln in log.read_text().strip().splitlines()]
    assert lines[0]["event"] == "search_start"
    assert lines[-1]["event"] == "search_end"
    measures = [ln for ln in lines if ln["event"] == "measure"]
    assert len(measures) == rep.runs_used
    for m in measures:
        for field in ("generation", "mode", "traversal", "r_block",
                      "block_m", "threads", "measured_us", "iqr_us",
                      "budget_runs_used", "budget_seconds_used"):
            assert field in m, field
    spent = [m["budget_runs_used"] for m in measures]
    assert spent == sorted(spent) and spent[-1] == rep.runs_used
    assert len(lines[-1]["winners"]) == len(DIMS)


def test_predicted_vs_measured_once_model_is_warm(store, tmp_path,
                                                  monkeypatch):
    log = tmp_path / "tune.jsonl"
    monkeypatch.setenv(search.TUNE_LOG_ENV, str(log))
    _fake_timer(monkeypatch)
    search.search_plan(_tensor(), RANK, backend="cuda",
                       budget_runs=max(10, search.MODEL_MIN_SAMPLES), seed=0)
    search.search_plan(_tensor(seed=8), RANK, backend="cuda", budget_runs=4,
                       seed=0)
    measures = [json.loads(ln) for ln in log.read_text().splitlines()
                if json.loads(ln)["event"] == "measure"]
    assert any(m["predicted_us"] is not None for m in measures)


# ---------------------------------------------------------------------------
# Bits: tiles that change no sum, and streamed against in core
# ---------------------------------------------------------------------------

def _variants(meta, mode, rank, objective):
    """Pairs of candidates that differ only in r_block or threads."""
    cands = tplan.candidate_mode_plans(meta, mode, rank, objective=objective)
    groups = {}
    for c in cands:
        groups.setdefault((c.traversal, c.block_m), []).append(c)
    return [g for g in groups.values() if len(g) > 1]


def test_rank_tile_and_cta_variants_give_equal_mttkrp(one_thread):
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=2)
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=8, device="cpu")
    fs = autotune.seeded_factors(at.meta, 16, 0, "cpu")
    base = tplan.make_plan(at.meta, 16, backend="cuda")
    checked = 0
    for mode in range(3):
        for group in _variants(at.meta, mode, 16, "mttkrp"):
            outs = []
            for mp in group[:4]:
                modes = list(base.modes)
                modes[mode] = mp
                p = dataclasses.replace(base, modes=tuple(modes))
                outs.append(tplan.execute_mttkrp(
                    p, at, tplan.build_views(at, p), fs, mode))
            assert all(torch.equal(o, outs[0]) for o in outs[1:])
            checked += 1
    assert checked >= 6


@pytest.mark.parametrize("policy", ["pre", "otf"])
def test_cta_variants_give_equal_phi(one_thread, policy):
    x = jsyn.uniform_tensor((30, 4, 20), 900, seed=2, count_data=True)
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=8, device="cpu")
    rank = 5
    fs = [f.abs() + 0.1 for f in autotune.seeded_factors(at.meta, rank, 1,
                                                         "cpu")]
    base = tplan.make_plan(at.meta, rank, backend="cuda")
    checked = 0
    for mode in range(3):
        B = fs[mode] * 2.0
        for group in _variants(at.meta, mode, rank, "phi"):
            outs = []
            for mp in group[:4]:
                modes = list(base.modes)
                modes[mode] = mp
                p = dataclasses.replace(base, modes=tuple(modes))
                views = tplan.build_views(at, p)
                view = views.get(mode)
                if policy == "pre":
                    words = view.words if view is not None else at.words
                    kw = dict(pi=tops.pi_rows(at.meta.enc, words, fs,
                                               mode))
                else:
                    kw = dict(factors=fs)
                outs.append(tplan.execute_phi(p, at, view, B, mode, **kw))
            assert all(torch.equal(o, outs[0]) for o in outs[1:])
            checked += 1
    assert checked >= 3


def _stream_tensor(seed, count_data=True):
    """A duplicates-heavy mode 0 (the adversarial chunk layout)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 8, size=DIMS[0])
    counts[3] = 4 * tplan.MIN_BLOCK_M
    rows = np.repeat(np.arange(DIMS[0], dtype=np.int32), counts)
    coords = np.stack(
        [rows] + [rng.integers(0, I, size=rows.shape[0]).astype(np.int32)
                  for I in DIMS[1:]], axis=1)
    values = (rng.integers(1, 5, size=rows.shape[0]).astype(np.float32)
              if count_data else
              rng.standard_normal(rows.shape[0]).astype(np.float32))
    return talto.build_device(TSparse(DIMS, coords, values), n_partitions=2,
                              device="cpu")


def _searched_plan(at, objective="mttkrp", budget=6, rank=4):
    meta = at.meta
    device_bytes = (tplan.streaming_resident_bytes(meta, rank)
                    + 2 * tplan.stream_elem_bytes(meta)
                    * (2 * tplan.MIN_BLOCK_M))
    plan = tplan.make_plan(meta, rank, backend="cuda",
                           device_bytes=device_bytes, tune="search",
                           tune_objective=objective, at=at,
                           search_budget=budget)
    assert plan.streaming is not None and plan.streaming.n_chunks >= 2
    return plan


def test_search_returns_a_multi_chunk_streaming_plan(store, one_thread,
                                                     monkeypatch):
    _fake_timer(monkeypatch)
    at = _stream_tensor(seed=5)
    plan = _searched_plan(at)
    align = max(m.block_m for m in plan.modes)
    assert plan.streaming.chunk_m % align == 0
    assert plan.streaming.n_chunks == tplan.chunk_count(
        at.meta, plan.streaming.chunk_m)
    assert all(m.traversal is heuristics.Traversal.ORIENTED_CARRY
               for m in plan.modes)
    runs = tops.timing_runs()
    again = tplan.make_plan(at.meta, 4, backend="cuda", device="cpu",
                            device_bytes=plan.streaming.device_bytes,
                            tune="auto")
    assert tops.timing_runs() == runs and again == plan


def test_cp_als_bitwise_on_searched_streaming_plan(store, one_thread,
                                                   monkeypatch):
    _fake_timer(monkeypatch)
    at = _stream_tensor(seed=6, count_data=False)
    plan_s = _searched_plan(at)
    assert plan_s != tplan.make_plan(at.meta, 4, backend="cuda",
                                     device_bytes=plan_s.streaming
                                     .device_bytes)
    plan_i = dataclasses.replace(plan_s, streaming=None)
    rs = tcpals.cp_als(at, 4, n_iters=3, tol=0.0, plan=plan_s)
    ri = tcpals.cp_als(at, 4, n_iters=3, tol=0.0, plan=plan_i)
    assert rs.fits == ri.fits
    assert torch.equal(rs.lam, ri.lam)
    assert all(torch.equal(a, b) for a, b in zip(rs.factors, ri.factors))


def test_cp_apr_bitwise_on_searched_streaming_plan(store, one_thread,
                                                   monkeypatch):
    _fake_timer(monkeypatch)
    at = _stream_tensor(seed=7)
    plan_s = _searched_plan(at, objective="phi")
    plan_i = dataclasses.replace(plan_s, streaming=None)
    p = tcpapr.CpaprParams(k_max=2, l_max=3)
    rs = tcpapr.cp_apr(at, 4, p, plan=plan_s, track_ll=True)
    ri = tcpapr.cp_apr(at, 4, p, plan=plan_i, track_ll=True)
    assert rs.kkt_violations == ri.kkt_violations
    assert rs.log_likelihoods == ri.log_likelihoods
    assert all(torch.equal(a, b) for a, b in zip(rs.factors, ri.factors))


def test_streaming_search_determinism(store, monkeypatch):
    _fake_timer(monkeypatch)
    at = _stream_tensor(seed=8)
    device_bytes = (tplan.streaming_resident_bytes(at.meta, 4)
                    + 2 * tplan.stream_elem_bytes(at.meta) * 16)
    kw = dict(backend="cuda", device_bytes=device_bytes, budget_runs=40,
              seed=11, persist=False)
    p1, r1 = search.search_plan(at, 4, **kw)
    p2, r2 = search.search_plan(at, 4, **kw)
    assert p1 == p2 and r1.chunk_m == r2.chunk_m == p1.streaming.chunk_m
    assert r1.chunk_candidates >= 1 and r1.chunk_times


def test_drivers_accept_tune_search(store, monkeypatch):
    _fake_timer(monkeypatch)
    res = tcpals.cp_als(_tensor(seed=4, nnz=80), 4, n_iters=2, tune="search")
    assert res.plan is not None and len(res.fits) >= 1
