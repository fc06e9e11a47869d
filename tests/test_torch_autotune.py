"""Port parity: the measured plan autotuner and its store
(`repro_torch.core.autotune`, `plan.candidate_mode_plans`,
`heuristics.candidate_traversals`, `make_plan(tune=...)`).

Against the JAX package: the traversal candidates and the meta
fingerprint of the same seeded tensor. The port's own contracts mirror
the JAX package's `tests/test_autotune.py`: the static choice first and
kept under any cap, every candidate feasible (the recursive kernels'
Temp in one shared-memory window of `plan.SMEM_BYTES`), the Φ and
reference-backend dedupes, store round trips with zero timing runs, and
corrupt, other-version and malformed stores as misses that are never
overwritten before the next tuning. Every store is a ``tmp_path`` file
named by ``$REPRO_TORCH_PLAN_CACHE``; the tensors live on the CPU, where
a ``"cuda"`` backend runs the kernels' plain versions.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import autotune as jautotune
from repro.core import heuristics as jheur
from repro.sparse import synthetic as jsyn
from repro_torch.core import alto as talto
from repro_torch.core import autotune, heuristics
from repro_torch.core import cpals as tcpals
from repro_torch.core import cpapr as tcpapr
from repro_torch.core import plan as tplan
from repro_torch.kernels import common
from repro_torch.kernels import ops as tops
from repro_torch.sparse import synthetic as tsyn
from repro_torch.sparse.tensor import SparseTensor as TSparse
from test_torch_plan import TENSORS, _both

RANK = 6


@pytest.fixture
def store(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(autotune.PLAN_CACHE_ENV, str(path))
    monkeypatch.delenv("REPRO_DEVICE_BYTES", raising=False)
    return path


def _tensor(seed=3, dims=(13, 7, 5), nnz=97):
    x = tsyn.uniform_tensor(dims, nnz, seed=seed)
    return talto.build_device(x, n_partitions=4, device="cpu")


def _tune(at, rank=RANK, **kw):
    kw.setdefault("backend", "cuda")
    kw.setdefault("max_candidates", 5)
    return autotune.tune_plan(at, rank, **kw)


def _make(at, rank=RANK, **kw):
    return tplan.make_plan(at.meta, rank, backend="cuda", device="cpu", **kw)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", TENSORS, ids=lambda c: c[0] + str(
    c[1]["dims"]))
def test_candidate_traversals_match_reference(case):
    jat, at = _both(*case)
    for mode in range(len(at.dims)):
        ours = heuristics.candidate_traversals(at.meta, mode)
        ref = jheur.candidate_traversals(jat.meta, mode)
        assert [t.value for t in ours] == [t.value for t in ref]
        assert ours[0] is heuristics.choose_traversal(at.meta, mode)


@pytest.mark.parametrize("case", TENSORS, ids=lambda c: c[0] + str(
    c[1]["dims"]))
def test_meta_fingerprint_matches_reference(case):
    jat, at = _both(*case)
    assert autotune.meta_fingerprint(at.meta) == \
        jautotune.meta_fingerprint(jat.meta)


def test_fingerprint_and_key_track_what_was_measured(monkeypatch):
    at = _tensor()
    other = dataclasses.replace(at.meta, nnz=at.meta.nnz + 1)
    assert autotune.meta_fingerprint(other) != \
        autotune.meta_fingerprint(at.meta)
    base = autotune.plan_key(at.meta, 4, "cuda", device="cpu")
    assert base == autotune.plan_key(at.meta, 4, "cuda", device="cpu")
    changed = [autotune.plan_key(other, 4, "cuda", device="cpu"),
               autotune.plan_key(at.meta, 8, "cuda", device="cpu"),
               autotune.plan_key(at.meta, 4, "reference", device="cpu"),
               autotune.plan_key(at.meta, 4, "cuda", device="cpu",
                                 objective="phi"),
               autotune.plan_key(at.meta, 4, "cuda", device="cpu",
                                 device_bytes=1 << 20)]
    for module, name in ((tplan, "SMEM_BYTES"),
                         (heuristics, "DEFAULT_FAST_MEM_BYTES")):
        with monkeypatch.context() as m:
            m.setattr(module, name, 1)
            changed.append(autotune.plan_key(at.meta, 4, "cuda",
                                             device="cpu"))
    for key in changed:
        assert key != base
    assert autotune.device_kind("cpu") == "cpu"


# ---------------------------------------------------------------------------
# The candidate space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["mttkrp", "phi"])
@pytest.mark.parametrize("case", TENSORS, ids=lambda c: c[0] + str(
    c[1]["dims"]))
def test_static_first_and_every_candidate_feasible(case, objective):
    _, at = _both(*case)
    meta = at.meta
    for rank in (5, 16):
        for mode in range(len(meta.dims)):
            cands = tplan.candidate_mode_plans(meta, mode, rank,
                                               objective=objective)
            assert cands[0] == tplan.static_mode_plan(meta, mode, rank)
            assert len(set(cands)) == len(cands)
            for c in cands[1:]:     # the static choice may not fit
                assert rank % c.r_block == 0
                assert c.r_block <= tplan.MAX_R_BLOCK
                assert c.block_m & (c.block_m - 1) == 0
                assert tplan.MIN_BLOCK_M <= c.block_m <= tplan.MAX_BLOCK_M
                if c.traversal is heuristics.Traversal.RECURSIVE:
                    phi = objective == "phi"
                    T = meta.temp_rows[mode]
                    assert common.window_rows(
                        T, rank if phi else c.r_block, tplan.SMEM_BYTES,
                        phi) == T
                    assert c.threads in tplan.RECURSIVE_THREADS
                    assert c.block_m == cands[0].block_m
                else:
                    assert c.threads == tplan.cta_threads(c.r_block)
            got = {c.traversal for c in cands}
            assert {heuristics.Traversal.OUTPUT_ORIENTED,
                    heuristics.Traversal.ORIENTED_CARRY} <= got


def test_candidate_order_and_cap():
    """The whole list: static first, then traversal, ``r_block`` and
    ``block_m`` descending. A capped list: static first, then the
    families in turn, each a prefix of its own order."""
    at = _tensor()
    static = tplan.static_mode_plan(at.meta, 0, 16)
    full = tplan.candidate_mode_plans(at.meta, 0, 16)
    order = heuristics.candidate_traversals(at.meta, 0)
    rest = [c for c in full[1:]]
    ranks = [order.index(c.traversal) for c in rest]
    assert ranks == sorted(ranks)
    oriented = [c for c in rest if c.traversal is order[0]]
    keys = [(-c.r_block, -c.block_m) for c in oriented]
    assert keys == sorted(keys)
    families = {t: [c for c in rest if c.traversal is t] for t in order}
    for cap in (1, 2, 3, 24, 1000):
        cands = tplan.candidate_mode_plans(at.meta, 0, 16,
                                           max_candidates=cap)
        assert cands[0] == static
        assert len(cands) == min(cap, len(full))
        assert set(cands) <= set(full)
        counts = []
        for t, fam in families.items():
            got = [c for c in cands[1:] if c.traversal is t]
            assert got == fam[:len(got)]
            counts.append((len(got), len(fam)))
        # The families in turn: none falls two behind one that is not
        # yet exhausted.
        for n_a, all_a in counts:
            for n_b, _ in counts:
                assert n_a == all_a or n_a >= n_b - 1
    assert tplan.candidate_mode_plans(at.meta, 0, 16,
                                      max_candidates=1000) == full
    assert tplan.cap_candidates(full, None) == full


def _main_path_metas():
    """Metas of the two published shapes `chip_smoke.py` tunes (dims,
    nonzeros, 1024 partitions and the fiber reuse of its build; the Temp
    heights are representative: a short mode-0 Temp on Chicago, tall
    ones on DARPA)."""
    from repro_torch import interop
    chicago = interop.alto_meta(
        (6186, 24, 77, 32), 4_855_249, 1024, (127, 24, 77, 32),
        (91.057, 2.800, 3.426, 2.869))
    darpa = interop.alto_meta(
        (22476, 22476, 23776223), 28_436_033, 1024,
        (11_000, 11_000, 40_000), (1.00003, 1.00003, 1.0284))
    return {"chicago": chicago, "darpa": darpa}


@pytest.mark.parametrize("objective", ["mttkrp", "phi"])
@pytest.mark.parametrize("shape", ["chicago", "darpa"])
def test_default_cap_keeps_every_family_on_the_main_path(shape, objective):
    """At rank 16 the tuner's default list (deduped, then capped) of each
    mode of the main path's shapes holds the carry kernels at ``block_m``
    other than the static one, and every traversal family the space
    has."""
    meta = _main_path_metas()[shape]
    for mode in range(len(meta.dims)):
        full = autotune.dedupe(tplan.candidate_mode_plans(
            meta, mode, 16, objective=objective), "cuda", objective)
        cands = tplan.cap_candidates(full, autotune.DEFAULT_MAX_CANDIDATES)
        assert cands[0] == tplan.static_mode_plan(meta, mode, 16)
        assert len(cands) == min(len(full), autotune.DEFAULT_MAX_CANDIDATES)
        assert {c.traversal for c in cands} == {c.traversal for c in full}
        static_bm = cands[0].block_m
        carry = {c.block_m for c in cands
                 if c.traversal is heuristics.Traversal.ORIENTED_CARRY
                 and c.r_block == 16}
        assert carry - {static_bm}, (mode, sorted(carry))


def test_recursive_window_rule_bounds_the_space():
    """A Temp taller than one window of the shared memory has no recursive
    candidate; the static recursive choice stays first all the same."""
    from repro_torch import interop
    tall = interop.alto_meta((300_000, 24, 77), 400_000, 4,
                             (200_000, 24, 77), (9.0, 1.0, 1.0))
    cands = tplan.candidate_mode_plans(tall, 0, 16)
    assert cands[0].traversal is heuristics.Traversal.RECURSIVE
    assert all(c.traversal is not heuristics.Traversal.RECURSIVE
               for c in cands[1:])
    assert not tplan.recursive_fits(tall, 0, 16, 16)
    short = interop.alto_meta((500, 24, 77), 40_000, 4, (127, 24, 77),
                              (9.0, 1.0, 1.0))
    assert tplan.recursive_fits(short, 0, 16, 16)
    assert tplan.recursive_fits(short, 0, 16, 16, objective="phi")
    rec = [c for c in tplan.candidate_mode_plans(short, 0, 16)
           if c.traversal is heuristics.Traversal.RECURSIVE]
    assert [(c.r_block, c.threads) for c in rec[:4]] == [
        (16, 128), (16, 64), (16, 256), (8, 128)]


# ---------------------------------------------------------------------------
# The tuner end to end
# ---------------------------------------------------------------------------

def test_winner_is_a_candidate_and_never_slower_than_static(store):
    at = _tensor()
    plan, report = _tune(at)
    assert store.exists()
    for mp, mr in zip(plan.modes, report.modes):
        assert mr.candidates[0].is_static
        assert sum(c.is_static for c in mr.candidates) == 1
        assert mr.best.median_s <= mr.static.median_s
        assert mp in tplan.candidate_mode_plans(at.meta, mp.mode, RANK)
    fs = autotune.seeded_factors(at.meta, RANK, 0, "cpu")
    views = tplan.build_views(at, plan)
    ref = tplan.make_plan(at.meta, RANK, backend="reference", device="cpu")
    ref_views = tplan.build_views(at, ref)
    for mode in range(3):
        got = tplan.execute_mttkrp(plan, at, views, fs, mode)
        want = tplan.execute_mttkrp(ref, at, ref_views, fs, mode)
        scale = float(want.abs().max()) + 1e-9
        assert float((got - want).abs().max()) / scale < 1e-5


def test_phi_objective_dedupes_on_traversal_block_and_cta(store):
    at = _tensor(dims=(19, 23, 11), nnz=300)
    _, report = _tune(at, rank=4, objective="phi", max_candidates=60)
    for mr in report.modes:
        keys = [(c.traversal, c.block_m, common.cta_threads(c.threads))
                for c in mr.candidates]
        assert len(keys) == len(set(keys))
        assert mr.candidates[0].is_static


def test_reference_backend_collapses_to_one_per_family(store):
    at = _tensor(dims=(19, 23, 11), nnz=300)
    _, report = _tune(at, backend="reference", max_candidates=200)
    for mr in report.modes:
        fams = ["oriented" if c.traversal != "recursive" else "recursive"
                for c in mr.candidates]
        assert len(fams) == len(set(fams)) <= 2


def test_force_roundtrip_zero_timing_runs(store):
    at = _tensor()
    plan, _ = _tune(at)
    runs = tops.timing_runs()
    again = _make(at, tune="force")
    assert tops.timing_runs() == runs
    assert again == plan and hash(again) == hash(plan)
    assert _make(at, tune="auto") == plan


def test_force_miss_raises_auto_miss_falls_back(store):
    at = _tensor(seed=11)
    with pytest.raises(ValueError, match="force"):
        _make(at, tune="force")
    runs = tops.timing_runs()
    assert _make(at, tune="auto") == _make(at)
    assert _make(at, tune="off") == _make(at)
    assert tops.timing_runs() == runs
    assert not store.exists()
    with pytest.raises(ValueError, match="tune mode"):
        _make(at, tune="always")


def test_off_is_exactly_the_static_plan(store):
    at = _tensor()
    _tune(at)
    static = tplan.make_plan(at.meta, RANK, backend="cuda", device="cpu")
    assert _make(at, tune="off") == static
    assert tplan.plan_for(at, RANK, backend="cuda") == static


def test_drivers_accept_tune(store, monkeypatch):
    monkeypatch.setattr(autotune, "DEFAULT_MAX_CANDIDATES", 4)
    at = _tensor(dims=(12, 10, 8), nnz=120)
    res = tcpals.cp_als(at, RANK, n_iters=2, seed=1, tune="auto")
    assert res.plan is not None and store.exists()
    runs = tops.timing_runs()
    res2 = tcpals.cp_als(at, RANK, n_iters=2, seed=1, tune="force")
    assert tops.timing_runs() == runs
    assert res2.plan == res.plan and res2.fits == res.fits


def test_cpals_and_cpapr_tune_under_distinct_keys(store, monkeypatch):
    monkeypatch.setattr(autotune, "DEFAULT_MAX_CANDIDATES", 3)
    x = tsyn.uniform_tensor((12, 10, 8), 150, seed=5, count_data=True)
    at = talto.build_device(x, n_partitions=2, device="cpu")
    tcpals.cp_als(at, 4, n_iters=1, tune="auto")
    tcpapr.cp_apr(at, 4, tcpapr.CpaprParams(k_max=1), tune="auto")
    plans = json.loads(store.read_text())["plans"]
    assert len(plans) == 2
    assert {r["tuned"]["objective"] for r in plans.values()} == \
        {"mttkrp", "phi"}
    assert {r["tuned"]["device"] for r in plans.values()} == {"cpu"}


# ---------------------------------------------------------------------------
# Store robustness
# ---------------------------------------------------------------------------

def test_corrupt_store_is_a_miss_and_retuning_replaces_it(store):
    store.write_text("{this is not json")
    raw = store.read_bytes()
    at = _tensor()
    assert autotune.load_store() == {}
    assert autotune.lookup(at.meta, RANK, backend="cuda",
                           device="cpu") is None
    assert _make(at, tune="auto") == _make(at)
    assert store.read_bytes() == raw          # a miss never writes
    plan, _ = _tune(at)
    assert json.loads(store.read_text())["version"] == \
        autotune.PLAN_STORE_VERSION
    assert _make(at, tune="force") == plan


@pytest.mark.parametrize("version", [0, autotune.PLAN_STORE_VERSION + 1])
def test_other_version_store_loads_empty_without_clobber(store, version):
    at = _tensor()
    _tune(at)
    payload = json.loads(store.read_text())
    payload["version"] = version
    store.write_text(json.dumps(payload))
    raw = store.read_bytes()
    assert autotune.load_store() == {}
    assert autotune.lookup(at.meta, RANK, backend="cuda",
                           device="cpu") is None
    runs = tops.timing_runs()
    assert _make(at, tune="auto") == _make(at)
    assert tops.timing_runs() == runs
    assert store.read_bytes() == raw
    _tune(at)
    fresh = json.loads(store.read_text())
    assert fresh["version"] == autotune.PLAN_STORE_VERSION and fresh["plans"]


@pytest.mark.parametrize("field,value", [
    ("r_block", 5), ("block_m", 12), ("threads", 0), ("threads", 96),
    ("traversal", "diagonal"), ("mode", 7)])
def test_malformed_entry_is_a_miss(store, field, value):
    at = _tensor()
    _tune(at)
    payload = json.loads(store.read_text())
    key = next(iter(payload["plans"]))
    payload["plans"][key]["modes"][0][field] = value
    store.write_text(json.dumps(payload))
    assert autotune.lookup(at.meta, RANK, backend="cuda",
                           device="cpu") is None
    assert _make(at, tune="auto") == _make(at)


def test_stored_threads_must_be_in_the_candidate_space():
    """An oriented gene runs at `plan.cta_threads` of its tile; a
    recursive one at that or one of `plan.RECURSIVE_THREADS`."""
    at = _tensor()
    plan = tplan.make_plan(at.meta, RANK, backend="cuda")
    record = autotune.serialize_plan(plan)
    orient = heuristics.Traversal.ORIENTED_CARRY.value
    recur = heuristics.Traversal.RECURSIVE.value
    for traversal, threads, ok in ((orient, tplan.cta_threads(RANK), True),
                                   (orient, 64, False),
                                   (orient, 256, False),
                                   (recur, 64, True), (recur, 256, True),
                                   (recur, tplan.cta_threads(RANK), True),
                                   (recur, 512, False)):
        rec = json.loads(json.dumps(record))
        rec["modes"][0].update(traversal=traversal, r_block=RANK,
                               threads=threads)
        if ok:
            assert autotune.deserialize_plan(rec, at.meta).modes[0] \
                .threads == threads
        else:
            with pytest.raises(ValueError, match="threads"):
                autotune.deserialize_plan(rec, at.meta)


def _fake_tuner_timer(monkeypatch, times):
    """`autotune._time_mttkrp` replaced by a table: (traversal, block_m)
    -> (median, IQR) seconds, 1 ms and no spread elsewhere."""
    def fake(cand_plan, at, views, factors, mode):
        mp = cand_plan.modes[mode]
        return times.get((mp.traversal, mp.block_m), (1e-3, 0.0))
    monkeypatch.setattr(autotune, "_time_mttkrp", fake)


@pytest.mark.parametrize("gain,iqr,wins", [
    (0.30, 0.0, True), (0.30, 0.5e-3, False), (0.03, 0.0, False),
    (0.0, 0.0, False)])
def test_static_gene_kept_unless_beaten_beyond_the_noise(store, monkeypatch,
                                                         gain, iqr, wins):
    """The fastest candidate replaces the static gene only when it is
    `MIN_GAIN` faster and faster by more than either IQR."""
    at = _tensor()
    static = tplan.static_mode_plan(at.meta, 0, RANK)
    rival = next(c for c in tplan.candidate_mode_plans(at.meta, 0, RANK)
                 if (c.traversal, c.block_m)
                 != (static.traversal, static.block_m))
    _fake_tuner_timer(monkeypatch, {
        (static.traversal, static.block_m): (1e-3, 0.0),
        (rival.traversal, rival.block_m): (1e-3 * (1 - gain) - 1e-9, iqr)})
    plan, report = autotune.tune_plan(at, RANK, backend="cuda")
    mr = report.modes[0]
    assert mr.seconds >= 0.0
    assert mr.fastest.median_s <= mr.static.median_s
    assert mr.best.median_s <= mr.static.median_s
    if wins:
        assert (plan.modes[0].traversal, plan.modes[0].block_m) == \
            (rival.traversal, rival.block_m)
        assert not mr.best.is_static
    else:
        assert plan.modes[0] == static and mr.best.is_static
    assert autotune.beats(0.5, 0.0, 1.0, 0.0)
    assert not autotune.beats(0.99, 0.0, 1.0, 0.0)
    assert not autotune.beats(0.5, 0.0, 1.0, 0.6)


def test_store_path_env_override_and_evict(tmp_path, monkeypatch):
    override = tmp_path / "elsewhere" / "cache.json"
    monkeypatch.setenv(autotune.PLAN_CACHE_ENV, str(override))
    assert autotune.store_path() == override
    _, report = _tune(_tensor())
    assert override.exists() and report.store == str(override)
    assert autotune.evict(report.key) and not autotune.evict(report.key)
    assert autotune.load_store() == {}
    monkeypatch.delenv(autotune.PLAN_CACHE_ENV)
    assert autotune.store_path() == \
        autotune.store_path(autotune.DEFAULT_STORE)


def test_streaming_record_roundtrips(store):
    from repro_torch.core import search
    at = _tensor()
    plan, _ = search.search_plan(at, RANK, backend="cuda", device_bytes=1,
                                 budget_runs=2, seed=0)
    assert plan.streaming is not None
    hit = autotune.lookup(at.meta, RANK, backend="cuda", device="cpu",
                          device_bytes=1)
    assert hit == plan
    assert autotune.lookup(at.meta, RANK, backend="cuda",
                           device="cpu") is None


@pytest.mark.parametrize("seed", range(4))
def test_serialization_roundtrip(seed):
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in rng.integers(2, 40, size=3))
    x = tsyn.uniform_tensor(dims, int(rng.integers(1, 300)), seed=seed)
    at = talto.build_device(x, n_partitions=2, device="cpu")
    rank = int(rng.choice([1, 2, 4, 6, 12]))
    for budget in (None, 1):
        plan = tplan.make_plan(at.meta, rank, backend="cuda",
                               device_bytes=budget)
        record = json.loads(json.dumps(autotune.serialize_plan(plan)))
        back = autotune.deserialize_plan(record, at.meta)
        assert back == plan and hash(back) == hash(plan)


def test_tuned_plans_give_the_static_plans_bits_at_equal_tiles(store):
    """A tuned plan is a plan: CP-ALS under it equals CP-ALS under the
    static plan with the same tiles bit for bit (one CPU thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = jsyn.uniform_tensor((13, 7, 5), 97, seed=3)
        at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                                n_partitions=4, device="cpu")
        plan, _ = _tune(at, max_candidates=8)
        again = dataclasses.replace(tplan.make_plan(
            at.meta, RANK, backend="cuda", device="cpu"), modes=plan.modes)
        a = tcpals.cp_als(at, RANK, n_iters=3, tol=0.0, plan=plan)
        b = tcpals.cp_als(at, RANK, n_iters=3, tol=0.0, plan=again)
        assert a.fits == b.fits
        assert all(torch.equal(u, v) for u, v in zip(a.factors, b.factors))
    finally:
        torch.set_num_threads(n)


def test_jax_meta_fingerprint_of_a_port_built_tensor():
    """The port's own build gives the JAX build's fingerprint."""
    x = jsyn.uniform_tensor((21, 9, 6), 120, seed=4)
    jat = jalto.build(x, n_partitions=4)
    at = talto.build_device(TSparse(x.dims, x.coords, x.values),
                            n_partitions=4, device="cpu")
    assert autotune.meta_fingerprint(at.meta) == \
        jautotune.meta_fingerprint(jat.meta)
