"""Port parity: the multi-tenant service (`repro_torch.launch.serve_cpd`).

* Against the JAX `CpdService(backend="reference", tune="off")`, built as
  `tests/test_serving.py` builds it, from the same numpy starts
  (`torch_starts`): the same submissions and seeds give the same
  responses (ok, bucket size, errors, flags) and counters, CP-ALS fits
  within 1e-4 relative, CP-APR KKT violations within 1e-4; deltas the
  same within tolerance.
* Within the port, bit for bit: a served tenant equals its solo run on
  its padded tensor under the class plan, and a delta's response equals a
  direct `ingest.append_delta` and `cp_als(warm_start=)`.
* Degenerate tenants, the store-backed zero warm-up, the trace counters
  bounded by the class count, the worker's lifecycle and a 16-thread
  stress. Every wait, join and shutdown has a timeout and the worker is a
  daemon.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import torch_starts
from repro.launch.serve_cpd import CpdService as JService
from repro.sparse.synthetic import uniform_tensor
from repro.sparse.tensor import SparseTensor as JSparse
from repro_torch.core import alto, batched, cpals, faults, ingest
from repro_torch.core import plan as plan_mod
from repro_torch.core import shapeclass
from repro_torch.kernels import ops
from repro_torch.launch import serve_cpd
from repro_torch.launch.serve_cpd import CpdService
from repro_torch.sparse.tensor import SparseTensor

RANK = 4
SHAPES = [((9, 7, 5), 90), ((12, 6, 8), 100), ((16, 8, 8), 128),
          ((6, 8, 5), 60), ((30, 14, 16), 250)]


@pytest.fixture(autouse=True)
def _starts(monkeypatch, tmp_path):
    faults.reset()
    torch_starts.use(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "j.json"))
    yield
    faults.reset()


def _port(x):
    return SparseTensor(x.dims, x.coords, x.values)


def _empty(dims):
    return JSparse(tuple(dims), np.zeros((0, len(dims)), np.int32),
                   np.zeros((0,), np.float32))


def _tenants(count_data=False, seed0=20):
    return [uniform_tensor(d, m, seed=seed0 + i, count_data=count_data)
            for i, (d, m) in enumerate(SHAPES)]


def _services(algorithm="cp_als", **kw):
    kw.setdefault("capacity", 2)
    kw.setdefault("n_iters", 4)
    kw.setdefault("tol", 0.0)
    kw.setdefault("tune", "off")
    return (JService(RANK, algorithm, backend="reference", **kw),
            CpdService(RANK, algorithm, device="cpu", **kw))


def _history(result):
    return (result.fits if hasattr(result, "fits")
            else result.kkt_violations)


def _same_responses(ref, got, rtol):
    ref = {r.request_id: r for r in ref}
    got = {r.request_id: r for r in got}
    assert sorted(ref) == sorted(got)
    for rid, r in ref.items():
        g = got[rid]
        assert (g.ok, g.error is None, g.degraded, g.retries,
                g.bucket_size) == (r.ok, r.error is None, r.degraded,
                                   r.retries, r.bucket_size), rid
        assert g.sc.dims == r.sc.dims and g.sc.nnz == r.sc.nnz
        if r.result is None:
            assert g.result is None
            continue
        assert [tuple(A.shape) for A in g.result.factors] == \
            [tuple(A.shape) for A in r.result.factors]
        np.testing.assert_allclose(_history(g.result), _history(r.result),
                                   rtol=rtol, atol=1e-6)


COUNTERS = ("tenants_done", "deltas_done", "buckets_run", "shape_classes",
            "retries", "quarantined_tenants", "degraded_dispatches",
            "plan_evictions", "deadline_expired", "errors",
            "worker_recoveries")


@pytest.mark.parametrize("algorithm,capacity",
                         [("cp_als", 2), ("cp_als", 4), ("cp_apr", 2)])
def test_service_matches_the_jax_service(algorithm, capacity):
    """CP-APR runs unguarded on both sides: the JAX guarded batched CP-APR
    raises (its guard writes into a read-only array), which its service
    turns into quarantines. The port's guarded CP-APR service is held to its
    unguarded one bit for bit."""
    apr = algorithm == "cp_apr"
    xs = _tenants(count_data=apr)
    jsvc, tsvc = _services(algorithm, capacity=capacity, guard=not apr)
    for i, x in enumerate(xs):
        assert jsvc.submit(x, seed=i) == tsvc.submit(_port(x), seed=i)
    assert tsvc.pending() == jsvc.pending() == len(xs)
    assert len(tsvc.shape_classes()) == len(jsvc.shape_classes())
    got = tsvc.process()
    _same_responses(jsvc.process(), got, rtol=1e-4)
    js, ts = jsvc.stats(), tsvc.stats()
    assert set(ts) == set(js)
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert ts["latency_p50_s"] <= ts["latency_p99_s"]
    if apr:
        guarded = _services(algorithm, capacity=capacity)[1]
        for i, x in enumerate(xs):
            guarded.submit(_port(x), seed=i)
        for a, b in zip(got, guarded.process()):
            assert _history(a.result) == _history(b.result)
            assert all(torch.equal(fa, fb) for fa, fb in
                       zip(a.result.factors, b.result.factors))


def test_service_deltas_match_the_jax_service():
    xs = _tenants()[:2]
    jsvc, tsvc = _services(capacity=2)
    ids = [(jsvc.submit(x, seed=i), tsvc.submit(_port(x), seed=i))
           for i, x in enumerate(xs)]
    jsvc.process()
    tsvc.process()
    delta = uniform_tensor((10, 9, 5), 12, seed=3)    # grows mode 0 and 1
    for jid, tid in ids:
        jd = jsvc.submit_delta(jid, delta.coords, delta.values)
        td = tsvc.submit_delta(tid, delta.coords, delta.values)
        assert jd == td
    ref, got = jsvc.process(), tsvc.process()
    _same_responses(ref, got, rtol=1e-4)
    assert all(r.ok and r.bucket_size == 1 for r in got)
    # a chained delta on a delta's result
    jc = jsvc.submit_delta(ref[0].request_id, delta.coords[:3],
                           delta.values[:3], policy="last")
    tc = tsvc.submit_delta(got[0].request_id, delta.coords[:3],
                           delta.values[:3], policy="last")
    _same_responses(jsvc.process(), tsvc.process(), rtol=1e-4)
    assert jc == tc
    assert tsvc.stats()["deltas_done"] == jsvc.stats()["deltas_done"] == 3
    with pytest.raises(KeyError):
        tsvc.submit_delta(999, delta.coords, delta.values)
    with pytest.raises(ValueError):
        tsvc.submit_delta(tid, delta.coords, delta.values, policy="max")


def test_delta_response_equals_append_and_warm_start():
    x = _port(_tenants()[1])
    svc = CpdService(RANK, device="cpu", capacity=1, n_iters=4, tol=0.0,
                     tune="off")
    rid = svc.submit(x, seed=5)
    base = svc.process()[0]
    coords = np.array([[1, 2, 3], [11, 5, 7], [13, 1, 0]], np.int32)
    values = np.array([1.5, 2.0, 0.5], np.float32)
    did = svc.submit_delta(rid, coords, values)
    got = svc.process()[0]
    assert got.request_id == did and got.ok
    at = alto.build_device(x, n_partitions=svc.n_partitions,
                           compute_reuse=False, device="cpu")
    grown = ingest.append_delta(at, coords, values)
    want = cpals.cp_als(grown, RANK, n_iters=4, tol=0.0,
                        warm_start=base.result, guard=True)
    assert got.result.fits == want.fits
    assert all(torch.equal(a, b)
               for a, b in zip(got.result.factors, want.factors))


@pytest.mark.parametrize("algorithm,backend", [("cp_als", "reference"),
                                               ("cp_als", "cuda"),
                                               ("cp_apr", "cuda")])
def test_served_tenant_equals_its_solo_run_on_the_padded_tensor(algorithm,
                                                                 backend):
    from repro_torch.core import cpapr
    apr = algorithm == "cp_apr"
    xs = [_port(x) for x in _tenants(count_data=apr)[:2]]
    svc = CpdService(RANK, algorithm, device="cpu", capacity=4, n_iters=3,
                     tol=0.0, tune="off", backend=backend)
    ids = [svc.submit(x, seed=7 + i) for i, x in enumerate(xs)]
    got = {r.request_id: r for r in svc.process()}
    for i, (rid, x) in enumerate(zip(ids, xs)):
        sc = shapeclass.classify(x, RANK)
        plan = svc._class_plan(sc)
        at = shapeclass.canonicalize_tensor(alto.build_device(
            shapeclass.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False, device="cpu"), sc)
        views = plan_mod.build_views(at, plan)
        if apr:
            lam, fs = cpapr.init_factors(x.dims, RANK, seed=7 + i,
                                         total=float(at.values.sum()))
            solo = cpapr.cp_apr(at, RANK, cpapr.CpaprParams(k_max=3, tau=0.0),
                                plan=plan, views=views, lam=lam,
                                factors=batched.embed_factors(fs, sc.dims))
        else:
            fs = cpals.init_factors(x.dims, RANK, seed=7 + i)
            solo = cpals.cp_als(at, RANK, n_iters=3, tol=0.0, plan=plan,
                                views=views,
                                factors=batched.embed_factors(fs, sc.dims))
        res = got[rid].result
        assert _history(res) == _history(solo)
        for a, b in zip(res.factors, solo.factors):
            assert torch.equal(a, b[:a.shape[0]])
        assert torch.equal(res.lam, solo.lam)


def test_degenerate_tenants_through_service():
    xs = [_empty((6, 5, 4)),
          JSparse((6, 5, 4), np.array([[1, 1, 1]], np.int32),
                  np.array([3.0], np.float32)),
          uniform_tensor((6, 5, 4), 30, seed=9)]
    jsvc, tsvc = _services(capacity=4, n_iters=5, tol=1e-4)
    for x in xs:
        jsvc.submit(x)
        tsvc.submit(_port(x))
    ref = jsvc.process()
    got = tsvc.process()
    _same_responses(ref, got, rtol=1e-4)
    r_empty = got[0].result
    assert r_empty.fits[-1] == pytest.approx(1.0, abs=1e-6)
    assert all(not A.any() for A in r_empty.factors)
    assert [tuple(A.shape) for A in r_empty.factors] == [(6, RANK), (5, RANK),
                                                         (4, RANK)]
    for r in got[1:]:
        assert np.isfinite(r.result.fits).all()
        assert all(torch.isfinite(A).all() for A in r.result.factors)


def test_zero_warmup_second_service():
    """A class tuned once dispatches with no timing run from a second
    service on the same store."""
    xs = [_port(uniform_tensor((9, 7, 5), 90, seed=i)) for i in range(3)]
    first = CpdService(RANK, device="cpu", capacity=4, n_iters=2,
                       tune="auto", backend="cuda")
    for x in xs:
        first.submit(x)
    r0 = ops.timing_runs()
    assert all(r.ok for r in first.process())
    assert ops.timing_runs() > r0                 # the store missed: tuned
    runs = ops.timing_runs()
    second = CpdService(RANK, device="cpu", capacity=4, n_iters=2,
                        tune="auto", backend="cuda")
    for x in xs:
        second.submit(x)
    assert len(second.process()) == len(xs)
    assert ops.timing_runs() == runs


@pytest.mark.parametrize("tune", ["auto", "search"])
def test_tuned_class_plan_may_route_recursive(monkeypatch, tmp_path, tune):
    """The class tuner measures the recursive candidates too, as the JAX
    package's does: under a timer on which recursive wins, the exhaustive
    tuner routes recursive every mode whose Temp `plan.recursive_fits`;
    the budgeted search holds those genes in its pools and, warm-started
    from a stored neighbour class (rank 2), routes recursive where they
    fit. The service serves the tuned class bit for bit each tenant's
    solo run on its padded tensor under that plan."""
    from repro_torch.core import autotune, heuristics, search

    def fake(cand_plan, at, views, factors, mode):
        recursive = (cand_plan.modes[mode].traversal
                     is heuristics.Traversal.RECURSIVE)
        return (1e-6 if recursive else 1e-3), 0.0
    monkeypatch.setattr(autotune, "_time_mttkrp", fake)
    monkeypatch.setattr(search, "_time_mttkrp", fake)
    xs = [_port(uniform_tensor((9, 7, 5), 90, seed=3)),
          _port(uniform_tensor((12, 6, 8), 100, seed=4))]
    sc = shapeclass.classify(xs[1], RANK)
    assert sc.admits(xs[0])
    at = shapeclass.canonicalize_tensor(alto.build_device(
        shapeclass.pad_to_class(xs[0], sc), n_partitions=sc.n_partitions,
        compute_reuse=False, device="cpu"), sc)
    fits = [plan_mod.recursive_fits(at.meta, n, RANK,
                                    plan_mod.choose_rank_block(RANK))
            for n in range(len(sc.dims))]
    assert any(fits)
    # Stored where the service looks (the test's plan store), so the
    # service serves this plan.
    if tune == "search":
        assert [any(g.traversal is heuristics.Traversal.RECURSIVE
                    for g in search.mode_pool(at.meta, n, RANK,
                                              backend="cuda"))
                for n in range(len(sc.dims))] == fits
        neighbour = dataclasses.replace(sc, rank=2)
        plan_mod.make_class_plan(neighbour, backend="cuda", device="cpu",
                                 tune="auto", at=at)
    cls = plan_mod.make_class_plan(sc, backend="cuda", device="cpu",
                                   tune=tune, at=at)
    routed = [m.traversal is heuristics.Traversal.RECURSIVE
              for m in cls.modes]
    if tune == "auto":
        assert routed == fits
    else:
        assert any(routed) and all(f for r, f in zip(routed, fits) if r)
    svc = CpdService(RANK, device="cpu", backend="cuda", capacity=2,
                     n_iters=3, tol=0.0, tune=tune)
    ids = [svc.submit(x, seed=5 + i) for i, x in enumerate(xs)]
    got = {r.request_id: r for r in svc.process()}
    plan = svc._class_plan(sc)
    assert plan == cls
    for i, (rid, x) in enumerate(zip(ids, xs)):
        assert got[rid].ok and got[rid].bucket_size == 2
        padded = shapeclass.canonicalize_tensor(alto.build_device(
            shapeclass.pad_to_class(x, sc), n_partitions=sc.n_partitions,
            compute_reuse=False, device="cpu"), sc)
        fs = cpals.init_factors(x.dims, RANK, seed=5 + i)
        solo = cpals.cp_als(padded, RANK, n_iters=3, tol=0.0, plan=plan,
                            views=plan_mod.build_views(padded, plan),
                            factors=batched.embed_factors(fs, sc.dims))
        res = got[rid].result
        assert res.fits == solo.fits
        for a, b in zip(res.factors, solo.factors):
            assert torch.equal(a, b[:a.shape[0]])
        assert torch.equal(res.lam, solo.lam)


def test_a_delta_drops_its_base_pull_orders():
    """A delta changes its tensor's partition boxes: `ingest.append_delta`
    drops the base's cached pull orders with its views
    (`views.invalidate_changed`), and the grown tensor sorts its own."""
    from repro_torch.core import views as views_mod
    x = _port(uniform_tensor((12, 6, 8), 100, seed=4))
    at = alto.build_device(x, n_partitions=8, device="cpu")
    key = [("pull", *views_mod.mode_fingerprint(at, n), at.meta)
           for n in range(3)]
    before = [views_mod.get_pull_order(at, n) for n in range(3)]
    assert all(k in views_mod._CACHE for k in key)
    grown = ingest.append_delta(at, np.array([[13, 2, 7], [0, 6, 8]],
                                             np.int32), [1.0, 2.0])
    assert not any(k in views_mod._CACHE for k in key)
    after = views_mod.get_pull_order(grown, 0)
    assert not torch.equal(after.rows, before[0].rows) or \
        after.rows.shape != before[0].rows.shape


def test_trace_counters_bounded_by_the_class_count():
    xs = [_port(x) for x in _tenants()] * 2
    classes = {shapeclass.classify(x, RANK) for x in xs}
    ingest0 = alto.device_ingest_traces()
    svc = CpdService(RANK, device="cpu", capacity=4, n_iters=2, tol=0.0,
                     tune="off")
    batched.sweep_cache_clear()
    for i, x in enumerate(xs):
        svc.submit(x, seed=i)
    assert len(svc.process()) == len(xs)
    s = svc.stats()
    ingest1 = s["ingest_traces"]
    assert ingest1["build"] - ingest0["build"] <= len(classes)
    assert ingest1["view"] - ingest0["view"] <= 3 * len(classes)
    assert s["sweep_traces"]["als"] <= len(classes) < len(xs)
    assert s["shape_classes"] == len(classes)
    assert s["tenants_done"] == len(xs) and s["tenants_per_s"] > 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CpdService(RANK)
    with pytest.raises(ValueError):
        CpdService(RANK, "cp_xyz", device="cpu")


def test_cli_on_the_cpu(capsys):
    out = serve_cpd.main(["--device", "cpu", "--tenants", "4",
                          "--capacity", "2", "--iters", "2", "--tune", "off",
                          "--worker", "--max-wait-s", "0.01"])
    assert len(out) == 4 and all(r.ok for r in out)
    assert "served 4 tenants" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The worker loop
# ---------------------------------------------------------------------------

def _svc(**kw):
    kw.setdefault("capacity", 2)
    kw.setdefault("n_iters", 3)
    kw.setdefault("tune", "off")
    return CpdService(RANK, device="cpu", **kw)


def test_worker_lifecycle():
    svc = _svc(max_wait_s=0.01)
    assert not svc.serving
    svc.serve(poll_s=0.002)
    svc.serve(poll_s=0.002)                    # idempotent
    assert svc.serving and svc.stats()["worker_alive"]
    rid = svc.submit(_port(_tenants()[0]))
    assert svc.wait(rid, timeout=60).ok
    svc.shutdown(timeout=60)
    assert not svc.serving
    svc.shutdown(timeout=60)                   # idempotent
    assert svc.stats()["worker_recoveries"] == 0


def test_shutdown_drains_admitted_requests():
    svc = _svc(capacity=8)                     # never fills a bucket
    svc.serve(poll_s=0.002)
    rids = [svc.submit(_port(x)) for x in _tenants()[:3]]
    svc.shutdown(wait=True, timeout=60)
    assert all(svc.wait(r, timeout=5).ok for r in rids)


def test_wait_times_out():
    with pytest.raises(TimeoutError):
        _svc().wait(999, timeout=0.02)


def test_sixteen_thread_stress():
    import sys
    svc = _svc(capacity=4, max_wait_s=0.01, retain_results=256)
    svc.serve(poll_s=0.002)
    n_threads, per_thread = 16, 2
    failures: list[str] = []
    lock = threading.Lock()
    xs = [_port(uniform_tensor((9, 7, 5), 40 + 7 * k, seed=k))
          for k in range(5)]

    def client(t):
        try:
            rids = [svc.submit(xs[(t + j) % len(xs)], seed=t)
                    for j in range(per_thread)]
            for r in [svc.wait(r, timeout=120) for r in rids]:
                if not r.ok:
                    raise AssertionError(f"thread {t}: {r.error}")
            if t % 2 == 0:
                x2 = uniform_tensor((9, 7, 5), 6, seed=100 + t)
                did = svc.submit_delta(rids[0], x2.coords, x2.values)
                rd = svc.wait(did, timeout=120)
                if not rd.ok:
                    raise AssertionError(f"thread {t} delta: {rd.error}")
        except Exception as exc:  # noqa: BLE001 — collected for the report
            with lock:
                failures.append(f"{type(exc).__name__}: {exc}")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,), daemon=True)
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    finally:
        sys.setswitchinterval(switch)
    svc.shutdown(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not failures, failures
    s = svc.stats()
    assert s["tenants_done"] == n_threads * per_thread
    assert s["deltas_done"] == n_threads // 2
    assert s["worker_recoveries"] == 0 and s["errors"] == 0
