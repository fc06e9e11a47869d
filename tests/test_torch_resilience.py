"""Port parity: the service's recovery ladder, stream integrity under the
fault sites, and `health.degrade_plan`.

* `TestServiceResilience` of `tests/test_resilience.py`, run through the
  JAX `CpdService(backend="reference")` and the port's on the CPU from
  the same numpy starts (`torch_starts`) with the same arming: the same
  requests fail, retry, degrade, bisect and quarantine, and the counters
  agree. Arming counts follow the port's eager sites.
* The port's own rules: no failure swaps the kernels for their plain
  versions. A `faults.DispatchError` takes the evict-and-retune rung
  under ``tune`` other than "off" and nothing else; a `RuntimeError` like
  the one a failed ``nvcc`` build or kernel launch raises
  (`kernels._build`) gets no softer plan. The ladder re-raises what it
  cannot cure, the bucket is bisected and only the offender gets an
  error. A poisoned CUDA context raises `faults.DeviceLost` instead of
  turning into quarantines.
* Spilled streams under ``stream.memmap_load``, ``stream.checksum`` and
  ``stream.respill``, the chunked executors under ``ops.chunk_oom``, and
  `degrade_plan`'s rungs against the JAX package's.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import torch_starts
from repro.core import alto as jalto
from repro.core import batched as jbatched
from repro.core import faults as jfaults
from repro.core import health as jhealth
from repro.core import plan as jplan
from repro.core import views as jviews
from repro.launch.serve_cpd import CpdService as JService
from repro.sparse.synthetic import uniform_tensor
from repro_torch.core import alto, autotune, batched, cpals, faults, health
from repro_torch.core import ingest, shapeclass
from repro_torch.core import plan as plan_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import views as views_mod
from repro_torch.kernels import mttkrp_oriented as kori
from repro_torch.launch.serve_cpd import CpdService
from repro_torch.sparse.tensor import SparseTensor

RANK = 3
DIMS = (9, 7, 5)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    faults.reset()
    jfaults.reset()
    stream_mod.integrity_stats_clear()
    torch_starts.use(monkeypatch)
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "j.json"))
    yield
    faults.reset()
    jfaults.reset()


def _tensor(seed=0, dims=DIMS, nnz=80, count_data=False):
    return uniform_tensor(dims, nnz, seed=seed, count_data=count_data)


def _port(x):
    return SparseTensor(x.dims, x.coords, x.values)


def _kw(kw):
    kw.setdefault("capacity", 2)
    kw.setdefault("n_iters", 4)
    kw.setdefault("tune", "off")
    kw.setdefault("retry_base_s", 1e-4)
    return kw


def _jsvc(**kw):
    return JService(RANK, backend="reference", **_kw(kw))


def _tsvc(**kw):
    return CpdService(RANK, device="cpu", **_kw(kw))


def _outcome(responses):
    return {r.request_id: (r.ok, r.degraded, r.retries, r.bucket_size,
                           None if r.error is None else r.error.split(":")[0])
            for r in responses}


def _both(setup, arm=None, **kw):
    """The same scenario through the JAX service and the port's: each
    armed in its own package, ``setup(svc, port)`` submits; returns
    ``(jax responses, port responses, jax stats, port stats)``."""
    out = []
    for svc, fl, port in ((_jsvc(**kw), jfaults, False),
                          (_tsvc(**kw), faults, True)):
        if arm is not None:
            fl.arm(*arm[0], **arm[1])
        setup(svc, port)
        out.append((svc.process(), svc.stats()))
        fl.reset()
    (jr, js), (tr, ts) = out
    return jr, tr, js, ts


def _submit(seeds, count_data=False):
    def setup(svc, port):
        for s in seeds:
            x = _tensor(seed=s, count_data=count_data)
            svc.submit(_port(x) if port else x, seed=s)
    return setup


COUNTERS = ("tenants_done", "buckets_run", "retries", "quarantined_tenants",
            "degraded_dispatches", "plan_evictions", "deadline_expired",
            "errors")


def _same(jr, tr, js, ts):
    assert _outcome(tr) == _outcome(jr)
    assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    ref = {r.request_id: r for r in jr}
    for r in tr:
        if r.ok:
            np.testing.assert_allclose(r.result.fits,
                                       ref[r.request_id].result.fits,
                                       rtol=1e-4, atol=1e-6)


class TestServiceResilience:

    def test_poisoned_tenant_gets_structured_error_only(self):
        jr, tr, js, ts = _both(_submit((0, 1, 2)),
                               (("batched.nan",), {"data": {"tenant": 1}}),
                               capacity=3)
        _same(jr, tr, js, ts)
        rs = {r.request_id: r for r in tr}
        assert not rs[1].ok and "quarantined" in rs[1].error
        assert rs[1].result is not None and rs[0].ok and rs[2].ok
        assert ts["quarantined_tenants"] == 1 and ts["errors"] == 1

    def test_transient_faults_retried_with_backoff(self):
        views_mod.cache_clear()
        jviews.cache_clear()
        jr, tr, js, ts = _both(_submit((0, 1)),
                               (("views.build",), {"times": 2}))
        _same(jr, tr, js, ts)
        assert all(r.ok and r.retries == 2 for r in tr)
        assert ts["retries"] == 2 and ts["backoff_s"] > 0

    def test_bucket_failure_bisects_to_solo_runs(self):
        jr, tr, js, ts = _both(_submit((0, 1)),
                               (("batched.sweep",), {"times": 1}))
        _same(jr, tr, js, ts)
        assert all(r.ok and r.bucket_size == 1 for r in tr)

    def test_second_solo_failure_quarantines_offender(self):
        jr, tr, js, ts = _both(_submit((0, 1)),
                               (("batched.sweep",), {"times": 2}))
        _same(jr, tr, js, ts)
        rs = {r.request_id: r for r in tr}
        assert "quarantined after repeated failures" in rs[0].error
        assert rs[1].ok and ts["quarantined_tenants"] == 1

    @pytest.mark.parametrize("algorithm", ["cp_als", "cp_apr"])
    def test_solo_failure_after_a_good_sweep(self, algorithm):
        """`after` places the shots: the bucket fails at its second sweep
        and the first member's solo re-run at its first."""
        apr = algorithm == "cp_apr"
        jr, tr, js, ts = _both(_submit((3, 4), count_data=apr),
                               (("batched.sweep",), {"times": 2,
                                                     "after": 1}),
                               algorithm=algorithm, guard=not apr)
        assert _outcome(tr) == _outcome(jr)
        assert [r.ok for r in tr] == [False, True]

    def test_evict_and_retune_on_stored_plan_failure(self):
        x = _tensor(seed=12, dims=(8, 6, 4), nnz=50)
        for svc, fl, port in ((_jsvc, jfaults, False),
                              (_tsvc, faults, True)):
            warm = svc(tune="auto")
            warm.submit(_port(x) if port else x)
            assert all(r.ok for r in warm.process())
            store = (autotune if port else __import__(
                "repro.core.autotune", fromlist=["x"]))
            assert len(store.load_store()) == 1
            # the JAX site fires when the sweep is traced, not on a call
            jbatched.sweep_cache_clear()
            fl.arm("plan.dispatch", times=1)
            fresh = svc(tune="auto")
            fresh.submit(_port(x) if port else x)
            rs = fresh.process()
            assert all(r.ok and r.degraded for r in rs)
            assert fresh.stats()["plan_evictions"] == 1
            assert fresh.stats()["degraded_dispatches"] == 0
            assert len(store.load_store()) == 0

    def test_corrupt_plan_store_is_a_miss_not_a_crash(self):
        faults.arm("autotune.store")
        assert autotune.load_store() == {}
        svc = _tsvc(tune="auto")
        svc.submit(_port(_tensor(seed=13, dims=(8, 6, 4), nnz=50)))
        assert all(r.ok for r in svc.process())

    def test_deadline_expired_request_gets_error(self):
        def setup(svc, port):
            for s, d in ((0, 0.0), (1, 3600.0)):
                x = _tensor(seed=s)
                svc.submit(_port(x) if port else x, deadline_s=d)
            time.sleep(0.005)
        jr, tr, js, ts = _both(setup)
        _same(jr, tr, js, ts)
        rs = {r.request_id: r for r in tr}
        assert "deadline expired" in rs[0].error and rs[0].result is None
        assert rs[1].ok and ts["deadline_expired"] == 1

    def test_deadline_aware_flush(self):
        svc = _tsvc(capacity=4, max_wait_s=0.02)
        svc.submit(_port(_tensor(seed=0)))
        assert svc.process(flush=False) == []      # partial, still young
        time.sleep(0.03)
        rs = svc.process(flush=False)              # aged past max_wait_s
        assert len(rs) == 1 and rs[0].ok

    def test_ingest_merge_interrupt_leaves_base_serviceable(self):
        x2 = _tensor(seed=15, nnz=20)
        for svc, fl, port in ((_jsvc, jfaults, False),
                              (_tsvc, faults, True)):
            s = svc(capacity=1)
            x = _tensor(seed=14)
            rid = s.submit(_port(x) if port else x)
            assert s.process()[0].ok
            fl.arm("ingest.merge")
            did = s.submit_delta(rid, x2.coords, x2.values)
            r = {r.request_id: r for r in s.process()}[did]
            assert not r.ok and "resubmit is safe" in r.error
            did2 = s.submit_delta(rid, x2.coords, x2.values)
            r2 = {r.request_id: r for r in s.process()}[did2]
            assert r2.ok and r2.retries == 0
            fl.reset()
        assert all(torch.isfinite(A).all() for A in r2.result.factors)


# ---------------------------------------------------------------------------
# The port's own ladder rules
# ---------------------------------------------------------------------------

def _cuda_service(**kw):
    """The kernel backend's plan on the CPU: its wrappers run their plain
    versions, through the same `ops` entries as on the card."""
    return _tsvc(backend="cuda", capacity=3, **kw)


def test_dispatch_error_takes_the_backend_rung():
    """The one rung a `DispatchError` has is evict-and-retune (see
    `test_evict_and_retune_on_stored_plan_failure`); with the static plan
    (``tune="off"``) there is none. One that survives goes to bisection:
    the offender's solo re-run fails too and only it gets an error; its
    mates are served alone on the kernel plan, with the bits of a clean
    bucket, and nothing is degraded."""
    svc = _cuda_service()
    for s in (0, 1, 2):
        svc.submit(_port(_tensor(seed=s)), seed=s)
    faults.arm("ops.exec", times=2)
    rs = {r.request_id: r for r in svc.process()}
    assert faults.fired() == {"ops.exec": 2}
    assert not rs[0].ok and "quarantined after repeated failures" in \
        rs[0].error and "injected dispatch failure" in rs[0].error
    assert all(rs[i].ok and rs[i].bucket_size == 1 for i in (1, 2))
    assert not any(r.degraded for r in rs.values())
    s = svc.stats()
    assert s["degraded_dispatches"] == s["plan_evictions"] == 0
    assert s["quarantined_tenants"] == s["errors"] == 1
    (sc,) = svc._plans
    assert svc._plans[sc].backend == "cuda"
    clean = _cuda_service()
    for i in (0, 1, 2):
        clean.submit(_port(_tensor(seed=i)), seed=i)
    for b in clean.process():
        if b.request_id:
            assert rs[b.request_id].result.fits == b.result.fits


@pytest.mark.parametrize("message", [
    "nvcc failed for mttkrp_oriented:\nerror: expected a ';'",
    "alto_carry_runs: CUDA error 1"])
def test_build_or_launch_failure_is_not_degraded(monkeypatch, message):
    def broken(*args, **kwargs):
        raise RuntimeError(message)
    monkeypatch.setattr(kori, "mttkrp_oriented_carry", broken)
    monkeypatch.setattr(kori, "oriented_partials", broken)
    svc = _cuda_service()
    for s in (0, 1, 2):
        svc.submit(_port(_tensor(seed=s)), seed=s)
    rs = svc.process()
    assert all(not r.ok and not r.degraded for r in rs)
    assert all("quarantined after repeated failures" in r.error
               and message.splitlines()[0] in r.error for r in rs)
    s = svc.stats()
    assert s["degraded_dispatches"] == 0 and s["plan_evictions"] == 0
    assert s["quarantined_tenants"] == 3
    (sc,) = svc._plans
    assert svc._plans[sc].backend == "cuda"


def test_degrade_plan_refuses_a_build_error():
    at = alto.build_device(_port(_tensor(seed=6)), n_partitions=2,
                           device="cpu")
    plan = plan_mod.make_plan(at.meta, RANK, backend="cuda", device="cpu")
    for exc in (RuntimeError("nvcc failed for mttkrp_oriented"),
                RuntimeError("alto_carry_runs: CUDA error 700"),
                faults.InjectedInterrupt("x"), ValueError("bad")):
        assert health.degrade_plan(plan, exc) == (None, None)
    # nor does a dispatch failure: the kernels are never swapped out
    assert health.degrade_plan(plan, faults.DispatchError("tiling")) == \
        (None, None)


def test_ladder_reraises_what_it_cannot_soften():
    svc = _cuda_service(tune="auto")
    sc = shapeclass.classify(_port(_tensor(seed=0)), RANK)
    svc._class_plan(sc)
    calls = []

    def run():
        calls.append(1)
        raise RuntimeError("nvcc failed for phi_oriented")

    with pytest.raises(RuntimeError, match="nvcc failed"):
        svc._with_ladder(sc, run)
    assert len(calls) == 1
    s = svc.stats()
    assert s["degraded_dispatches"] == s["plan_evictions"] == 0
    assert s["retries"] == 0


@pytest.mark.parametrize("worker", [False, True])
def test_lost_device_is_fatal_not_a_quarantine(monkeypatch, worker):
    monkeypatch.setattr(health, "device_lost", lambda device: RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    svc = _cuda_service()
    rids = [svc.submit(_port(_tensor(seed=s)), seed=s) for s in (0, 1, 2)]
    faults.arm("batched.sweep")
    if worker:
        svc.serve(poll_s=0.002)
        with pytest.raises(faults.DeviceLost, match="illegal memory"):
            svc.wait(rids[0], timeout=60)
        svc.shutdown(timeout=60)
        assert not svc.serving
    else:
        with pytest.raises(faults.DeviceLost, match="illegal memory"):
            svc.process()
    s = svc.stats()
    assert s["quarantined_tenants"] == 0 and s["errors"] == 0
    assert s["retries"] == 0 and s["worker_recoveries"] == 0


# ---------------------------------------------------------------------------
# Stream integrity under the fault sites
# ---------------------------------------------------------------------------

def _spilled(tmp_path, seed=0):
    at = alto.build_device(_port(_tensor(seed=seed)), n_partitions=2,
                           device="cpu")
    hs = stream_mod.to_memmap(stream_mod.host_stream(at, 0), tmp_path)
    return at, hs


class TestStreamIntegrity:

    def test_corruption_detected_at_load(self, tmp_path):
        at, _ = _spilled(tmp_path)
        faults.arm("stream.checksum")
        with pytest.raises(stream_mod.StreamIntegrityError,
                           match="fails its checksum"):
            stream_mod.from_memmap(tmp_path, at.meta, 0)
        assert stream_mod.integrity_stats()["checksum_failures"] == 1

    def test_load_or_rebuild_recovers_corruption(self, tmp_path):
        at, hs = _spilled(tmp_path)
        faults.arm("stream.checksum")
        rebuilt = stream_mod.load_or_rebuild(tmp_path, at, 0)
        assert stream_mod.integrity_stats()["rebuilds"] == 1
        for f in ("rows", "words", "values"):
            assert torch.equal(getattr(rebuilt, f), getattr(hs, f))
        assert stream_mod.from_memmap(
            tmp_path, at.meta, 0).checksum == rebuilt.checksum

    def test_respill_crash_leaves_old_generation_intact(self, tmp_path):
        at, hs = _spilled(tmp_path)
        x2 = _tensor(seed=1, nnz=30)
        at2 = ingest.append_delta(at, x2.coords, x2.values)
        faults.arm("stream.respill")
        with pytest.raises(faults.InjectedInterrupt):
            stream_mod.append_stream(hs, at2)
        old = stream_mod.from_memmap(tmp_path, at.meta, 0)
        assert old.checksum == hs.checksum
        assert torch.equal(old.words, hs.words)
        fresh = stream_mod.host_stream(at2, 0)
        redo = stream_mod.append_stream(hs, at2)
        assert torch.equal(redo.words, fresh.words)
        assert torch.equal(redo.values, fresh.values)

    def test_memmap_load_fault_is_transient(self, tmp_path):
        at, hs = _spilled(tmp_path)
        faults.arm("stream.memmap_load")
        with pytest.raises(OSError):
            stream_mod.from_memmap(tmp_path, at.meta, 0)
        again = stream_mod.from_memmap(tmp_path, at.meta, 0)
        assert again.checksum == hs.checksum

    def test_the_jax_package_reads_the_ports_spill(self, tmp_path):
        at, hs = _spilled(tmp_path)
        jat = jalto.build(_tensor(seed=0), n_partitions=2)
        from repro.core import stream as jstream
        got = jstream.from_memmap(tmp_path, jat.meta, 0)
        assert got.checksum == hs.checksum


# ---------------------------------------------------------------------------
# Chunked executors and degrade_plan
# ---------------------------------------------------------------------------

def test_chunk_oom_retry_and_halving_keep_the_bits():
    at = alto.build_device(_port(_tensor(seed=5, nnz=400, dims=(64, 9, 5))),
                           n_partitions=2, device="cpu")
    plan = plan_mod.make_plan(at.meta, RANK, backend="cuda", device="cpu",
                              device_bytes=1)
    align = max(m.block_m for m in plan.modes)
    cm = 4 * align
    plan = dataclasses.replace(plan, streaming=dataclasses.replace(
        plan.streaming, chunk_m=cm, n_chunks=plan_mod.chunk_count(
            plan.meta, cm)))
    views = plan_mod.build_views(at, plan)
    clean = cpals.cp_als(at, RANK, n_iters=3, plan=plan, views=views)
    faults.arm("ops.chunk_oom", after=3)
    with pytest.raises(torch.OutOfMemoryError) as err:
        cpals.cp_als(at, RANK, n_iters=3, plan=plan, views=views)
    halved, why = health.degrade_plan(plan, err.value)
    assert "chunk_m" in why and halved.streaming.chunk_m == 2 * align
    again = cpals.cp_als(at, RANK, n_iters=3, plan=halved, views=views)
    assert again.fits == clean.fits
    assert all(torch.equal(a, b) for a, b in zip(again.factors,
                                                  clean.factors))


def test_degrade_plan_halves_chunks_as_the_jax_package():
    """The same ladder in units of each plan's alignment (its largest
    ``block_m``, which the two packages' device models size apart)."""
    x = _tensor(seed=5, nnz=4000, dims=(64, 9, 5))
    at = alto.build_device(_port(x), n_partitions=2, device="cpu")
    jat = jalto.build(x, n_partitions=2)
    plans = [plan_mod.make_plan(at.meta, RANK, device="cpu", device_bytes=1),
             jplan.make_plan(jat.meta, RANK, device_bytes=1)]
    chains = []
    for p, (deg, oom) in zip(plans, (
            (health.degrade_plan, faults.InjectedResourceExhausted("c")),
            (jhealth.degrade_plan, jfaults.InjectedResourceExhausted("c")))):
        align = max(m.block_m for m in p.modes)
        p = dataclasses.replace(p, streaming=dataclasses.replace(
            p.streaming, chunk_m=6 * align,
            n_chunks=plan_mod.chunk_count(p.meta, 6 * align)))
        chain = []
        while p is not None:
            assert p.streaming.n_chunks == plan_mod.chunk_count(
                p.meta, p.streaming.chunk_m)
            chain.append(p.streaming.chunk_m // align)
            p, _ = deg(p, oom)
        chains.append(chain)
    assert chains[0] == chains[1] == [6, 3, 1]


def test_degrade_plan_backend_rung_and_exhaustion():
    """No backend rung: a dispatch failure softens neither an in-core
    nor a streaming kernel plan (the streaming rung is `test_degrade_plan_
    halves_chunks_as_the_jax_package`'s)."""
    at = alto.build_device(_port(_tensor(seed=6)), n_partitions=2,
                           device="cpu")
    plan = plan_mod.make_plan(at.meta, RANK, backend="cuda", device="cpu")
    streamed = plan_mod.make_plan(at.meta, RANK, backend="cuda",
                                  device="cpu", device_bytes=1)
    assert streamed.streaming is not None
    for p in (plan, streamed):
        assert health.degrade_plan(
            p, faults.InjectedDispatchError("x")) == (None, None)
    # an allocator failure of an in-core plan has no rung
    assert health.degrade_plan(
        plan, faults.InjectedResourceExhausted("x")) == (None, None)


def test_batched_sweep_site_fires_before_each_sweep():
    x = _port(_tensor(seed=2))
    sc = shapeclass.classify(x, RANK)
    plan = plan_mod.make_class_plan(sc, device="cpu")
    at = shapeclass.canonicalize_tensor(alto.build_device(
        shapeclass.pad_to_class(x, sc), n_partitions=sc.n_partitions,
        compute_reuse=False, device="cpu"), sc)
    views = plan_mod.build_views(at, plan)
    faults.arm("batched.sweep", after=2)
    with pytest.raises(faults.InjectedInterrupt):
        batched.batched_cp_als([at], [views], [x.dims], RANK, plan=plan,
                               n_iters=5)
    assert faults.fired() == {"batched.sweep": 1}
