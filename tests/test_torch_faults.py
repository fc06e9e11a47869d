"""Port parity: the fault registry (`repro_torch.core.faults`).

Mirrors `tests/test_resilience.py::TestFaultRegistry` on the port's copy,
holds its site table to the JAX package's, and pins what the port
changed: the variable is ``$REPRO_TORCH_FAULTS``, an injected allocator
failure is a `torch.OutOfMemoryError`, an injected dispatch failure a
`DispatchError`, and every site fires where the port's hot path reaches
it (on every call: the port runs eagerly).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro_torch.core import alto, autotune, cpals, faults, ingest
from repro_torch.core import plan as plan_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import views as views_mod
from repro_torch.kernels import ops
from repro_torch.sparse.synthetic import uniform_tensor

RANK = 3


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def test_sites_are_the_jax_packages():
    assert faults.SITES == jfaults.SITES
    assert len(faults.SITES) == 14


class TestFaultRegistry:

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            faults.arm("nope.such_site")
        with pytest.raises(ValueError, match="unknown fault site"):
            faults.configure("stream.chunk_io,typo.site:3")

    @pytest.mark.parametrize("times,after", [(0, 0), (1, -1)])
    def test_bad_arming_rejected(self, times, after):
        with pytest.raises(ValueError):
            faults.arm("ingest.merge", times=times, after=after)

    def test_deterministic_times(self):
        faults.arm("ingest.merge", times=2)
        for _ in range(2):
            with pytest.raises(faults.InjectedInterrupt):
                faults.inject("ingest.merge")
        faults.inject("ingest.merge")        # exhausted: no-op
        assert faults.fired()["ingest.merge"] == 2
        assert not faults.armed("ingest.merge")

    def test_zero_overhead_disabled(self):
        assert faults._ENABLED is False
        assert faults.fire("batched.nan") is None
        faults.inject("ops.chunk_oom")       # returns, does not raise

    def test_injected_scopes_the_arm(self):
        with faults.injected("stream.chunk_io", times=5):
            assert faults.armed("stream.chunk_io")
        assert not faults.armed("stream.chunk_io")
        assert faults._ENABLED is False

    def test_env_spec_parsing(self):
        faults.configure("stream.chunk_io:2, batched.nan")
        assert faults.armed("stream.chunk_io")
        assert faults.armed("batched.nan")
        faults.configure(None)
        assert faults._ENABLED is False

    def test_env_variable_is_the_ports_own(self):
        env = dict(os.environ, REPRO_TORCH_FAULTS="views.build:2",
                   REPRO_FAULTS="ops.exec")
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (env.get("PYTHONPATH"), "src") if p)
        out = subprocess.run(
            [sys.executable, "-c",
             "from repro_torch.core import faults; "
             "print(sorted(faults._ARMED), faults._ARMED['views.build']"
             ".remaining)"],
            env=env, capture_output=True, text=True, check=True)
        assert out.stdout.split() == ["['views.build']", "2"]

    def test_exception_classes_mimic_real_faults(self):
        oom = faults.InjectedResourceExhausted("ops.chunk_oom")
        assert isinstance(oom, torch.OutOfMemoryError)
        assert faults.is_transient(oom)
        assert faults.is_transient(torch.OutOfMemoryError("real"))
        assert faults.is_transient(faults.InjectedIOError("x"))
        assert "RESOURCE_EXHAUSTED" not in str(oom)
        disp = faults.InjectedDispatchError("x")
        assert isinstance(disp, faults.DispatchError)
        assert not faults.is_transient(disp)
        assert not faults.is_transient(faults.InjectedInterrupt("x"))
        # A build or launch failure is a plain RuntimeError: no dispatch.
        assert not isinstance(RuntimeError("nvcc failed"),
                              faults.DispatchError)
        assert isinstance(faults.InjectedCorruption("x"), ValueError)
        for site in faults.SITES:
            if faults.SITES[site] != "nan":
                assert faults.is_injected(faults._exception_for(site))

    def test_after_skips_leading_hits(self):
        faults.arm("ingest.merge", times=1, after=2)
        faults.inject("ingest.merge")            # hit 1: let through
        faults.inject("ingest.merge")            # hit 2: let through
        with pytest.raises(faults.InjectedInterrupt):
            faults.inject("ingest.merge")        # hit 3: fires
        assert faults.fired()["ingest.merge"] == 1

    def test_data_rides_along(self):
        faults.arm("batched.nan", data={"tenant": 2, "value": 7.0})
        assert faults.fire("batched.nan") == {"tenant": 2, "value": 7.0}
        assert faults.fire("batched.nan") is None


# ---------------------------------------------------------------------------
# Every raising site fires where the port's hot path reaches it
# ---------------------------------------------------------------------------

def _at(seed=0, nnz=80, dims=(9, 7, 5)):
    return alto.build_device(uniform_tensor(dims, nnz, seed=seed),
                             n_partitions=2, device="cpu")


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_plan_dispatch_fires_in_both_executes(backend):
    at = _at()
    plan = plan_mod.make_plan(at.meta, RANK, backend=backend, device="cpu")
    views = plan_mod.build_views(at, plan)
    fs = cpals.init_factors(at.dims, RANK, device="cpu")
    with faults.injected("plan.dispatch"):
        with pytest.raises(faults.DispatchError):
            plan_mod.execute_mttkrp(plan, at, views, fs, 0)
    B = fs[0].abs() + 0.1
    with faults.injected("plan.dispatch"):
        with pytest.raises(faults.DispatchError):
            plan_mod.execute_phi(plan, at, views.get(0), B, 0, factors=fs)
    assert faults.fired()["plan.dispatch"] == 2


@pytest.mark.parametrize("field,value", [("r_block", 2), ("r_block", 0),
                                         ("block_m", 12), ("block_m", 4096),
                                         ("threads", 2048)])
def test_untakeable_stored_tiling_is_a_store_miss(field, value, tmp_path):
    """A stored plan whose tiling the kernels cannot take (one from
    another build) never reaches a dispatch: `autotune.deserialize_plan`
    refuses it, so the store lookup misses and the static plan runs."""
    import dataclasses
    at = _at()
    plan = plan_mod.make_plan(at.meta, RANK, backend="cuda", device="cpu")
    bad = dataclasses.replace(plan, modes=tuple(
        dataclasses.replace(m, **{field: value}) if m.mode == 0 else m
        for m in plan.modes))
    store = tmp_path / "plans.json"
    key = autotune.plan_key(at.meta, RANK, "cuda", device="cpu")
    autotune.save_store({key: autotune.serialize_plan(bad)}, store)
    assert key in autotune.load_store(store)
    with pytest.raises(ValueError, match=field):
        autotune.deserialize_plan(autotune.load_store(store)[key], at.meta)
    assert autotune.lookup(at.meta, RANK, backend="cuda", device="cpu",
                           path=store) is None
    got = plan_mod.make_plan(at.meta, RANK, backend="cuda", device="cpu",
                             tune="auto", store_path=store)
    assert got == plan
    views = plan_mod.build_views(at, got)
    fs = cpals.init_factors(at.dims, RANK, device="cpu")
    plan_mod.execute_mttkrp(got, at, views, fs, 0)


def test_ops_exec_fires_on_every_in_core_call():
    at = _at()
    fs = cpals.init_factors(at.dims, RANK, device="cpu")
    view = alto.oriented_view_device(at, 0)
    B = fs[0].abs() + 0.1
    calls = [lambda: ops.mttkrp(at, fs, 0),
             lambda: ops.mttkrp_oriented(view, fs, block_m=8),
             lambda: ops.mttkrp_oriented_carry(view, fs, block_m=8),
             lambda: ops.cpapr_phi(at, B, 0, factors=fs),
             lambda: ops.cpapr_phi_oriented(view, B, factors=fs, block_m=8),
             lambda: ops.cpapr_phi_oriented_carry(view, B, factors=fs,
                                                  block_m=8)]
    for call in calls:
        clean = call()
        with faults.injected("ops.exec"):
            with pytest.raises(faults.InjectedDispatchError):
                call()
        assert torch.equal(call(), clean)          # once: then quiet
    assert faults.fired()["ops.exec"] == len(calls)


@pytest.mark.parametrize("which", ["carry", "phi", "carry_ref", "phi_ref"])
def test_chunk_sites_fire_per_chunk(which):
    at = _at(seed=3, nnz=120)
    fs = cpals.init_factors(at.dims, RANK, device="cpu")
    hs = stream_mod.host_stream(at, 0)
    B = fs[0].abs() + 0.1
    run = {"carry": lambda: ops.mttkrp_oriented_chunked(
               hs, fs, chunk_m=16, block_m=8),
           "phi": lambda: ops.cpapr_phi_oriented_chunked(
               hs, B, fs, pre=True, chunk_m=16, block_m=8),
           "carry_ref": lambda: ops.mttkrp_oriented_chunked_reference(
               hs, fs, chunk_m=16),
           "phi_ref": lambda: ops.cpapr_phi_oriented_chunked_reference(
               hs, B, fs, pre=False, chunk_m=16)}[which]
    clean = run()
    # the third chunk's launch fails; the retry is bit for bit the clean run
    with faults.injected("ops.chunk_oom", after=2):
        with pytest.raises(torch.OutOfMemoryError):
            run()
    with faults.injected("stream.chunk_io", after=1):
        with pytest.raises(OSError):
            run()
    assert torch.equal(run(), clean)
    assert faults.fired() == {"ops.chunk_oom": 1, "stream.chunk_io": 1}


def test_views_build_fails_the_build_not_the_cache():
    views_mod.cache_clear()
    at = _at(seed=5)
    with faults.injected("views.build"):
        with pytest.raises(OSError):
            views_mod.get_view(at, 1)
        assert views_mod.cache_stats()["builds"] == 1
    v = views_mod.get_view(at, 1)                     # the next caller builds
    assert torch.equal(v.rows, alto.oriented_view_device(at, 1).rows)
    with faults.injected("views.build"):
        with pytest.raises(OSError):
            views_mod.get_stream(at, 1)
    assert views_mod.get_stream(at, 1).length == at.words.shape[0]


def test_autotune_store_corruption_is_a_miss(tmp_path):
    path = tmp_path / "plans.json"
    autotune.save_store({"k": {"x": 1}}, path)
    assert autotune.load_store(path) == {"k": {"x": 1}}
    with faults.injected("autotune.store"):
        assert autotune.load_store(path) == {}
    assert autotune.load_store(path) == {"k": {"x": 1}}


def test_ingest_merge_interrupt_leaves_the_resident_tensor():
    at = _at(seed=6)
    words, values = at.words.clone(), at.values.clone()
    coords = np.array([[1, 2, 3], [8, 6, 4]], np.int32)
    with faults.injected("ingest.merge"):
        with pytest.raises(faults.InjectedInterrupt):
            ingest.append_delta(at, coords, [1.0, 2.0])
    assert torch.equal(at.words, words) and torch.equal(at.values, values)
    grown = ingest.append_delta(at, coords, [1.0, 2.0])
    assert grown.meta.nnz == at.meta.nnz + 2
    assert alto.device_ingest_traces()["merge"] >= 1
