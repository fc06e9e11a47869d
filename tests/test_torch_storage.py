"""Port parity: storage accounting, the view build route and `put_chunk`.

* `plan.resident_bytes` equals the JAX package's integer for the same
  tensor, without views, with every mode's view and with the views of
  the plan's oriented modes, and skips a `HostStream` (host memory).
* ``route="host"`` (`alto.oriented_view`) and ``route="device"``
  (`alto.oriented_view_device`) give the same view bit for bit, each the
  JAX package's; the cache ignores the route; ``$REPRO_INGEST`` picks the
  default, and any value but "device" or "host" raises.
* `stream.put_chunk` returns ``hs.chunk``'s tensors on the CPU and fires
  the ``stream.chunk_io`` site once a call.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro.core import alto as jalto
from repro.core import plan as jplan
from repro.core import views as jviews
from repro.sparse import synthetic as jsyn
from repro_torch.core import alto as talto
from repro_torch.core import faults
from repro_torch.core import heuristics as theur
from repro_torch.core import plan as tplan
from repro_torch.core import stream as tstream
from repro_torch.core import views as tviews
from repro_torch.sparse import synthetic as tsyn

TENSORS = {
    "blocked": ("blocked_tensor", (30, 24, 20), 900,
                dict(block=6, n_blocks=6, count_data=True)),
    "uniform4": ("uniform_tensor", (40, 30, 20, 12), 1200, {}),
    "hyper": ("uniform_tensor", (2**12, 2**11, 2**13), 1500, {}),
}


def _pair(name):
    gen, dims, nnz, kw = TENSORS[name]
    jat = jalto.build(getattr(jsyn, gen)(dims, nnz, seed=4, **kw),
                      n_partitions=8)
    at = talto.build_device(getattr(tsyn, gen)(dims, nnz, seed=4, **kw),
                            n_partitions=8, device="cpu")
    return jat, at


@pytest.fixture(autouse=True)
def _clean():
    tviews.cache_clear()
    faults.reset()
    yield
    tviews.cache_clear()
    faults.reset()


@pytest.mark.parametrize("name", list(TENSORS))
def test_resident_bytes_equal_jax(name):
    jat, at = _pair(name)
    assert tplan.resident_bytes(at) == jplan.resident_bytes(jat)
    every = {m: talto.oriented_view(at, m) for m in range(len(at.dims))}
    jevery = {m: jalto.oriented_view(jat, m) for m in range(len(at.dims))}
    assert tplan.resident_bytes(at, every) == \
        jplan.resident_bytes(jat, jevery)
    # the static plans route the same modes oriented, so the plans' views
    # hold the same bytes
    p = tplan.make_plan(at.meta, 16, backend="cuda")
    jp = jplan.make_plan(jat.meta, 16, backend="pallas", interpret=True)
    assert p.traversals() == jp.traversals()
    views = tplan.build_views(at, p)
    jv = jplan.build_views(jat, jp)
    assert sorted(views) == sorted(jv)
    assert tplan.resident_bytes(at, views) == jplan.resident_bytes(jat, jv)
    jviews.cache_clear()
    assert tcore.resident_bytes is tplan.resident_bytes


def test_resident_bytes_skip_host_streams():
    _, at = _pair("blocked")
    hs = tstream.host_stream(at, 0)
    v = talto.oriented_view(at, 1)
    base = tplan.resident_bytes(at)
    assert tplan.resident_bytes(at, {0: hs}) == base
    assert tplan.resident_bytes(at, {0: hs, 1: v}) == \
        base + sum(t.numel() * t.element_size()
                   for t in (v.rows, v.words, v.values, v.perm))


def _same_view(a, b) -> None:
    for f in ("rows", "words", "values", "perm"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.mode == b.mode and a.meta == b.meta


@pytest.mark.parametrize("name", list(TENSORS))
def test_routes_bitwise_and_jax(name):
    jat, at = _pair(name)
    for mode in range(len(at.dims)):
        host = talto.oriented_view(at, mode)
        dev = talto.oriented_view_device(at, mode)
        _same_view(host, dev)
        ref = jalto.oriented_view(jat, mode)
        np.testing.assert_array_equal(host.rows.numpy(),
                                      np.asarray(ref.rows))
        np.testing.assert_array_equal(host.words.numpy().view(np.uint32),
                                      np.asarray(ref.words))
        np.testing.assert_array_equal(host.values.numpy(),
                                      np.asarray(ref.values))
        np.testing.assert_array_equal(host.perm.numpy(),
                                      np.asarray(ref.perm))
        # through the cache: a host-route miss, then a device-route hit on
        # the same entry (the key ignores the route)
        got = tviews.get_view(at, mode, route="host")
        _same_view(got, dev)
        assert tviews.get_view(at, mode, route="device") is got
    st = tviews.cache_stats()
    assert st["builds"] == len(at.dims) and st["hits"] == len(at.dims)


def _counting(monkeypatch):
    calls = {"host": 0, "device": 0}
    host, dev = talto.oriented_view, talto.oriented_view_device

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(talto, "oriented_view", count("host", host))
    monkeypatch.setattr(talto, "oriented_view_device",
                        count("device", dev))
    return calls


@pytest.mark.parametrize("env,expect", [(None, "device"),
                                        ("device", "device"),
                                        ("host", "host")])
def test_repro_ingest_picks_the_route(monkeypatch, env, expect):
    if env is None:
        monkeypatch.delenv("REPRO_INGEST", raising=False)
    else:
        monkeypatch.setenv("REPRO_INGEST", env)
    assert tviews.default_route() == expect
    calls = _counting(monkeypatch)
    _, at = _pair("blocked")
    p = tplan.make_plan(at.meta, 16, backend="cuda")
    views = tplan.build_views(at, p)
    n = sum(theur.is_oriented(m.traversal) for m in p.modes)
    assert len(views) == n > 0
    assert calls[expect] == n and sum(calls.values()) == n
    # an explicit route beats the variable
    tviews.cache_clear()
    other = "host" if expect == "device" else "device"
    tplan.build_views(at, p, route=other)
    assert calls[other] == n


@pytest.mark.parametrize("bad", ["gpu", "", "Host"])
def test_repro_ingest_bad_value_raises(monkeypatch, bad):
    monkeypatch.setenv("REPRO_INGEST", bad)
    with pytest.raises(ValueError, match="REPRO_INGEST"):
        tviews.default_route()
    _, at = _pair("blocked")
    with pytest.raises(ValueError, match="REPRO_INGEST"):
        tviews.get_view(at, 0)
    assert tviews.get_view(at, 0, route="host").mode == 0


def test_put_chunk_returns_the_chunk_and_fires_once():
    _, at = _pair("uniform4")
    hs = tstream.host_stream(at, 1)
    for start, stop in ((0, 256), (256, 1024), (1000, hs.rows.shape[0])):
        got = tstream.put_chunk(hs, start, stop, device="cpu")
        for a, b in zip(got, hs.chunk(start, stop)):
            assert a.device.type == "cpu"
            assert a.data_ptr() == b.data_ptr() and torch.equal(a, b)
    assert faults.fired() == {}
    # armed after one pass: the first call injects and passes, the second
    # fires — one injection a call
    with faults.injected("stream.chunk_io", after=1):
        tstream.put_chunk(hs, 0, 256, device="cpu")
        with pytest.raises(OSError):
            tstream.put_chunk(hs, 256, 512, device="cpu")
    assert faults.fired() == {"stream.chunk_io": 1}


def test_put_chunk_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    _, at = _pair("blocked")
    hs = tstream.host_stream(at, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstream.put_chunk(hs, 0, 256)
