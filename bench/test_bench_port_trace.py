"""The reduction of the port's own spans (`bench.port_trace`) and its
metrics: a hand-built trace, traced CPU runs that count the port's reads
exactly, and a program without the spans, whose traced run reads as
before."""
import contextlib
import json
import time

import pytest

from bench import harness, port_trace, tracing

NEW = {"fit_ms", "pi_build_ms", "read_idle_pct.als", "read_idle_pct.apr",
       "reads_per_iter.als", "reads_per_iter.apr"}


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace(tmp_path, port_spans=True):
    """A window of 1000 µs. The host: ``repro.mttkrp`` [100, 340] holding
    ``repro.read.pinv`` [150, 200], then ``repro.read.kkt`` [400, 450].
    The device: two kernels launched inside the MTTKRP span overlap on
    two streams, one launched in the read, one outside every span, and a
    copy with no launch event. Idle: [0, 130], [280, 360] (in MTTKRP, no
    read ends there) and [440, 1000] (holds the KKT read's end)."""
    ev = [_x("user_annotation", tracing.WINDOW, 0, 1000),
          _x("user_annotation", tracing.SOLVE, 50, 900),
          _x("cpu_op", "aten::mm", 110, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 126, 5, correlation=4),
          _x("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 350, 5, correlation=3),
          _x("kernel", "k1", 130, 120, correlation=1, stream=7),
          _x("kernel", "k4", 200, 60, correlation=4, stream=8),
          _x("kernel", "k2", 260, 20, correlation=2, stream=7),
          _x("kernel", "k3", 360, 60, correlation=3, stream=7),
          _x("gpu_memcpy", "Memcpy DtoH", 420, 20, correlation=9)]
    if port_spans:
        ev += [_x("user_annotation", "repro.mttkrp", 100, 240),
               _x("user_annotation", "repro.read.pinv", 150, 50),
               _x("user_annotation", "repro.read.kkt", 400, 50),
               _x("user_annotation", "repro.read.kkt", 1200, 50)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_reduce_attributes_to_the_innermost_span(tmp_path):
    s = port_trace.reduce(_trace(tmp_path))
    assert s.window_s == pytest.approx(1000e-6)
    # The span after the window is left out.
    assert s.calls == {"repro.mttkrp": 1, "repro.read.pinv": 1,
                       "repro.read.kkt": 1}
    assert s.reads == 2
    # k1 and k4 overlap on two streams: their union, 130 µs, not 180.
    assert s.device_s == pytest.approx({
        "repro.mttkrp": 130e-6, "repro.read.pinv": 20e-6,
        port_trace.OUTSIDE: 80e-6})
    assert s.self_s == pytest.approx({
        "repro.mttkrp": 190e-6, "repro.read.pinv": 50e-6,
        "repro.read.kkt": 50e-6})
    assert s.idle_s == pytest.approx({
        port_trace.OUTSIDE: 690e-6, "repro.mttkrp": 80e-6})
    # [440, 1000] holds the KKT read's end, [280, 360] no read's end.
    assert s.read_idle_s == pytest.approx(560e-6)
    rows = s.breakdown()
    assert rows[0][:2] == ["repro.mttkrp", 1]
    assert rows[-1][0] == port_trace.OUTSIDE


def test_the_port_spans_move_no_existing_attribution(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    spans = ["bench.mttkrp"]
    with_port = tracing.reduce_chrome_trace(_trace(tmp_path / "a"), spans)
    without = tracing.reduce_chrome_trace(
        _trace(tmp_path / "b", port_spans=False), spans)
    assert with_port.busy_s == without.busy_s
    assert with_port.span_busy_s == without.span_busy_s
    assert with_port.device_ops == without.device_ops


def test_a_trace_without_port_spans_gives_none(tmp_path):
    path = _trace(tmp_path, port_spans=False)
    assert port_trace.reduce(path) is None
    summary = tracing.reduce_chrome_trace(path, [])
    assert summary.busy_s > 0
    for metric in ("als_iter_ms", "apr_outer_ms"):
        assert port_trace.metrics(None, metric, 5, summary.busy_s) == {}


def test_metrics_read_the_summary(tmp_path):
    s = port_trace.reduce(_trace(tmp_path))
    s.calls["repro.cpals.fit"] = 2
    s.device_s["repro.cpals.fit"] = 0.004
    assert port_trace.metrics(s, "als_iter_ms", 4, 1e-4) == pytest.approx({
        "reads_per_iter.als": 0.5, "read_idle_pct.als": 56.0,
        "fit_ms": 1.0})
    # No device work: only the count. No Π build: no pi_build_ms.
    assert port_trace.metrics(s, "apr_outer_ms", 2, 0.0) == {
        "reads_per_iter.apr": 1.0}
    assert set(port_trace.metrics(s, "apr_outer_ms", 2, 1e-4)) == {
        "reads_per_iter.apr", "read_idle_pct.apr"}


def _traced(cell):
    return port_trace.traced_run(cell, 2**31 + 29, 0.2, "cpu",
                                 time.perf_counter())


@pytest.mark.parametrize("name", ["darpa1998.cp_als",
                                  "chicago-crime-comm.cp_apr"])
def test_traced_run_counts_the_reads(small_cell, name):
    cell = small_cell(name)
    t = cell.traffic
    N = len(cell.config["dims"])
    out = _traced(cell)
    assert out["correct"] is True
    if t["algorithm"] == "cp_als":
        # A pinv a mode update, a fit an iteration, the norm once a solve.
        metric, expect = "reads_per_iter.als", N + (t["n_iters"] + 1) / \
            t["n_iters"]
    else:
        # tau 0: N × l_max KKT reads an outer iteration, the shift's
        # scalars once a mode update after the first outer iteration, the
        # total once a solve.
        k = t["k_max"]
        metric, expect = "reads_per_iter.apr", N * t["l_max"] + \
            (N * (k - 1) + 1) / k
    assert out["port"] == {metric: pytest.approx(expect, rel=1e-12)}
    assert not NEW & set(out["metrics"])     # not the benchmark's own
    assert "port_spans" in out["breakdown"]


def test_a_program_without_spans_reads_as_before(small_cell, monkeypatch):
    from repro_torch import trace
    cell = small_cell("darpa1998.cp_als")
    full = _traced(cell)
    monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())
    out = _traced(cell)
    assert out["port"] == {}
    assert out["correct"] is True
    assert set(out["metrics"]) == set(full["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # The benchmark's own traced run is left as it was.
    plain = harness.run_cell(cell, 2**31 + 29, 0.2, True, "cpu",
                             time.perf_counter())
    assert set(plain) == set(out) - {"port"}
    assert set(plain["metrics"]) == set(out["metrics"])
