"""The port's own spans in an exported profiler trace.

    PYTHONPATH=src python3 -m bench.port_trace --workload <cell> \
        --seed <n> --seconds <s>

The port marks its layers with ``repro.*`` spans (`repro_torch.trace`)
whenever a profiler records; a span named ``repro.read.*`` wraps a call
that blocks the host on the device. `reduce` reads the trace that
`bench.tracing.reduce_chrome_trace` reads, a second time, for those spans
alone, inside the harness's window span:

* per span name: its calls; the device seconds of the kernels, copies and
  memsets launched while it was the innermost open ``repro.`` span (found
  through the launch's correlation id, a union of intervals); its host
  self time (its duration less its child ``repro.`` spans');
* the device's idle gaps, by the innermost ``repro.`` span open at each
  gap's middle;
* ``read_idle_s``: the idle gaps that contain the end of a
  ``repro.read.*`` span, where the device finished, the host came back
  from its read and the device waited for the next launch;
* ``reads``: the ``repro.read.*`` spans.

A trace with no ``repro.`` span (a program without them) gives None.
`metrics` turns a summary into per-layer numbers of a cell. The command
line runs a cell's traced run (`traced_run`, the harness's `run_cell` on
the card) and prints its result line with those numbers under ``port``
and the spans under ``breakdown.port_spans``. The benchmark's own runs
(`bench/run.py`) do not read the port's spans.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import sys
import time

from bench.tracing import DEVICE_CATS, LAUNCH_CATS, WINDOW, _union

PREFIX = "repro."
READ = PREFIX + "read."
OUTSIDE = "(no port span)"


@dataclasses.dataclass
class PortSummary:
    """Seconds on the host clock of the traced window, by port span."""
    window_s: float
    calls: dict[str, int]
    device_s: dict[str, float]      # OUTSIDE: launched outside every span
    self_s: dict[str, float]
    idle_s: dict[str, float]        # OUTSIDE: gap middles outside them
    read_idle_s: float
    reads: int

    def breakdown(self) -> list:
        """[name, calls, device s, host self s, idle s] per span, by
        device seconds, the ops launched outside every span last."""
        names = sorted(self.calls, key=lambda n: -self.device_s.get(n, 0.0))
        rows = [[n, self.calls[n], self.device_s.get(n, 0.0),
                 self.self_s[n], self.idle_s.get(n, 0.0)] for n in names]
        return rows + [[OUTSIDE, 0, self.device_s.get(OUTSIDE, 0.0), 0.0,
                        self.idle_s.get(OUTSIDE, 0.0)]]


def _innermost(spans, times):
    """For each of ``times`` (ascending), the index into ``spans`` (nested
    or disjoint intervals ``(start, end, name)``, sorted by start and then
    longest first) of the innermost one that contains it, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][1]:
                stack.pop()           # those that do not contain span i
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def reduce(path) -> PortSummary | None:
    """Reduce the exported trace at ``path`` to the port's spans."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    spans, launch_ts, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if ev["name"] == WINDOW:
                window = (ts, ts + dur)
            elif ev["name"].startswith(PREFIX):
                spans.append((ts, ts + dur, ev["name"]))
        if cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur,
                           ev.get("args", {}).get("correlation")))
    if window is None:
        return None
    w0, w1 = window
    spans = sorted((s for s in spans if w0 <= s[0] <= w1),
                   key=lambda s: (s[0], s[0] - s[1]))
    if not spans:
        return None
    calls, self_us, open_ = {}, {}, []
    for s, e, name in spans:
        calls[name] = calls.get(name, 0) + 1
        self_us[name] = self_us.get(name, 0.0) + (e - s)
        while open_ and open_[-1][1] < e:
            open_.pop()
        if open_:                      # the span's parent
            self_us[open_[-1][2]] -= e - s
        open_.append((s, e, name))

    # Device ops in the window, by the innermost span open at launch.
    inside, owned = [], []
    for s, e, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            inside.append((s, e))
            owned.append((launch_ts.get(corr), s, e))
    launched = sorted((t, s, e) for t, s, e in owned if t is not None)
    by_span = {}
    for (t, s, e), k in zip(launched,
                            _innermost(spans, [t for t, _, _ in launched])):
        name = OUTSIDE if k is None else spans[k][2]
        by_span.setdefault(name, []).append((s, e))
    for t, s, e in owned:
        if t is None:
            by_span.setdefault(OUTSIDE, []).append((s, e))

    # Idle gaps of the window, labelled at their middles.
    gaps, edge = [], w0
    for s, e in sorted(inside) + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle = {}
    for (g0, g1), k in zip(gaps, _innermost(
            spans, [0.5 * (g0 + g1) for g0, g1 in gaps])):
        name = OUTSIDE if k is None else spans[k][2]
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    read_ends = sorted(e for _, e, n in spans if n.startswith(READ))
    read_idle = sum(g1 - g0 for g0, g1 in gaps
                    if bisect.bisect_left(read_ends, g0)
                    < bisect.bisect_right(read_ends, g1))
    return PortSummary(
        window_s=(w1 - w0) * 1e-6, calls=calls,
        device_s={n: _union(iv) * 1e-6 for n, iv in by_span.items()},
        self_s={n: us * 1e-6 for n, us in self_us.items()},
        idle_s=idle, read_idle_s=read_idle * 1e-6,
        reads=sum(n for name, n in calls.items() if name.startswith(READ)))


# {the cell's rate metric: (suffix of its metrics, span its device ms
# is read from, that metric's name)}
_CELLS = {"als_iter_ms": ("als", PREFIX + "cpals.fit", "fit_ms"),
          "apr_outer_ms": ("apr", PREFIX + "cpapr.pi_build", "pi_build_ms")}


def metrics(port: PortSummary | None, metric: str, iterations: int,
            busy_s: float) -> dict[str, float]:
    """The per-layer numbers of a traced window of ``iterations`` (outer)
    iterations in a cell whose rate metric is ``metric``:

    * ``reads_per_iter.<als|apr>``: ``repro.read.*`` spans an iteration;
    * ``read_idle_pct.<als|apr>``: the window's share, in %, in idle gaps
      that hold a read's end;
    * ``fit_ms`` (CP-ALS) or ``pi_build_ms`` (CP-APR): device ms an
      iteration launched inside ``repro.cpals.fit`` or
      ``repro.cpapr.pi_build``, where that span ran.

    Device numbers are left out where the window ran nothing on the
    device, and everything where the trace held no port span."""
    if port is None or iterations <= 0:
        return {}
    tag, span, name = _CELLS[metric]
    out = {f"reads_per_iter.{tag}": port.reads / iterations}
    if busy_s > 0:
        out[f"read_idle_pct.{tag}"] = 100.0 * port.read_idle_s / port.window_s
        if span in port.calls:
            out[name] = 1e3 * port.device_s.get(span, 0.0) / iterations
    return out


def traced_run(cell, seed: int, seconds: float, device: str,
               t0: float) -> dict:
    """`bench.harness.run_cell` traced, with the port's spans reduced from
    the trace its profiler exports: the result line's object gains
    ``port`` (`metrics`) and, where the trace held port spans,
    ``breakdown.port_spans``."""
    from bench import harness

    own, iterations = [], []
    stop = harness._Tracing.stop

    def stop_and_reduce(self):
        export = self.prof.export_chrome_trace

        def exported(path):
            export(path)
            own.append(reduce(path))
        self.prof.export_chrome_trace = exported
        summary = stop(self)
        iterations.append(self.iterations)
        return summary
    harness._Tracing.stop = stop_and_reduce
    try:
        out = harness.run_cell(cell, seed, seconds, True, device, t0)
    finally:
        harness._Tracing.stop = stop
    port = own[-1]
    out["port"] = metrics(port, cell.solver.METRIC, iterations[-1],
                          out["device"]["busy_s"])
    if port is not None:
        out["breakdown"]["port_spans"] = port.breakdown()
    return out


def main(argv=None) -> int:
    t0 = time.perf_counter()
    from bench import harness

    ap = argparse.ArgumentParser(description="Run one cell traced and "
                                 "reduce the port's own spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # One CPU core, as `bench/run.py` keeps a benchmark run to.
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    cell = harness.load_cell(args.workload)
    out = traced_run(cell, args.seed, args.seconds, args.device, t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
