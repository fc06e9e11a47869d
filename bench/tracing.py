"""Spans around the port's entry points, and the reduction of a profiler
trace to device time per span.

`Spans` wraps named functions of the port's modules in
`torch.profiler.record_function` for the traced window only, and counts
their calls. A missing entry, or one never called in the traced window,
raises `TraceError` naming it: a per-layer metric is never read off a span
that did not run.

`reduce_chrome_trace` reads the trace that `torch.profiler` exports. Each
device operation (kernel, copy, memset) is attributed to the innermost
span open on the host when it was launched, found through the launch's
correlation id. Device time is a union of intervals, so operations that
overlap on two streams are counted once.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import importlib
import json

import torch

WINDOW = "bench.window"
SOLVE = "bench.solve"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
GAP_LABEL_LOOKBACK = 256


class TraceError(RuntimeError):
    """A wrapped entry is missing or was never called."""


class Spans:
    """Wraps ``entries`` ({span name: (module name, attribute)}) in
    `record_function` while installed."""

    def __init__(self, entries: dict[str, tuple[str, str]]):
        self.entries = dict(entries)
        self.calls = dict.fromkeys(self.entries, 0)
        self._saved: list[tuple[object, str, object]] = []

    def _wrap(self, span: str, fn):
        def wrapped(*args, **kwargs):
            self.calls[span] += 1
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)
        return wrapped

    def install(self) -> None:
        for span, (mod_name, attr) in self.entries.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if not callable(fn):
                self.uninstall()
                raise TraceError(f"traced entry {mod_name}.{attr} is missing")
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(span, fn))

    def uninstall(self) -> None:
        while self._saved:
            mod, attr, fn = self._saved.pop()
            setattr(mod, attr, fn)

    def check_called(self) -> None:
        for span, n in self.calls.items():
            if n == 0:
                mod_name, attr = self.entries[span]
                raise TraceError(f"traced entry {mod_name}.{attr} was never "
                                 f"called in the traced window")

    @contextlib.contextmanager
    def installed(self):
        self.install()
        try:
            yield self
        finally:
            self.uninstall()


def _union(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


@dataclasses.dataclass
class TraceSummary:
    """Seconds on the host clock of the traced window and of device work
    in it, in total and by the innermost span that launched it."""
    window_s: float
    busy_s: float
    span_busy_s: dict[str, float]
    device_ops: list[tuple[str, float]]
    idle_gaps: list[tuple[str, float]]

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}


def _innermost(starts, spans, t):
    """The shortest of the last `GAP_LABEL_LOOKBACK` events of ``spans``
    (sorted by start) to start before t that contains t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 1 - GAP_LABEL_LOOKBACK), -1):
        s, e, name = spans[j]
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best


def _containing(starts, spans, t) -> bool:
    """Whether one of ``spans`` (disjoint, sorted by start) contains t."""
    i = bisect.bisect_right(starts, t)
    return i > 0 and spans[i - 1][0] <= t <= spans[i - 1][1]


def reduce_chrome_trace(path, span_names) -> TraceSummary:
    """Reduce the exported trace at ``path``; ``span_names`` are the spans
    to attribute device time to (besides `SOLVE`)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    inner = list(span_names)
    names = set(inner) | {SOLVE}
    window = None
    spans = collections.defaultdict(list)
    launch_ts = {}
    device = []
    host = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if ev["name"] == WINDOW:
                window = (ts, ts + dur)
            elif ev["name"] in names:
                spans[ev["name"]].append((ts, ts + dur))
        if cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev["name"],
                           ev.get("args", {}).get("correlation")))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, ev["name"]))
    if window is None:
        raise TraceError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    # Spans of one name never nest; an inner span lies inside a solve.
    order = inner + [SOLVE]
    for n in order:
        spans[n].sort()
    starts = {n: [s for s, _ in spans[n]] for n in order}
    by_span = collections.defaultdict(list)
    by_name = collections.Counter()
    inside = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        by_name[name[:120]] += (e - s) * 1e-6
        t = launch_ts.get(corr)
        owner = None
        if t is not None:
            owner = next((n for n in order
                          if _containing(starts[n], spans[n], t)), None)
        by_span[owner].append((s, e))
    busy = _union(inside)
    span_busy = {n: _union(by_span.get(n, [])) * 1e-6 for n in names}
    # Idle gaps between device work, labelled by the innermost host event
    # open at each gap's middle.
    host.sort()
    host_starts = [s for s, _, _ in host]
    gaps = collections.Counter()
    edge = w0
    for s, e in sorted(inside) + [(w1, w1)]:
        if s > edge:
            hit = _innermost(host_starts, host, 0.5 * (s + edge))
            label = hit[2][:120] if hit else "(between host ops)"
            gaps[label] += (s - edge) * 1e-6
        edge = max(edge, e)
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        span_busy_s=span_busy,
                        device_ops=by_name.most_common(TOP),
                        idle_gaps=gaps.most_common(TOP))
