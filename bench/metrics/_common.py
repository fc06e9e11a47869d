"""Helpers the readers share: device seconds per iteration of a traced
run, read only in cells whose end-to-end metric is ``metric``."""
from __future__ import annotations

from bench.tracing import SOLVE


def per_iteration_s(reading, metric: str, span: str):
    """Device seconds per iteration launched inside ``span`` (the
    innermost span), or None outside cells of ``metric`` or when the
    traced window ran nothing on the device."""
    t = reading.trace
    if (reading.metric != metric or t is None or t.busy_s <= 0.0
            or reading.iterations <= 0 or span not in t.span_busy_s):
        return None
    return t.span_busy_s[span] / reading.iterations


def roofline_pct(reading, metric: str, span: str):
    """The roofline's least time of an iteration's sparse kernels over
    their device time, in %, or None where that time was not read."""
    s = per_iteration_s(reading, metric, span)
    if not s:
        return None
    return 100.0 * reading.bound_s / s


def idle_pct(reading, metric: str):
    """The share of the traced window in which the device ran nothing."""
    t = reading.trace
    if reading.metric != metric or t is None or t.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
