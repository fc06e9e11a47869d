"""Device time of kernels found by name in a traced window's top device
operations (`bench.tracing.TraceSummary.device_ops`, the `bench.tracing.
TOP` longest by name: a kernel outside them is not seen).

The harness attributes device time only to its own spans around the solve
loop's entries (`bench.tracing.Spans`), so a kernel inside one of them is
read by its name. Once the harness reads the port's own spans
(`bench.port_trace`), K7's and the pull's readers move to the spans
``repro.phi.partials`` and ``repro.phi.pull``."""
from __future__ import annotations


def ran(reading, name: str) -> bool:
    """Whether an operation whose name holds ``name`` is among the traced
    window's top device operations."""
    t = reading.trace
    return t is not None and any(name in n for n, _ in t.device_ops)


def per_iteration_ms(reading, metric: str, name: str):
    """Device ms per iteration of the operations whose name holds
    ``name``, or None outside cells of ``metric`` or where none ran."""
    t = reading.trace
    if (reading.metric != metric or t is None or t.busy_s <= 0.0
            or reading.iterations <= 0 or not ran(reading, name)):
        return None
    s = sum(sec for n, sec in t.device_ops if name in n)
    return 1e3 * s / reading.iterations
