"""Spans of the port on the profiler's clock.

``with trace.span("phi"):`` marks a region of the port's host code as
``repro.phi`` in the trace that a running `torch.profiler` records. The
event lands in the profiler's own trace, on the clock of its device
kernels and copies, so whoever profiles the port can put each device op
and each idle gap down to the port's layer that was running on the host.

When no profiler is recording, `span` returns one shared no-op context:
`torch.profiler.record_function` costs about 12 µs an enter and exit on
a CPU host even then, the check about 0.2 µs. There is no switch, store
or exporter.

By convention a span named ``read.<what>`` wraps a call that blocks the
host on the device: a value copied back (``.item()``, ``float``) or a
library call that synchronises.
"""
from __future__ import annotations

import contextlib

import torch

PREFIX = "repro."
_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("repro." + name)`` while a profiler records, else
    a no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)
