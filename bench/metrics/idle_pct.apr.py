"""The share of the traced window in which no kernel or copy ran, in a
CP-APR cell (a union of device intervals)."""
from bench.metrics import _common

UNIT = "%"


def read(reading):
    return _common.idle_pct(reading, "apr_outer_ms")
