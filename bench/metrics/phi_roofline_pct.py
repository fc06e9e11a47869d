"""The roofline's least time of a CP-APR outer iteration's N × l_max Φ
evaluations (`bench.roofline`) over their device time (`phi_ms`), in %."""
from bench.metrics import _common

UNIT = "%"


def read(reading):
    return _common.roofline_pct(reading, "apr_outer_ms", "bench.phi")
