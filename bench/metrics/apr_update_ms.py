"""Device ms per CP-APR outer iteration of the operations launched inside
a solve but outside the Φ spans: Π, the multiplicative update, the KKT."""
from bench.metrics import _common

UNIT = "ms"


def read(reading):
    s = _common.per_iteration_s(reading, "apr_outer_ms", _common.SOLVE)
    return None if s is None else 1e3 * s
