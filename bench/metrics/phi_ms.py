"""Device ms per CP-APR outer iteration of the operations launched inside
the Φ spans (`plan.execute_phi`)."""
from bench.metrics import _common

UNIT = "ms"


def read(reading):
    s = _common.per_iteration_s(reading, "apr_outer_ms", "bench.phi")
    return None if s is None else 1e3 * s
