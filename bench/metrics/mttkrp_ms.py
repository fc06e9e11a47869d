"""Device ms per CP-ALS iteration of the operations launched inside the
MTTKRP spans (`cpals.mttkrp_adaptive`)."""
from bench.metrics import _common

UNIT = "ms"


def read(reading):
    s = _common.per_iteration_s(reading, "als_iter_ms", "bench.mttkrp")
    return None if s is None else 1e3 * s
