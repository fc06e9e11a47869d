"""Device ms per CP-ALS iteration of the operations launched inside a
solve but outside the MTTKRP spans: Grams, pinv, normalisation, the fit."""
from bench.metrics import _common

UNIT = "ms"


def read(reading):
    s = _common.per_iteration_s(reading, "als_iter_ms", _common.SOLVE)
    return None if s is None else 1e3 * s
