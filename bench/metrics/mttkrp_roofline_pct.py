"""The roofline's least time of a CP-ALS iteration's N MTTKRPs
(`bench.roofline`) over their device time (`mttkrp_ms`), in %."""
from bench.metrics import _common

UNIT = "%"


def read(reading):
    return _common.roofline_pct(reading, "als_iter_ms", "bench.mttkrp")
