"""Seconds of the port's ALTO build (`alto.build_device`, linearize,
sort, partition) in set-up, host clock up to a synchronise."""
UNIT = "s"


def read(reading):
    return reading.setup["build_s"]
