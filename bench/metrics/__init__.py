"""One reader per per-layer metric, ``<metric>.py``, found by its file
name (`bench.harness.metric_readers`). A reader defines ``UNIT`` and
``read(reading)``, which takes a `bench.harness.Reading` and returns the
metric's value, or None where the run has nothing to read for it (the
harness then leaves the metric out). A share of a roofline is never
returned as 0."""
