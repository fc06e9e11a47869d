"""Seconds of the port's static plan and oriented views
(`plan.plan_for`, `plan.build_views`) in set-up, host clock up to a
synchronise."""
UNIT = "s"


def read(reading):
    return reading.setup["views_s"]
