"""The synthetic token pipeline (`data.pipeline`)."""
