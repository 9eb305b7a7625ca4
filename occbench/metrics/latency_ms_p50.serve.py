"""Median request latency of the traced run's window, ms (host clock)."""

from occbench import yardstick


def read(record):
    if record["kind"] != "serve":
        return None
    return yardstick.percentile(record["latency_ms"], 50)
