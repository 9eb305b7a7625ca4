"""Median device time of a step's backward phase, ms (CUDA events at the
step's own mark callbacks)."""

from occbench import readers


def read(record):
    return readers.median_span(record, "train", "bwd")
