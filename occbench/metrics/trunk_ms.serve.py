"""Median device time from the trunk's start to the FPN's end a request,
ms (CUDA events at forward hooks on `backbone` and `neck`)."""

from occbench import readers


def read(record):
    return readers.median_span(record, "serve", "trunk")
