"""The tap attention forward kernel's least time over its device time, %."""

from occbench import readers


def read(record):
    return readers.roofline(record, "serve", "tap_kernel", "tap",
                            readers.tap_cost)
