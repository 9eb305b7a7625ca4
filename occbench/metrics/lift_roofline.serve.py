"""The lift forward kernel's least time over its device time, %."""

from occbench import readers


def read(record):
    return readers.roofline(record, "serve", "lift_level_kernel", "lift",
                            readers.lift_cost)
