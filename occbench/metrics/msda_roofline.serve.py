"""The MSDA forward kernel's least time over its device time, %."""

from occbench import readers, yardstick


def read(record):
    return readers.roofline(record, "serve", "msda_kernel", "msda",
                            yardstick.msda_cost)
