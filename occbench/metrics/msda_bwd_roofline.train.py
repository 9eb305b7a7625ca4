"""The MSDA backward kernel's least time over its device time, %."""

from occbench import readers, yardstick


def read(record):
    return readers.roofline(record, "train", "msda_bwd_kernel", "msda",
                            yardstick.msda_bwd_cost)
