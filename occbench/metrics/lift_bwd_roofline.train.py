"""The lift backward kernel's least time over its device time, %."""

from occbench import readers


def read(record):
    return readers.roofline(record, "train", "lift_bwd_kernel", "lift_bwd",
                            readers.lift_bwd_cost)
