"""The served requests' bf16 matrix operations over the window time at the
card's 989 TFLOP/s bf16 peak, %."""

from occbench import readers


def read(record):
    return readers.mfu(record, "serve")
