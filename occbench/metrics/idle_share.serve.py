"""Share of the profiled sub-window in which no operation ran on the card,
%."""

from occbench import readers


def read(record):
    return readers.idle_share(record, "serve")
