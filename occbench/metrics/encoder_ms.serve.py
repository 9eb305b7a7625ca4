"""Median device time of `TransformerOcc.get_bev_features` a request, ms
(CUDA events around it): the lift or the flattened pyramid, and the
encoder layers."""

from occbench import readers


def read(record):
    return readers.median_span(record, "serve", "encoder")
