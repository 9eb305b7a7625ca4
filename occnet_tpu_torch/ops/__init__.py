"""Ops of the port: the planar lift and the TSA tap attention, each a CUDA
kernel (`csrc/`) with a plain PyTorch version beside it."""
