"""Ops of the port, each a CUDA kernel (`csrc/`) with a plain PyTorch
version beside it: the planar lift and the TSA tap attention, forward and
backward (dense encoder), and multi-scale deformable attention (gather
encoder, forward); plus the grid mask."""
