"""Ops of the port, each a CUDA kernel (`csrc/`) with a plain PyTorch
version beside it: the planar lift and the TSA tap attention, forward and
backward (dense encoder), multi-scale deformable attention (gather encoder,
forward and backward) and the DCNv2 sampling of the R101-DCN trunk (forward
and backward, with the window certificate in `dcn_window`); plus the grid
mask."""
