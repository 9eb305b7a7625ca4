"""Ops of the port, each a CUDA kernel (`csrc/`) with a plain PyTorch
version beside it: the planar lift (its geometry, and the sampling forward
and backward) and the TSA tap attention, forward and backward (dense
encoder), multi-scale deformable attention (gather encoder,
forward and backward) and the DCNv2 sampling of the R101-DCN trunk (forward
and backward, with the window certificate in `dcn_window`), the two ray
marchers (`ray_march`, `ray_march_vec`; `ray_march_fast` runs the fan
kernel for one origin); plus the grid mask and the plain-PyTorch modules
of XLA functions (`render_diff`, `transforms`)."""
