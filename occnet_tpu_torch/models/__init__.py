"""PyTorch modules of the port, named after their `occnet_tpu.models`
counterparts."""
