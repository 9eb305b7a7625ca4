"""occnet_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of occnet_tpu.

The JAX package `occnet_tpu` is the reference; this package mirrors its module
names and reuses its jax-free config tree (`occnet_tpu.config`).  It imports
`torch` and never `jax`.  The serving entry point is `serve.Predictor`; the
training entry points are `training.make_train_step` and the CLI
`python -m occnet_tpu_torch.tools.train`.
"""
