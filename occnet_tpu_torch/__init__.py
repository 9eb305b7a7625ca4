"""occnet_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of occnet_tpu.

The JAX package `occnet_tpu` is the reference; this package mirrors its module
names and keeps its own copy of the config tree (`occnet_tpu_torch.config`).
It imports `torch`, never `jax`, and nothing of the JAX package.  The serving
entry point is `serve.Predictor` (dense `turbo_occ` and exact `base_occ`
encoders, on ResNet-50 or on ResNet-101-DCN: `turbo_r101_dcn_occ`,
`r101_dcn_occ`); the training entry points are `training.make_train_step`
and the CLI `python -m occnet_tpu_torch.tools.train`; a nuScenes / OpenOcc
data root is scored and submitted with `python -m
occnet_tpu_torch.tools.{test,ray_casting,metric}`, and the reference's
checkpoints are read by `utils.torch_convert`.
"""
