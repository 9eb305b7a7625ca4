"""Command-line entry points of the port
(`python -m occnet_tpu_torch.tools.train`)."""
