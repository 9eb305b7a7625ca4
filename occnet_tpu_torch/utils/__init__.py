"""Utilities of the port (`torch_convert`: reference PyTorch checkpoints
into the port's state_dict)."""
