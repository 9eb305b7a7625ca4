"""Utilities of the port: `torch_convert` (reference PyTorch checkpoints
into the port's state_dict), `events` (the metrics.jsonl writer) and
`profiling` (device sync, latency decorator, torch.profiler traces)."""
