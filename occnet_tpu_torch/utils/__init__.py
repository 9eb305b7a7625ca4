"""Utilities of the port: `torch_convert` (reference PyTorch checkpoints
into the port's state_dict), `events` (the metrics.jsonl writer),
`profiling` (the program's spans and counters, device sync,
torch.profiler traces) and
`vis` (occupancy images; matplotlib imported only by the functions that
draw).  The JAX package's `utils/cache.py` (XLA's persistent compilation
cache) has no counterpart module: the port's compiled kernels are cached by
`ops/_build.py` in `csrc/build/`, keyed by the sources' hash."""
