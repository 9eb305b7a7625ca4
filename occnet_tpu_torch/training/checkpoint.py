"""Checkpoints of the port (counterpart of `occnet_tpu/training/
checkpoint.py`, with `torch.save` in place of orbax): step, model state_dict
(parameters and BN statistics), optimizer state, the config as JSON and an
environment record.

`save` / `restore` write and read one file.  `CheckpointManager` keeps the
last ``max_to_keep`` steps of a run in one directory, as the JAX package's
manager does: ``ckpt_<step>.pt`` files and ``ckpt.pt``, a link to the
newest.  Its `save` copies the state to the host before it returns (AdamW
then updates the parameters in place) and writes on a background thread;
a write is atomic (a reader never sees half a file) and durable before an
older checkpoint is deleted.  Under a process group rank 0 writes, `wait`
holds every rank at a barrier until the writes are done, and every rank
restores onto its own device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.parallel.multihost import barrier, process_shard
from occnet_tpu_torch.training.train import TrainState

LATEST = "ckpt.pt"
_STEP_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def _config_json(cfg: OccNetConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), default=str)


def env_meta() -> Dict[str, Any]:
    """The environment record of a checkpoint (`_env_meta` of the JAX
    package, the reference's env_info): time, host, python, torch, CUDA,
    device name and count, world size."""
    import platform
    import time
    cuda = torch.cuda.is_available()
    return {
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "hostname": platform.node(),
        "python": platform.python_version(),
        "torch": str(torch.__version__),
        "cuda": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "world_size": process_shard()[1],
    }


def _to_host(tree):
    """A copy of ``tree`` (dicts, lists, tensors, scalars) whose tensors are
    new CPU tensors, independent of the live state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def snapshot(state: TrainState, cfg: Optional[OccNetConfig]
             ) -> Dict[str, Any]:
    """The checkpoint payload, copied to the host."""
    payload = {"step": state.step,
               "model": _to_host(state.model.state_dict()),
               "optimizer": _to_host(state.optimizer.state_dict()),
               "env": env_meta()}
    if cfg is not None:
        payload["config"] = _config_json(cfg)
    return payload


def write(path: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path`` atomically and durably (a temporary
    file, fsync, rename, fsync of the directory)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(path: str, state: TrainState, cfg: OccNetConfig) -> None:
    """Write the checkpoint of ``state`` to one file, synchronously."""
    write(path, snapshot(state, cfg))


def restore(path: str, state: TrainState) -> TrainState:
    """Load step, model and optimizer state into ``state`` (in place) and
    return it; tensors go to the model's device."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


class CheckpointManager:
    """The last ``max_to_keep`` checkpoints of a run in ``directory`` (see
    the module doc)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             cfg: Optional[OccNetConfig] = None, block: bool = False
             ) -> None:
        """Checkpoint ``state`` as ``step``: the host copy is taken before
        this returns, the write runs on the background thread (rank 0
        only); ``block`` waits for it (`wait`)."""
        if process_shard()[0] == 0:
            payload = snapshot(state, cfg)
            self._pending.append(self._writer.submit(self._write, step,
                                                     payload))
        if block:
            self.wait()

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        write(self.path(step), payload)
        link = os.path.join(self.directory, LATEST)
        tmp = f"{link}.{os.getpid()}.tmp"
        os.symlink(os.path.basename(self.path(step)), tmp)
        os.replace(tmp, link)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def wait(self) -> None:
        """Until every save is durable (a write's error is raised here),
        then a barrier of every rank."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        barrier("checkpoint")

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load ``step`` (by default the newest) into ``state`` on its own
        device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return restore(self.path(step), state)

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()
