"""Checkpoints of the port (counterpart of `occnet_tpu/training/
checkpoint.py`, with `torch.save` in place of orbax): step, model state_dict
(parameters and BN statistics), optimizer state and the config as JSON."""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.training.train import TrainState


def save(path: str, state: TrainState, cfg: OccNetConfig) -> None:
    """Write the checkpoint atomically (a reader never sees half a file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "config": json.dumps(dataclasses.asdict(cfg), default=str)},
               tmp)
    os.replace(tmp, path)


def restore(path: str, state: TrainState) -> TrainState:
    """Load step, model and optimizer state into ``state`` (in place) and
    return it; tensors go to the model's device."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state
