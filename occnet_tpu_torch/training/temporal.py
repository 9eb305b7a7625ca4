"""The temporal (history-BEV) path of the port (counterpart of
`occnet_tpu/training/temporal.py`): prev-BEV alignment, the grad-free
history BEV of a clip, the clip train step and the streaming inference
state.

What the reference does and the JAX package reproduces:

- `BEVFormerOcc.obtain_history_bev` (`bevformer_occ.py:159-178`): the model
  in inference mode over frames 0..T-2 without gradients, each frame's BEV
  the next one's history;
- the prev BEV rotated about the grid centre by the ego yaw change
  (`transformer_occ.py:195-205`, NEAREST) and the TSA reference grid shifted
  by the ego translation (`transformer.py:122-141`);
- `EpochBasedRunner_video.run_iter` (`epoch_based_runner.py:57-97`): the
  last frame of a (B, T, ...) clip is supervised;
- `prev_frame_info` streaming at test time (`bevformer_occ.py:59-64`).

The ego deltas come from the ego2global poses (`ego_deltas_from_poses`):
the challenge data carries no can_bus.  Two behaviours of the JAX package
are kept (ROADMAP "Semantics the port carries over"): a mid-clip reset
zeroes the prev slot instead of re-entering the prev=None graph, and the
final alignment prev(T-2) -> current(T-1) ignores ``prev_exists[:, -1]``.
The history frames' certificates count toward ``cert_overflow`` (the JAX
step drops them): the port never answers where the two could differ.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.data.pipeline import make_device_train_augmenter
from occnet_tpu_torch.geometry import bev_reference_points_2d
from occnet_tpu_torch.models.head import occ_flow_loss
from occnet_tpu_torch.ops.transforms import rotate_bev, shift_bev_ref
from occnet_tpu_torch.training.train import (
    TrainState,
    apply_gradients,
    global_metrics,
    make_lr_schedule,
    step_generators,
)


def ego_deltas_from_poses(ego2global_prev: np.ndarray,
                          ego2global_curr: np.ndarray):
    """(delta_xy in the prev-ego frame, yaw delta deg, current yaw deg)
    between two 4x4 ego2global poses: the quantities can_bus carries in
    upstream BEVFormer (numpy, in the poses' own precision, as JAX)."""
    rel = np.linalg.inv(ego2global_prev) @ ego2global_curr
    delta_xy = rel[:2, 3]
    yaw_delta = np.degrees(np.arctan2(rel[1, 0], rel[0, 0]))
    yaw_curr = np.degrees(np.arctan2(ego2global_curr[1, 0],
                                     ego2global_curr[0, 0]))
    return delta_xy.astype(np.float32), np.float32(yaw_delta), \
        np.float32(yaw_curr)


def align_prev_bev(prev_bev: torch.Tensor, rotation_deg, bev_hw,
                   rotate_center: Optional[Tuple[float, float]] = None
                   ) -> torch.Tensor:
    """Rotate each sample's prev BEV (B, Q, C) by its yaw change
    ``rotation_deg`` (B,) about ``rotate_center`` (nearest), by default the
    grid centre (w/2, h/2) as in the JAX package: (100, 100) at 200 x 200,
    not the pixel centre 99.5."""
    h, w = bev_hw
    b, q, c = prev_bev.shape
    if rotate_center is None:
        rotate_center = (w / 2.0, h / 2.0)
    out = rotate_bev(prev_bev.reshape(b, h, w, c), rotation_deg,
                     center=rotate_center)
    return out.reshape(b, q, c)


def _sum_certificates(outs: Dict[str, torch.Tensor],
                      total: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    for k, v in outs.items():
        if k.endswith("_overflow"):
            total = v if total is None else total + v
    return total


def _reference_grid(cfg: OccNetConfig, device) -> torch.Tensor:
    """(1, Q, 1, 2) fp32 TSA reference points on ``device``."""
    m = cfg.model
    return torch.from_numpy(bev_reference_points_2d(m.bev_h, m.bev_w))[
        None].to(device)


def make_history_bev_fn(cfg: OccNetConfig):
    """Returns ``history(model, imgs, ego2img, rot_deg, shifts,
    prev_exists) -> (prev_bev (B, Q, C), certificates or None)``.

    imgs (B, T, cams, H, W, 3) processed, ego2img (B, T, cams, 4, 4);
    rot_deg (B, T) and shifts (B, T, 2) align frame t-1 into frame t;
    prev_exists (B, T) bool (False zeroes the prev slot).  Frame 0 takes
    the prev_bev=None path.  Every frame runs without gradients in
    inference mode (no grid mask, no dropout, BN statistics not updated).
    The certificates are the sum of every frame's ``*_overflow`` outputs."""
    m = cfg.model
    bev_hw = (m.bev_h, m.bev_w)

    @torch.no_grad()
    def history(model, imgs, ego2img, rot_deg, shifts, prev_exists):
        ref = _reference_grid(cfg, ego2img.device)
        outs = model(imgs[:, 0], ego2img[:, 0], only_bev=True)
        bev, cert = outs["bev_embed"], _sum_certificates(outs, None)
        for i in range(1, imgs.shape[1]):
            aligned = align_prev_bev(bev, rot_deg[:, i], bev_hw)
            prev_in = torch.where(prev_exists[:, i, None, None], aligned,
                                  torch.zeros_like(aligned))
            outs = model(imgs[:, i], ego2img[:, i], prev_bev=prev_in,
                         shift_ref_2d=ref + shifts[:, i, None, None, :],
                         only_bev=True)
            bev, cert = outs["bev_embed"], _sum_certificates(outs, cert)
        return bev, cert

    return history


def make_temporal_train_step(cfg: OccNetConfig, seed: int = 0):
    """Returns ``train_step(state, batch, mark=None) -> metrics``, the clip
    step of the video runner: the history BEV of frames 0..T-2 (no grad),
    then `training.train.make_train_step`'s step on frame T-1 with that
    history aligned into it.

    ``batch`` holds (on the model's device) img (B, T, cams, H, W, 3) uint8
    (every frame distorted, normalised and padded on the device from the
    step's generator, as the JAX host pipeline distorts every clip frame)
    or float, ego2img (B, T, cams, 4, 4), rot_deg (B, T), shifts (B, T, 2),
    prev_exists (B, T), shift (B, 2), and the last frame's voxel_semantics
    / voxel_flow.  The grid mask and dropout fall on the supervised frame
    only.  Metrics as `make_train_step`'s; cert_overflow also counts the
    history frames.  Under a process group the step follows
    `make_train_step`'s four rules (`training.train`); the history frames
    run in inference mode and without gradients, so they need no
    collective.  ``mark(name)`` is called after the "history", "forward",
    "backward" and "optimizer" phases (and the gradient "allreduce" under
    a process group)."""
    m = cfg.model
    schedule = make_lr_schedule(cfg)
    augment = make_device_train_augmenter(
        cfg.data, distort=cfg.data.device_distortion)
    history = make_history_bev_fn(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        ego2img = batch["ego2img"]
        dev = ego2img.device
        t = ego2img.shape[1]
        if t < 2:
            raise ValueError(f"a clip step needs T >= 2 frames, got {t}")
        gen, drop, rank, world = step_generators(seed, state.step, dev)
        img = augment(gen, batch["img"], (rank, world))
        prev_bev, cert = history(
            state.model, img[:, :-1], ego2img[:, :-1],
            batch["rot_deg"][:, :-1], batch["shifts"][:, :-1],
            batch["prev_exists"][:, :-1])
        # final alignment prev(T-2) -> current(T-1); like the JAX step it
        # does not look at prev_exists[:, -1]
        prev_bev = align_prev_bev(prev_bev, batch["rot_deg"][:, -1],
                                  (m.bev_h, m.bev_w))
        if mark:
            mark("history")
        shift_ref = (_reference_grid(cfg, dev)
                     + batch["shift"][:, None, None, :])
        outs = state.model(img[:, -1], ego2img[:, -1], prev_bev=prev_bev,
                           shift_ref_2d=shift_ref, train=True, generator=gen,
                           dropout_generator=drop)
        loss_occ, loss_flow = occ_flow_loss(
            outs["occ"], outs["flow"], batch["voxel_semantics"],
            batch["voxel_flow"], cfg.loss)
        loss = loss_occ + loss_flow
        if mark:
            mark("forward")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mark:
            mark("backward")
        grad_norm, lr = apply_gradients(state, cfg, schedule, mark)
        if mark:
            mark("optimizer")
        state.step += 1
        cert = _sum_certificates(outs, cert)
        if cert is None:
            cert = torch.zeros((), dtype=torch.int64, device=dev)
        loss, loss_occ, loss_flow, cert = global_metrics(
            loss, loss_occ, loss_flow, cert)
        return {"loss": loss, "loss_occ": loss_occ, "loss_flow": loss_flow,
                "grad_norm": grad_norm, "lr": torch.tensor(lr),
                "cert_overflow": cert}

    return train_step


class StreamingInferenceState:
    """Test-time temporal state (`prev_frame_info`): carries the last BEV
    across the sequential frames of a scene, resets on a scene change and
    aligns the history by the ego motion between the two frames' poses.

    Requests go through ``predictor.infer`` (`serve.Predictor`): uint8
    images normalised on the model's device, no certificate check and no
    wait for the device.  The ego deltas come from the host poses as fp32;
    the rotation's cos / sin are taken on the host and the rotation and
    the shift run on the device, so a frame makes no device-to-host
    copy."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.cfg = predictor.cfg
        m = self.cfg.model
        self.bev_hw = (m.bev_h, m.bev_w)
        self.grid_length = ((m.pc_range[4] - m.pc_range[1]) / m.bev_h,
                            (m.pc_range[3] - m.pc_range[0]) / m.bev_w)
        self.ref = _reference_grid(self.cfg, predictor.device)
        self.prev_bev: Optional[torch.Tensor] = None
        self.prev_scene: Optional[str] = None
        self.prev_pose: Optional[np.ndarray] = None

    @torch.inference_mode()
    def align(self, ego2global: np.ndarray
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the kept BEV aligned into the frame at ``ego2global``, the
        shifted TSA reference (1, Q, 1, 2)), both on the device."""
        delta_xy, yaw_delta, yaw_curr = ego_deltas_from_poses(
            self.prev_pose, ego2global)
        dev = self.predictor.device
        aligned = align_prev_bev(self.prev_bev,
                                 torch.tensor([yaw_delta]), self.bev_hw)
        shift = shift_bev_ref(
            torch.from_numpy(delta_xy).to(dev, non_blocking=True),
            torch.tensor(yaw_curr).to(dev, non_blocking=True),
            self.grid_length, self.bev_hw)
        return aligned, self.ref + shift

    def step(self, images, ego2img, scene_token: str,
             ego2global: np.ndarray,
             mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        """One frame: images uint8 (1, cams, H, W, 3), ego2img (1, cams, 4,
        4), the frame's scene token and 4x4 ego2global pose.  Returns the
        model's outputs (bev_embed, occ, flow and the certificates) on the
        device.  ``mark("align")`` is called after the alignment."""
        if scene_token != self.prev_scene:
            self.prev_bev = None
        if self.prev_bev is None:
            outs = self.predictor.infer(images, ego2img)
        else:
            prev_bev, shift_ref = self.align(ego2global)
            if mark:
                mark("align")
            outs = self.predictor.infer(images, ego2img, prev_bev=prev_bev,
                                        shift_ref_2d=shift_ref)
        self.prev_bev = outs["bev_embed"]
        self.prev_scene = scene_token
        self.prev_pose = ego2global
        return outs
