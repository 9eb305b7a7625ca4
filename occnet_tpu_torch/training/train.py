"""Training runtime of the port (counterpart of `occnet_tpu/training/
train.py`): the mmcv cosine schedule with linear warmup, the per-group lr
multipliers, the optimizer in optax's order, and the train step.

The update is optax's chain `clip_by_global_norm -> scale_by_adam ->
add_decayed_weights -> scale_by_learning_rate -> multi_transform(mults)`:

    g  <- g * max / |g|            if |g| >= max (global norm, pre-clip norm
                                   reported as ``grad_norm``)
    p  <- p - lr(step) * mult * (adam(g) + wd * p)

which is `torch.optim.AdamW` with each group's lr set to lr(step) * mult
before every step.  Parameters with multiplier 0 (the stem and stages <=
``frozen_stages``) are left out of the optimizer: they never change, as
optax's `set_to_zero` leaves them.

Randomness: each step draws its grid mask, photometric distortion and dropout
masks from one `torch.Generator` on the model's device, seeded from
(seed, step) as the JAX package folds the step into its key.

Every named config trains: the dense and gather encoders, plain and DCN
trunks (their backward kernels behind the autograd Functions of
`ops/planar_lift`, `ops/tsa`, `ops/msda` and `ops/deform_conv`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.data.pipeline import make_device_train_augmenter
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.head import occ_flow_loss


def make_lr_schedule(cfg: OccNetConfig) -> Callable[[int], float]:
    """mmcv CosineAnnealing + linear warmup: during warmup
    lr = base * (1 - (1 - t / warmup_iters) * (1 - warmup_ratio)); after,
    cosine from base to base * min_lr_ratio over the total steps."""
    o = cfg.optim
    total_steps = o.total_epochs * o.steps_per_epoch

    def schedule(step: int) -> float:
        frac = min(max(step / max(o.warmup_iters, 1), 0.0), 1.0)
        warmup_mult = 1.0 - (1.0 - frac) * (1.0 - o.warmup_ratio)
        progress = min(max(step / max(total_steps, 1), 0.0), 1.0)
        min_lr = o.lr * o.min_lr_ratio
        cosine = min_lr + (o.lr - min_lr) * 0.5 * (1 + math.cos(
            math.pi * progress))
        return cosine * (warmup_mult if step < o.warmup_iters else 1.0)

    return schedule


def lr_mult(name: str, cfg: OccNetConfig) -> float:
    """lr multiplier of the parameter ``name`` (a state_dict key): 0 for the
    stem and backbone stages <= frozen_stages, backbone_lr_mult for the rest
    of the backbone, 1 elsewhere (`train._lr_mult_tree`)."""
    frozen = cfg.model.backbone.frozen_stages
    names = name.split(".")
    if names[0] != "backbone":
        return 1.0
    sub = names[1] if len(names) > 1 else ""
    if sub in ("conv1", "bn1") and frozen >= 0:
        return 0.0
    for stage in range(1, frozen + 1):
        if sub.startswith(f"layer{stage}_"):
            return 0.0
    return cfg.optim.backbone_lr_mult


def make_optimizer(cfg: OccNetConfig, model: torch.nn.Module
                   ) -> torch.optim.AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) with one
    param group per nonzero lr multiplier; each group carries its
    ``lr_mult``.  Frozen parameters (multiplier 0) are not in it."""
    groups: Dict[float, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        mult = lr_mult(name, cfg)
        if mult != 0.0:
            groups.setdefault(mult, []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr_mult": m} for m, ps in groups.items()],
        lr=cfg.optim.lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.optim.weight_decay)


def clip_by_global_norm(params: List[torch.nn.Parameter], max_norm: float
                        ) -> torch.Tensor:
    """optax `clip_by_global_norm` on the ``.grad`` of ``params``, in place:
    g -> (g / |g|) * max_norm when |g| >= max_norm (not `clip_grad_norm_`'s
    max / (|g| + 1e-6)).  Returns the pre-clip global norm (fp32 tensor, no
    device sync)."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """Step count, model and optimizer (the JAX `TrainState`'s params and
    batch_stats live in the model, opt_state in the optimizer)."""
    step: int
    model: OccNet
    optimizer: torch.optim.Optimizer


def create_train_state(cfg: OccNetConfig, state_dict: Dict[str, torch.Tensor],
                       device) -> TrainState:
    model = OccNet(cfg.model)
    model.load_state_dict(state_dict)
    model = model.to(device)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


def apply_gradients(state: TrainState, cfg: OccNetConfig,
                    schedule: Callable[[int], float]):
    """The optimizer half of a step on the ``.grad`` already in place:
    zero gradients for unused trainable leaves (optax still decays them),
    global-norm clip, lr(step) * mult per group, AdamW.  Returns
    (pre-clip grad norm tensor, lr).  Does not advance ``state.step``."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grad_norm = clip_by_global_norm(params, cfg.optim.grad_clip_norm)
    lr = schedule(state.step)
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_mult"]
    opt.step()
    return grad_norm, lr


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's generator on ``device``, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % 2 ** 63)


def make_train_step(cfg: OccNetConfig, seed: int = 0):
    """Returns ``train_step(state, batch, mark=None) -> metrics``.

    ``batch`` holds ``img`` (B, cams, H, W, 3) uint8 (augmented on the
    device: photometric distortion when `data.device_distortion`, normalise,
    pad) or float (already processed), ``ego2img``, ``voxel_semantics``,
    ``voxel_flow`` and optionally ``mask_camera``, all on the model's
    device.  Metrics are 0-d tensors (no device sync): loss, loss_occ,
    loss_flow, grad_norm (pre-clip), lr, cert_overflow (the sum of every
    `*_overflow` certificate of the forward, the gather encoder's
    `sca_topk_overflow` and the window DCN's `dcn_window_overflow`, as
    `occnet_tpu.training.train.collect_overflow` sums them; 0 when the
    config has neither).  ``mark(name)``, when given, is called after
    the "forward", "backward" and "optimizer" phases (for timing)."""
    schedule = make_lr_schedule(cfg)
    augment = make_device_train_augmenter(
        cfg.data, distort=cfg.data.device_distortion)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        dev = batch["ego2img"].device
        gen = step_generator(seed, state.step, dev)
        img = augment(gen, batch["img"])
        outs = state.model(img, batch["ego2img"], train=True, generator=gen)
        loss_occ, loss_flow = occ_flow_loss(
            outs["occ"], outs["flow"], batch["voxel_semantics"],
            batch["voxel_flow"], cfg.loss,
            mask_camera=batch.get("mask_camera"))
        loss = loss_occ + loss_flow
        if mark:
            mark("forward")
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mark:
            mark("backward")
        grad_norm, lr = apply_gradients(state, cfg, schedule)
        if mark:
            mark("optimizer")
        state.step += 1
        cert = torch.zeros((), dtype=torch.int64, device=dev)
        for k, v in outs.items():
            if k.endswith("_overflow"):
                cert = cert + v
        return {"loss": loss.detach(), "loss_occ": loss_occ.detach(),
                "loss_flow": loss_flow.detach(), "grad_norm": grad_norm,
                "lr": torch.tensor(lr), "cert_overflow": cert}

    return train_step
