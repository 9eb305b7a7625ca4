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

Data parallelism (`occnet_tpu_torch.parallel`): under a process group of
N ranks with B_local = b each, the step is the single-process step at
B = N * b, as the JAX step is one program over the global batch, up to the
order of floating-point sums.  Four places make it so:

1. batch statistics: the decoder's `BatchNorm3d` and the trunk's
   `TrainableBatchNorm` reduce over the global batch (all-reduces inside);
2. loss normalisers: the weighted and masked means of `occ_flow_loss`
   divide by the global weight sums, and the logged losses are the global
   ones (the ranks' shares averaged);
3. random draws: every rank draws the global batch's photometric
   parameters and the one grid mask from the (seed, step) generator and
   applies its own slice, so a rank's images are those of the B = N * b
   step.  Dropout masks would need global-shaped activations, so at N > 1
   they come from a generator of (seed, step, rank);
4. gradients: one flat all-reduce per dtype after `backward()` averages
   them (`parallel.multihost.all_reduce_mean_`) before the global-norm
   clip, so every rank clips by the same norm and takes the same AdamW
   update from the same parameters; `cert_overflow` is summed over the
   ranks.  A flat all-reduce rather than `DistributedDataParallel`: the
   frozen stages run under `no_grad` and the temporal step's history
   forwards run without gradients, two cases DDP's reducer must be told
   about, and the step needs the global gradient only at one point.

The model axis (`parallel.mesh`: dp x mp ranks, rank r at data rank
r // mp and model rank r % mp).  The rules above hold over the data axis
(the data group, `parallel.mesh.data_axis`): the model ranks of a data
rank hold the same samples and draw the same grid mask, distortion and
dropout streams.  With ``model.bev_shard_axis = ""`` the model axis is
replicated, as in the JAX dry run's ``tiny_occ`` step: each model rank
takes the unsharded step and the gradients are averaged over the data
group.  With ``"model"`` the encoder's BEV queries are sharded over the
model group (`parallel.qshard`: a block of BEV rows a rank, the lift on
those rows, the halo'd tap attention or the gathered TSA value, the
global SCA certificate), its output is gathered once, and the decoder,
the heads and the loss run replicated on every model rank.  The gradient
rule that gives every rank the unsharded step's gradient: each model rank
backpropagates L / mp of the replicated loss L, the BEV gather's
backward is a reduce-scatter sum, and after the backward every gradient
is summed over the world and divided by dp.  Decoder and head leaves so
get mp * (1 / mp) * dL, and the encoder, trunk, query and embedding leaves
the sum of the model ranks' partial contributions.  The reported loss is
L, unscaled.

Every named config trains: the dense and gather encoders, plain and DCN
trunks (their backward kernels behind the autograd Functions of
`ops/planar_lift`, `ops/tsa`, `ops/msda` and `ops/deform_conv`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from occnet_tpu_torch.config import OccNetConfig
from occnet_tpu_torch.data.pipeline import make_device_train_augmenter
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.head import occ_flow_loss
from occnet_tpu_torch.parallel.mesh import (
    Mesh,
    active,
    check_layout,
    data_axis,
    make_mesh,
)
from occnet_tpu_torch.parallel.multihost import (
    all_reduce_,
    all_reduce_mean_,
    group_size,
    world_size,
)
from occnet_tpu_torch.utils.profiling import grad_span, span


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
    device sync).  The span ``train.clip``."""
    with span("train.clip"):
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
                    schedule: Callable[[int], float],
                    mark: Optional[Callable[[str], None]] = None,
                    mesh: Optional[Mesh] = None, sharded: bool = False):
    """The optimizer half of a step on the ``.grad`` already in place:
    zero gradients for unused trainable leaves (optax still decays them),
    under a process group the gradient reduction (then
    ``mark("allreduce")``), global-norm clip, lr(step) * mult per group,
    AdamW.  The reduction is the average over the ranks at mp = 1 (or
    without ``mesh``), over the data group when the model axis is
    replicated, and with ``sharded`` BEV queries the sum over every rank
    divided by dp (see the module doc).  Returns (pre-clip grad norm
    tensor, lr).  Does not advance ``state.step``."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is None:
        over, divisor = None, world_size()
    else:
        over, divisor = (None if sharded else mesh.data_group), mesh.dp
    if group_size(over) > 1 or divisor > 1:
        all_reduce_mean_([p.grad for p in params], over, divisor)
        if mark:
            mark("allreduce")
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


def step_generators(seed: int, step: int, device, mesh: Mesh
                    ) -> Tuple[torch.Generator, torch.Generator, int, int]:
    """(the step's generator, the dropout generator, data rank, data-rank
    count) of ``mesh``: the dropout generator is the step's own on one data
    rank and a generator of (seed, step, data rank) over several (see the
    module doc).  The model ranks of a data rank draw alike."""
    rank, world = mesh.data_rank, mesh.dp
    gen = step_generator(seed, step, device)
    if world == 1:
        return gen, gen, rank, world
    drop = torch.Generator(device=device).manual_seed(
        ((seed * 1_000_003 + step) * 65_537 + rank + 1) % 2 ** 63)
    return gen, drop, rank, world


def global_metrics(loss: torch.Tensor, loss_occ: torch.Tensor,
                   loss_flow: torch.Tensor, cert: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The logged losses (detached) and certificate sum over the global
    batch: the data ranks' loss shares averaged, the certificates summed
    (int64) over the data axis (`parallel.mesh.data_axis`: the model ranks
    of a sample hold the same loss and certificates); the local values on
    one data rank."""
    losses = torch.stack([loss, loss_occ, loss_flow]).detach()
    group, world = data_axis()
    if world > 1:
        losses = all_reduce_(losses, group) / world
        cert = all_reduce_(cert.clone(), group)
    return losses[0], losses[1], losses[2], cert


def grad_checker(model: torch.nn.Module, threshold: float = 0.0
                 ) -> List[str]:
    """Dead-parameter detector (`occnet_tpu.training.train.grad_checker`,
    the reference's GradChecker hook, `models/hooks/hooks.py:5-11`): the
    names of parameters whose gradient is absent or identically zero
    (max |g| <= ``threshold``)."""
    return [n for n, p in model.named_parameters()
            if p.grad is None or float(p.grad.abs().max()) <= threshold]


def step_layout(cfg: OccNetConfig, mesh: Optional[Mesh]
                ) -> Tuple[Mesh, bool]:
    """(the layout of a step, whether it shards the BEV queries): ``mesh``
    or `make_mesh(cfg.parallel.dp, cfg.parallel.mp)`, checked against the
    model (`parallel.mesh.check_layout`)."""
    if mesh is None:
        mesh = make_mesh(cfg.parallel.dp, cfg.parallel.mp)
    return mesh, check_layout(cfg.model, mesh)


def backward(loss: torch.Tensor, mesh: Mesh, sharded: bool) -> None:
    """``loss.backward()``; with sharded BEV queries every model rank holds
    the whole loss, and each backpropagates loss / mp (module doc)."""
    (loss / mesh.mp if sharded else loss).backward()


@contextlib.contextmanager
def _phase(name: str, mark: Optional[Callable[[str], None]]
          ) -> Iterator[None]:
    """A phase of the train step: the span ``train.<name>``, then
    ``mark(name)``."""
    with span("train." + name):
        yield
    if mark:
        mark(name)


def make_train_step(cfg: OccNetConfig, seed: int = 0,
                    mesh: Optional[Mesh] = None):
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
    config has neither); under a process group the losses and the
    certificates are the global batch's (see the module doc).
    ``mark(name)``, when given, is called after the "forward", "backward"
    and "optimizer" phases (for timing), and under a process group after
    the gradient "allreduce".  With spans on (`utils.profiling`) the step
    is the root span ``train.step``, its phases ``train.forward``,
    ``train.backward`` and ``train.optimizer``, and the trunk's backward,
    from the gradient's arrival at the FPN outputs to the backward's end,
    ``train.backward.trunk``.

    ``mesh`` is the (data, model) layout of the ranks (default:
    `make_mesh(cfg.parallel.dp, cfg.parallel.mp)`); ``batch`` is the data
    rank's part of the global batch.  At mp > 1 with
    ``model.bev_shard_axis = "model"`` the step shards the BEV queries over
    the model group (module doc); an unknown axis or a ``bev_h`` that mp
    does not divide raises."""
    schedule = make_lr_schedule(cfg)
    augment = make_device_train_augmenter(
        cfg.data, distort=cfg.data.device_distortion)
    mesh, sharded = step_layout(cfg, mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
        with active(mesh), span("train.step"):
            return _step(state, batch, mark)

    def _step(state, batch, mark):
        dev = batch["ego2img"].device
        trunk_bwd = grad_span(state.model.neck, "train.backward.trunk")
        with _phase("forward", mark):
            gen, drop, rank, world = step_generators(seed, state.step, dev,
                                                     mesh)
            img = augment(gen, batch["img"], (rank, world))
            outs = state.model(img, batch["ego2img"], train=True,
                               generator=gen, dropout_generator=drop)
            loss_occ, loss_flow = occ_flow_loss(
                outs["occ"], outs["flow"], batch["voxel_semantics"],
                batch["voxel_flow"], cfg.loss,
                mask_camera=batch.get("mask_camera"))
            loss = loss_occ + loss_flow
        with _phase("backward", mark):
            state.optimizer.zero_grad(set_to_none=True)
            backward(loss, mesh, sharded)
            trunk_bwd.stop()
        with _phase("optimizer", mark):
            grad_norm, lr = apply_gradients(state, cfg, schedule, mark, mesh,
                                            sharded)
        state.step += 1
        cert = torch.zeros((), dtype=torch.int64, device=dev)
        for k, v in outs.items():
            if k.endswith("_overflow"):
                cert = cert + v
        loss, loss_occ, loss_flow, cert = global_metrics(
            loss, loss_occ, loss_flow, cert)
        return {"loss": loss, "loss_occ": loss_occ, "loss_flow": loss_flow,
                "grad_norm": grad_norm, "lr": torch.tensor(lr),
                "cert_overflow": cert}

    return train_step
