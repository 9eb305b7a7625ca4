"""Typed configuration tree of occnet_tpu_torch.

The port's own copy of `occnet_tpu/config.py` (the port imports nothing of
the JAX package): the same dataclasses, field names, defaults and named
configs, so a config built here and one built there from the same name and
overrides are equal field for field (`tests/test_torch_config.py`).  The
comments below speak of the JAX package's modules where a field selects one
of its implementations; the port reads the same fields.

Mirrors the key surface of the reference config
(`projects/configs/bevformer/bevformer_base_occ.py` in the reference repo):
point-cloud range, BEV grid, embedding dims, attention geometry, loss weights,
optimizer/schedule.  The reference uses mmcv python-file configs with `_base_`
inheritance and registry-driven dispatch; here the config is a frozen
dataclass tree with dotted-path CLI overrides (see `apply_overrides`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# OpenOcc v2 classes (reference config bevformer_base_occ.py:22-27).
OCC_CLASS_NAMES: Tuple[str, ...] = (
    "car", "truck", "trailer", "bus", "construction_vehicle",
    "bicycle", "motorcycle", "pedestrian", "traffic_cone", "barrier",
    "driveable_surface", "other_flat", "sidewalk",
    "terrain", "manmade", "vegetation", "free",
)

# Classes with flow supervision / AVE metric (reference ray_metrics.py:25-28).
FLOW_CLASS_NAMES: Tuple[str, ...] = (
    "car", "truck", "trailer", "bus", "construction_vehicle",
    "bicycle", "motorcycle", "pedestrian",
)


@dataclass(frozen=True)
class BackboneConfig:
    """ResNet image backbone (reference config :48-58)."""
    type: str = "resnet50"          # resnet50 | resnet101 | vovnet
    frozen_stages: int = 1          # stem + stage1 get zero gradient
    norm_eval: bool = True          # BN always uses running stats
    out_indices: Tuple[int, ...] = (1, 2, 3)   # C3, C4, C5
    # Per-stage DCNv2 (mmdet `stage_with_dcn`); R101-DCN lineage config uses
    # (False, False, True, True).
    dcn_stages: Tuple[bool, ...] = (False, False, False, False)
    # DCN sampling path: "gather" (exact at any offset) or "window" (dense
    # shift-window Pallas kernel, ops/dcn_window.py — exact whenever
    # floor(offset) stays within +/-dcn_window_radius, certified per batch
    # via the `dcn_window_overflow` intermediate).
    dcn_mode: str = "gather"
    dcn_window_radius: int = 3
    # Per-DCN-layer window radii (flat order of models/resnet.py
    # `dcn_layer_indices`); () = dcn_window_radius everywhere.  Filled by
    # the tools/test.py ONE-pass auto-radius probe: each layer runs at
    # exactly the radius its loaded offsets need (`dcn_radius_needed`
    # intermediate), still certified per batch by `dcn_window_overflow`.
    dcn_window_radii: Tuple[int, ...] = ()
    # VoVNet variant spec name (used when type == "vovnet").
    vovnet_spec: str = "V-99-eSE"


@dataclass(frozen=True)
class NeckConfig:
    """FPN neck (reference config :59-66)."""
    in_channels: Tuple[int, ...] = (512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 4
    add_extra_convs: str = "on_output"
    relu_before_extra_convs: bool = True


@dataclass(frozen=True)
class TSAConfig:
    """Temporal self-attention geometry (reference config :110-113 and
    temporal_self_attention.py defaults)."""
    num_heads: int = 8
    num_levels: int = 1
    num_points: int = 4
    num_bev_queue: int = 2
    dropout: float = 0.1
    # deformable-sampling implementation: "xla" = patch-table gather
    # (ops/msda.py), "pallas" = fused kernel (ops/msda_pallas.py)
    msda_impl: str = "xla"
    # dense-mode tap-attention implementation (ops/tsa_pallas.py):
    # "auto" = fused Pallas kernel on TPU / XLA shift loop elsewhere
    tap_impl: str = "auto"


@dataclass(frozen=True)
class SCAConfig:
    """Spatial cross-attention geometry (reference config :114-123)."""
    num_heads: int = 8
    num_levels: int = 4
    num_points: int = 8
    dropout: float = 0.1
    # Static top-k visible queries kept per camera (TPU replacement for the
    # reference's dynamic per-camera rebatching, spatial_cross_attention.py
    # :137-153).  0 => dense (all queries for all cameras, masked).  The
    # default keeps 12288 of the 40000 base-grid queries per camera — a 70°
    # camera sees ~10-11k queries of the 80 m grid, so the compaction stays
    # exact with margin (16384 was the r1/r2 wide-margin value; 12288 is
    # ~20% faster in gather mode).  Exactness is *certified per batch*: the
    # `sca_topk_overflow` intermediate counts dropped visible queries and
    # eval hard-fails on a nonzero count (tools/test.py), so a geometry that
    # ever exceeds K aborts loudly instead of silently scoring wrong.
    max_queries_per_cam: int = 12288
    # Per-camera K_c overriding max_queries_per_cam when non-empty (len ==
    # num_cams): narrow-FoV cameras see far fewer BEV queries than wide
    # ones, so a rig-global K pays the worst camera's row count everywhere.
    # Cameras with equal K_c batch into one MSDA call; certified by the
    # same `sca_topk_overflow` intermediate.  Derive via
    # `geometry.calibration_topk(..., per_camera=True)`.
    per_cam_topk: Tuple[int, ...] = ()
    # deformable-sampling implementation: "xla" = patch-table gather
    # (ops/msda.py), "pallas" = fused kernel (ops/msda_pallas.py)
    msda_impl: str = "xla"


@dataclass(frozen=True)
class EncoderConfig:
    """BEVFormer encoder (reference config :101-128).

    mode:
      "gather" — exact reference semantics (per-sample deformable gathers;
        slow on TPU, used for parity testing);
      "dense"  — TPU-native fast path (planar-homography lift + dense tap
        attention, see ops/planar_lift.py and models/dense_attention.py).
    """
    num_layers: int = 4
    num_points_in_pillar: int = 8
    ffn_dim: int = 512
    ffn_dropout: float = 0.1
    mode: str = "gather"
    # Planar-lift implementation for dense mode: "auto" = Pallas kernels on
    # TPU / einsum elsewhere; "pallas" / "einsum" force one.
    lift_impl: str = "auto"
    tsa: TSAConfig = field(default_factory=TSAConfig)
    sca: SCAConfig = field(default_factory=SCAConfig)


@dataclass(frozen=True)
class ModelConfig:
    embed_dims: int = 256
    bev_h: int = 200
    bev_w: int = 200
    pillar_h: int = 16
    out_dim: int = 32               # voxel decoder channels (transformer_occ.py:54)
    num_classes: int = 17
    num_cams: int = 6
    num_feature_levels: int = 4
    pc_range: Tuple[float, ...] = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    neck: NeckConfig = field(default_factory=NeckConfig)
    use_grid_mask: bool = True      # reference config :46, detector ctor :52-53
    grid_mask_prob: float = 0.7
    use_cams_embeds: bool = True
    rotate_prev_bev: bool = True    # temporal path (transformer_occ.py:195-205)
    use_can_bus: bool = True
    # bf16 compute with fp32 islands (point projection, softmax, losses).
    compute_dtype: str = "bfloat16"
    # Name of the mesh axis to shard the BEV query grid over (spatial/model
    # parallelism — the "sequence" axis of this model, SURVEY.md section 5);
    # None/"" = replicated.
    bev_shard_axis: str = ""
    # Input image size after padding to size_divisor 32 (nuScenes 900x1600).
    img_h: int = 928
    img_w: int = 1600


@dataclass(frozen=True)
class LossConfig:
    """CE occupancy + L1 flow (reference config :84-88)."""
    occ_weight: float = 1.0
    flow_weight: float = 0.25
    use_mask: bool = False
    # Per-class CE weights (len == num_classes), the mmdet
    # `CrossEntropyLoss(class_weight=...)` knob with torch reduction
    # semantics: sum(w[y]*ce) / sum(w[y]).  () = unweighted (the shipped
    # reference configs).  Used by the synthetic benchmark, where free+ground
    # are ~95% of voxels and unweighted CE starves the box classes.
    class_weights: Tuple[float, ...] = ()
    # L1 flow weight on voxels whose GT label is a flow class (< 8), with
    # weighted-mean reduction.  1.0 = the reference's plain element mean
    # (`bevformer_occ_head.py:193`), under which flow-class voxels (~1% of
    # the grid) contribute ~1% of the flow gradient — measured on the
    # synthetic benchmark: mAVE 1.38 vs a 1.48 predict-zero baseline.
    flow_fg_weight: float = 1.0


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + cosine schedule (reference config :214-231)."""
    lr: float = 2e-4
    backbone_lr_mult: float = 0.1
    weight_decay: float = 0.01
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3
    total_epochs: int = 24
    steps_per_epoch: int = 28130    # train frames / global batch (set by data)


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/nuscenes/"
    train_ann: str = "nuscenes_infos_train_occ.pkl"
    val_ann: str = "nuscenes_infos_val_occ.pkl"
    batch_size_per_device: int = 1
    # BGR mean/std normalisation (reference config :14-15 — std is 1.0).
    img_mean: Tuple[float, ...] = (103.530, 116.280, 123.675)
    img_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    to_rgb: bool = False
    workers: int = 4
    shuffle: bool = True
    # photometric distortion inside the on-device uint8 train pipeline
    # (`make_device_train_augmenter`); off for the synthetic benchmark,
    # whose class identity is colour-coded (measured: distortion kills the
    # box classes — see SyntheticOccDataset.get_sample)
    device_distortion: bool = True
    # GT grid (X, Y, Z) used for the zero-label fallback when a sample has
    # no labels.npz (test split, `pipelines/loading.py:21-33`).
    occ_size: Tuple[int, int, int] = (200, 200, 16)
    # Additional concat train datasets as (data_root, ann_file) pairs — the
    # reference's ConcatDataset of the nuScenes + LightwheelOcc synthetic
    # trainsets (`bevformer_base_occ_w_lightwheel.py:187-226`); built by
    # `data.build_train_dataset` into a ConcatOccDataset.
    extra_trainsets: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class EvalConfig:
    """Ray-metric parameters (reference ray_metrics.py:14-16,63-86)."""
    voxel_size: float = 0.4
    occ_size: Tuple[int, int, int] = (200, 200, 16)
    # Metric-grid extent; must give CUBIC voxels with occ_size (the DDA
    # marchers work in voxel units).  Matches the model pc_range.
    pc_range: Tuple[float, ...] = (-40.0, -40.0, -1.0, 40.0, 40.0, 5.4)
    thresholds: Tuple[float, ...] = (1.0, 2.0, 4.0)
    max_origins: int = 8            # ego origins per sample (ego_pose_extractor.py)
    interval: int = 24


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout.  The reference is DP-only (SURVEY.md section 2.7); we expose
    data and model axes so the BEV grid / cameras can shard over ICI."""
    dp: int = -1                    # -1 => all devices on the data axis
    mp: int = 1                     # model axis (BEV rows / cameras)


@dataclass(frozen=True)
class OccNetConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0
    work_dir: str = "work_dirs/occnet_tpu"


# ---------------------------------------------------------------------------
# Named configs (the BASELINE.json config matrix).
# ---------------------------------------------------------------------------

def base_occ() -> OccNetConfig:
    """OccNet base: R50, 200x200 BEV, 4-level FPN, 17 classes + flow.

    Mirrors `bevformer_base_occ.py` in the reference.
    """
    return OccNetConfig()


def tiny_occ() -> OccNetConfig:
    """BEVFormer-tiny occ: small BEV grid / image for fast tests + CI."""
    cfg = OccNetConfig()
    model = dataclasses.replace(
        cfg.model,
        bev_h=50, bev_w=50, pillar_h=8, embed_dims=128, out_dim=16,
        img_h=256, img_w=448,
        encoder=dataclasses.replace(
            cfg.model.encoder, num_layers=2, ffn_dim=256,
            num_points_in_pillar=4),
    )
    data = dataclasses.replace(cfg.data, occ_size=(50, 50, 8))
    return dataclasses.replace(cfg, model=model, data=data)


def turbo_occ() -> OccNetConfig:
    """Flagship fast config: base dims with the dense TPU-native encoder."""
    cfg = OccNetConfig()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, mode="dense"))
    return dataclasses.replace(cfg, model=model)


def tiny_turbo_occ() -> OccNetConfig:
    cfg = tiny_occ()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, mode="dense"))
    return dataclasses.replace(cfg, model=model)


def synth_tiny_occ() -> OccNetConfig:
    """Tiny exact-mode config on the synthetic geometric benchmark
    (`data/synthetic.py`): CUBIC 0.8 m voxels — 50x50x8 over a +/-20 m,
    -1..5.4 m range — so the ray-metric marchers evaluate it exactly.
    The learnability A/B baseline for `synth_tiny_turbo_occ`."""
    cfg = tiny_occ()
    pc = (-20.0, -20.0, -1.0, 20.0, 20.0, 5.4)
    model = dataclasses.replace(
        cfg.model, pc_range=pc,
        # trained FROM SCRATCH (no ImageNet checkpoint in this env): frozen
        # random stem + norm_eval BN (identity stats) would freeze garbage
        # features — unfreeze everything and let BN learn its statistics.
        # GridMask off: with 5-11 small boxes per scene the 0.7-prob mask
        # occludes most of the box signal most steps (an aug for 28k-frame
        # nuScenes, counterproductive at 256 synthetic scenes).
        use_grid_mask=False,
        backbone=dataclasses.replace(cfg.model.backbone, frozen_stages=-1,
                                     norm_eval=False))
    ev = dataclasses.replace(cfg.eval, voxel_size=0.8, occ_size=(50, 50, 8),
                             pc_range=pc)
    optim = dataclasses.replace(cfg.optim, warmup_iters=200,
                                backbone_lr_mult=1.0)
    # Class-balanced CE: free ~85% / ground ~12% of voxels — unweighted CE
    # reaches loss ~0.08 with ZERO box voxels predicted (measured: RayIoU
    # flat at IoU(ground)/7 ~= 0.136 on train AND val splits).  Weighted so
    # the box classes carry ~half the gradient mass.
    cw = [5.0] * 17
    cw[10] = 0.5            # driveable_surface (ground plane)
    cw[16] = 0.05           # free
    # flow_fg_weight 50: flow-class voxels are ~1-2% of the grid, so the
    # plain element mean gives them ~1% of the flow gradient (measured:
    # mAVE 1.38 vs the 1.48 predict-zero baseline); at 50 they carry ~half.
    loss = dataclasses.replace(cfg.loss, class_weights=tuple(cw),
                               flow_fg_weight=50.0)
    return dataclasses.replace(cfg, model=model, eval=ev, optim=optim,
                               loss=loss)


def synth_tiny_turbo_occ() -> OccNetConfig:
    """`synth_tiny_occ` with the dense TPU-native (turbo) encoder — the
    accuracy A/B that answers whether the redesigned encoder LEARNS the
    task as well as the exact reference semantics (VERDICT r3 #1)."""
    cfg = synth_tiny_occ()
    model = dataclasses.replace(
        cfg.model,
        encoder=dataclasses.replace(cfg.model.encoder, mode="dense"))
    return dataclasses.replace(cfg, model=model)


def base_occ_w_lightwheel() -> OccNetConfig:
    """Base occ trained on nuScenes + the LightwheelOcc synthetic trainset
    (the reference's `bevformer_base_occ_w_lightwheel.py`: same model, the
    train split becomes a ConcatDataset of the two)."""
    cfg = OccNetConfig()
    data = dataclasses.replace(
        cfg.data,
        extra_trainsets=(("data/lightwheelocc/",
                          "lightwheel_occ_infos_train.pkl"),))
    return dataclasses.replace(cfg, data=data)


def r101_dcn_occ() -> OccNetConfig:
    """OccNet-R101-DCN base (BASELINE.json config 3): ResNet-101 with DCNv2
    on stages 3-4 (the BEVFormer/OccNet lineage backbone), exact encoder."""
    cfg = OccNetConfig()
    model = dataclasses.replace(
        cfg.model,
        backbone=dataclasses.replace(
            cfg.model.backbone, type="resnet101",
            dcn_stages=(False, False, True, True)))
    return dataclasses.replace(cfg, model=model)


def turbo_r101_dcn_occ() -> OccNetConfig:
    """R101-DCN backbone with the dense TPU-native encoder and the dense
    window-kernel DCN path (certified-exact while offsets stay within the
    window; `tools/test.py` hard-fails on a nonzero certificate)."""
    cfg = r101_dcn_occ()
    model = dataclasses.replace(
        cfg.model,
        backbone=dataclasses.replace(cfg.model.backbone, dcn_mode="window"),
        encoder=dataclasses.replace(cfg.model.encoder, mode="dense"))
    return dataclasses.replace(cfg, model=model)


CONFIGS = {
    "base_occ": base_occ,
    "base_occ_w_lightwheel": base_occ_w_lightwheel,
    "tiny_occ": tiny_occ,
    "turbo_occ": turbo_occ,
    "tiny_turbo_occ": tiny_turbo_occ,
    "synth_tiny_occ": synth_tiny_occ,
    "synth_tiny_turbo_occ": synth_tiny_turbo_occ,
    "r101_dcn_occ": r101_dcn_occ,
    "turbo_r101_dcn_occ": turbo_r101_dcn_occ,
}


def get_config(name: str) -> OccNetConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config '{name}'; available: {sorted(CONFIGS)}")
    return CONFIGS[name]()


# ---------------------------------------------------------------------------
# Dotted-path overrides: the TPU-native replacement for mmcv --cfg-options
# (reference tools/train.py:67-76,105-107).
# ---------------------------------------------------------------------------

def _convert(value: str, target: Any) -> Any:
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes")
    if isinstance(target, int):
        return int(value)
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        elems = [v for v in value.strip("()[]").split(",") if v]
        if len(target) > 0:
            return tuple(type(target[0])(e) for e in elems)

        # empty-default tuples (per_cam_topk, dcn_window_radii) carry no
        # element type to copy: parse numerically where possible
        def elem(e: str) -> Any:
            for t in (int, float):
                try:
                    return t(e)
                except ValueError:
                    pass
            return e
        return tuple(elem(e) for e in elems)
    return value


def apply_overrides(cfg: OccNetConfig, overrides: dict) -> OccNetConfig:
    """Apply {'optim.lr': '1e-4', ...} style overrides to the frozen tree."""
    for path, value in overrides.items():
        keys = path.split(".")
        # Walk down collecting the chain of dataclasses.
        chain = [cfg]
        for k in keys[:-1]:
            chain.append(getattr(chain[-1], k))
        leaf_name = keys[-1]
        old = getattr(chain[-1], leaf_name)
        new_leaf = _convert(value, old) if isinstance(value, str) else value
        node = dataclasses.replace(chain[-1], **{leaf_name: new_leaf})
        # Rebuild the chain bottom-up.
        for parent, key in zip(reversed(chain[:-1]), reversed(keys[:-1])):
            node = dataclasses.replace(parent, **{key: node})
        cfg = node
    return cfg
