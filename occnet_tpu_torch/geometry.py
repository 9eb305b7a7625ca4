"""BEV/camera geometry of the exact (gather) encoder, the port of
`occnet_tpu/geometry.py`: pillar and BEV-plane reference points, their
projection into every camera, and the calibration-derived SCA top-K.

All of it is fp32 and must agree bit for bit between the card and the CPU:
the ring rig of `chip_smoke.py` puts BEV cells exactly on its cameras' field
of view edges, where one ulp flips `bev_mask` and with it a query's camera
count.  `compose_ego2img` folds lidar2img @ ego2lidar into one matrix a
camera.  So the reference points, which depend on no input, are built on the
host with numpy in float32 with true division (CUDA divides a tensor by a
Python scalar through its reciprocal), and the 4x4 projection is written as
four multiply-adds in a fixed order (a matrix product would go to cuBLAS on
the card, which sums in another order than the CPU).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def bev_reference_points_3d(bev_h: int, bev_w: int, z_range: float,
                            num_points_in_pillar: int) -> np.ndarray:
    """(Z, bev_h*bev_w, 3) float32 normalised xyz of the pillar anchors:
    z at linspace(0.5, z_range - 0.5, Z) / z_range, xy at cell centres."""
    d = num_points_in_pillar
    f32 = np.float32
    zs = (np.linspace(0.5, z_range - 0.5, d).astype(f32)
          / f32(z_range))
    xs = (np.arange(bev_w, dtype=f32) + f32(0.5)) / f32(bev_w)
    ys = (np.arange(bev_h, dtype=f32) + f32(0.5)) / f32(bev_h)
    ref = np.stack([np.broadcast_to(xs[None, None, :], (d, bev_h, bev_w)),
                    np.broadcast_to(ys[None, :, None], (d, bev_h, bev_w)),
                    np.broadcast_to(zs[:, None, None], (d, bev_h, bev_w))],
                   axis=-1)
    return np.ascontiguousarray(ref.reshape(d, bev_h * bev_w, 3))


def bev_reference_points_2d(bev_h: int, bev_w: int) -> np.ndarray:
    """(bev_h*bev_w, 1, 2) float32 normalised xy of the BEV cell centres
    (row-major over (y, x)), the TSA reference points."""
    f32 = np.float32
    ys, xs = np.meshgrid((np.arange(bev_h, dtype=f32) + f32(0.5)) / f32(bev_h),
                         (np.arange(bev_w, dtype=f32) + f32(0.5)) / f32(bev_w),
                         indexing="ij")
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)[:, None, :]


def project_bev_points_to_cameras(
    ref_3d,                        # (Z, Q, 3) normalised xyz, array or tensor
    pc_range: Sequence[float],
    ego2img: torch.Tensor,         # (B, cams, 4, 4)
    img_hw: Tuple[int, int],       # padded image (h, w)
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the pillar anchors into every camera on ego2img's device.

    Returns ref_cam (cams, B, Q, Z, 2) normalised image xy and bev_mask
    (cams, B, Q, Z) bool: depth > eps, strictly inside (0, 1)^2 and finite;
    non-finite xy are zeroed (`nan_to_num`), as in the JAX package."""
    dev = ego2img.device
    ref = torch.as_tensor(ref_3d, dtype=torch.float32, device=dev)
    pc = torch.tensor(pc_range, dtype=torch.float32, device=dev)
    xyz = ref * (pc[3:6] - pc[0:3]) + pc[0:3]                  # ego metres
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]           # (Z, Q)
    E = ego2img.float()[:, :, :3, :, None, None]               # (B,C,3,4,1,1)
    # rows 0..2 of E @ (x, y, z, 1): four multiply-adds in a fixed order
    pts = E[:, :, :, 0] * x + E[:, :, :, 1] * y + E[:, :, :, 2] * z \
        + E[:, :, :, 3]                                        # (B,C,3,Z,Q)
    depth = pts[:, :, 2]
    in_front = depth > eps
    den = torch.clamp(depth, min=eps)
    h, w = img_hw
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    xy = torch.stack([pts[:, :, 0] / den, pts[:, :, 1] / den], dim=-1) / size
    mask = (in_front & (xy[..., 0] > 0.0) & (xy[..., 0] < 1.0)
            & (xy[..., 1] > 0.0) & (xy[..., 1] < 1.0)
            & torch.isfinite(xy).all(dim=-1))
    xy = torch.nan_to_num(xy)
    # (B, C, Z, Q, .) -> (C, B, Q, Z, .), the layout SCA consumes
    return (xy.permute(1, 0, 3, 2, 4).contiguous(),
            mask.permute(1, 0, 3, 2).contiguous())


def compose_ego2img(lidar2img, ego2lidar) -> torch.Tensor:
    """ego2img = lidar2img @ ego2lidar per camera, fp32, on lidar2img's
    device: lidar2img (B, C, 4, 4), ego2lidar (B, 4, 4), arrays or tensors
    -> (B, C, 4, 4).  Each 4-term sum is (p0 + p1) + (p2 + p3) of the
    rounded products, as XLA's CPU dot sums them (bitwise equal to the
    jitted JAX einsum), never through cuBLAS."""
    l2i = torch.as_tensor(lidar2img).float()
    e2l = torch.as_tensor(ego2lidar).float().to(l2i.device)[:, None]
    p = [l2i[..., :, j:j + 1] * e2l[..., j:j + 1, :] for j in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def calibration_topk(model_cfg, ego2img, margin: float = 1.02,
                     multiple: int = 1024, per_camera: bool = False):
    """SCA top-K sized from one frame's cameras: the worst per-camera count
    of visible BEV queries, times ``margin``, rounded up to ``multiple``,
    clamped to [multiple, Q].  ``per_camera=True`` returns a tuple K_c for
    `SCAConfig.per_cam_topk`.  ego2img (B, cams, 4, 4), array or tensor."""
    m = model_cfg
    q = m.bev_h * m.bev_w
    ref3d = bev_reference_points_3d(
        m.bev_h, m.bev_w, m.pc_range[5] - m.pc_range[2],
        m.encoder.num_points_in_pillar)
    _, bev_mask = project_bev_points_to_cameras(
        ref3d, m.pc_range, torch.as_tensor(ego2img), (m.img_h, m.img_w))

    def snap(count: int) -> int:
        return min(q, max(multiple, -(-int(count * margin) // multiple)
                          * multiple))

    vis_counts = (bev_mask.cpu().numpy().sum(-1) > 0).sum(-1)   # (cams, B)
    if per_camera:
        return tuple(snap(int(c)) for c in vis_counts.max(-1))
    return snap(int(vis_counts.max()))
