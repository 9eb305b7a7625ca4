"""Offline ray-projection CLI of the port (counterpart of
`tools/ray_casting.py`, the reference's `tools/ray_iou/ray_casting.py:
204-309`).

    python -m occnet_tpu_torch.tools.ray_casting --pred-dir preds/ \
        --infos nuscenes_infos_val_occ.pkl --data-root data/nuscenes/

Given a directory of per-token prediction ``<token>.npz`` files (semantics
(200, 200, 16) and flow (200, 200, 16, 2)) and the val infos pkl, renders
the predictions AND the ground truths along the simulated LiDAR fan (on the
card, one fan-kernel launch a grid, unless ``--device cpu``) and writes both
submission files; score them with `occnet_tpu_torch.tools.metric`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred-dir", required=True,
                   help="dir of <token>.npz with 'semantics' and 'flow'")
    p.add_argument("--infos", required=True, help="nuscenes infos pkl (val)")
    p.add_argument("--data-root", default="",
                   help="root for relative occ_path GT files")
    p.add_argument("--pred-out", default="my_pred_pcd.gz")
    p.add_argument("--gt-out", default="gt_pcd.gz")
    p.add_argument("--dataset-type", default="openocc_v2",
                   choices=["openocc_v2", "lightwheelocc"])
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the renders (default: cuda; the "
                        "CPU only with --device cpu)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from occnet_tpu_torch.data.nuscenes import load_infos
    from occnet_tpu_torch.data.pipeline import load_occ_gt
    from occnet_tpu_torch.evaluation.ego_pose import extract_ego_origins
    from occnet_tpu_torch.evaluation.submission import write_submission

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("occnet_tpu_torch.tools.ray_casting: no CUDA device "
                         "is available; pass --device cpu to render on the "
                         "CPU")
    infos, _ = load_infos(args.infos)
    if args.max_samples:
        infos = infos[: args.max_samples]
    origins = dict(extract_ego_origins(infos, args.dataset_type))

    def on_device(sem, flow):
        return (torch.from_numpy(sem.astype(np.int32)).to(device),
                torch.from_numpy(flow.astype(np.float32)).to(device))

    def pred_samples():
        for info in infos:
            token = info["token"]
            f = np.load(os.path.join(args.pred_dir, f"{token}.npz"))
            yield (token, *on_device(f["semantics"], f["flow"]),
                   origins[token])

    def gt_samples():
        for info in infos:
            token = info["token"]
            occ_path = info.get("occ_path")
            if occ_path and args.data_root and not os.path.isabs(occ_path):
                occ_path = os.path.join(args.data_root, occ_path)
            yield (token, *on_device(*load_occ_gt(occ_path)), origins[token])

    print(f"rendering {len(infos)} predictions -> {args.pred_out}")
    write_submission(args.pred_out, pred_samples())
    print(f"rendering {len(infos)} ground truths -> {args.gt_out}")
    write_submission(args.gt_out, gt_samples())
    print("done; score with: python -m occnet_tpu_torch.tools.metric "
          f"--pred {args.pred_out} --gt {args.gt_out}")


if __name__ == "__main__":
    main()
