"""Offline scorer CLI of the port (counterpart of `tools/metric.py`, the
reference's `tools/ray_iou/metric.py:83-142`): two submission files ->
RayIoU@{1,2,4} / mAVE / OccScore, the challenge server's computation, in
numpy on the host.

    python -m occnet_tpu_torch.tools.metric --pred my_pred_pcd.gz \
        --gt gt_pcd.gz --out scores.json
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--pred", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--out", default=None,
                   help="also write the score dict to this json file")
    args = p.parse_args(argv)

    from occnet_tpu_torch.evaluation.submission import score_submissions
    scores = score_submissions(args.pred, args.gt)
    print(json.dumps(scores, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f)
    return scores


if __name__ == "__main__":
    main()
