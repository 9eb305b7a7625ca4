"""Ray-metric evaluation of the port (RayIoU / mAVE / OccScore along the
simulated LiDAR fan, `ray_metrics`) and ego-origin extraction
(`ego_pose`)."""

from occnet_tpu_torch.evaluation.ray_metrics import (  # noqa: F401
    RayMetricAccumulator,
    format_metrics_table,
    generate_lidar_rays,
    occ_score_from_metrics,
    render_pred_gt,
    render_sample,
    render_sample_fast,
    render_sample_vec,
)
