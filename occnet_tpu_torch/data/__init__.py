"""Data of the port: the nuScenes-layout datasets, scene clips for the
temporal path, device-side input processing, loaders and samplers."""

from occnet_tpu_torch.data.clips import ClipDataset, clip_alignment  # noqa
from occnet_tpu_torch.data.nuscenes import (  # noqa: F401
    ConcatOccDataset,
    NuSceneOccDataset,
    build_train_dataset,
)
