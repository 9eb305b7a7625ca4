"""Occupancy visualisation (port of `occnet_tpu/utils/vis.py`): BEV class
maps, voxel scatter views and feature-map image dumps.  The image of a BEV
map is numpy; the functions that draw import matplotlib when called (the
card's machine has none)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from occnet_tpu_torch.config import OCC_CLASS_NAMES

# one RGB colour a class (free white), loosely the nuScenes palette
CLASS_COLORS = np.array([
    [255, 158, 0], [255, 99, 71], [255, 140, 0], [255, 69, 0],
    [233, 150, 70], [220, 20, 60], [255, 61, 99], [0, 0, 230],
    [47, 79, 79], [112, 128, 144], [0, 207, 191], [175, 0, 75],
    [75, 0, 75], [112, 180, 60], [222, 184, 135], [0, 175, 0],
    [255, 255, 255],
], dtype=np.uint8)


def occupancy_to_bev_image(sem: np.ndarray) -> np.ndarray:
    """(X, Y, Z) semantic grid -> (Y, X, 3) uint8 BEV image: each column's
    highest non-free voxel's class colour."""
    sem = np.asarray(sem)
    free = len(OCC_CLASS_NAMES) - 1
    nonfree = sem != free
    zidx = np.where(nonfree.any(-1), nonfree.shape[-1] - 1 -
                    np.argmax(nonfree[..., ::-1], axis=-1), -1)
    cls = np.where(zidx >= 0,
                   np.take_along_axis(sem, np.maximum(zidx, 0)[..., None],
                                      axis=-1)[..., 0], free)
    return CLASS_COLORS[cls].transpose(1, 0, 2)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_occupancy_bev(sem: np.ndarray, path: str,
                       title: Optional[str] = None):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(occupancy_to_bev_image(sem), origin="lower")
    ax.set_xlabel("x (cells)")
    ax.set_ylabel("y (cells)")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_voxel_scatter(sem: np.ndarray, path: str, max_points: int = 60000):
    """3D scatter of the occupied voxels coloured by class (at most
    ``max_points``, drawn from a fixed seed)."""
    plt = _pyplot()
    sem = np.asarray(sem)
    free = len(OCC_CLASS_NAMES) - 1
    xs, ys, zs = np.nonzero(sem != free)
    if len(xs) > max_points:
        sel = np.random.RandomState(0).choice(len(xs), max_points,
                                              replace=False)
        xs, ys, zs = xs[sel], ys[sel], zs[sel]
    colors = CLASS_COLORS[sem[xs, ys, zs]] / 255.0
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(xs, ys, zs, c=colors, s=1, marker="s")
    ax.set_box_aspect((sem.shape[0], sem.shape[1], 4 * sem.shape[2]))
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def normalized_image(tensor: np.ndarray) -> np.ndarray:
    """A (H, W) / (C, H, W) / (H, W, C) array as `save_tensor` draws it:
    channels last, more than 3 channels averaged, scaled to [0, 1]."""
    t = np.asarray(tensor, dtype=np.float32)
    if t.ndim == 3 and t.shape[0] in (1, 3):
        t = t.transpose(1, 2, 0)
    if t.ndim == 3 and t.shape[-1] not in (1, 3):
        t = t.mean(-1)
    t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
    return t.squeeze() if t.ndim == 3 and t.shape[-1] == 1 else t


def save_tensor(tensor: np.ndarray, path: str):
    """Debug dump of a feature map as an image."""
    t = normalized_image(tensor)
    _pyplot().imsave(path, t, cmap="viridis" if t.ndim == 2 else None)
