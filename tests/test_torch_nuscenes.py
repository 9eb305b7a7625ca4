"""The port's nuScenes-layout data path against the JAX package's on the CPU:
the JPEG decoder (`data/jpeg.py`) bitwise against `tf.io.decode_jpeg`, the
camera geometry and `NuSceneOccDataset` samples, the LightwheelOcc concat
train set, the contiguous sampler and the raw-table ego-pose scanner, each
bitwise equal to JAX's on the same fixtures."""

import dataclasses
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image

import tensorflow as tf

from occnet_tpu.config import get_config as jax_get_config
from occnet_tpu.data import devkit_ego_pose as jax_devkit
from occnet_tpu.data import nuscenes as jax_nusc
from occnet_tpu.data import sampler as jax_sampler
from occnet_tpu_torch.config import get_config
from occnet_tpu_torch.data import devkit_ego_pose, nuscenes, sampler
from occnet_tpu_torch.data.jpeg import decode_jpeg, read_jpeg
from occnet_tpu_torch.data.pipeline import load_occ_gt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from test_data import _synthetic_info  # noqa: E402
from test_devkit_ego_pose import _fabricate  # noqa: E402
from torch_jpeg_fixtures import FIXTURES, NAMES, pixel_digest  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

IMG_HW = (64, 96)
GRID = (10, 10, 4)


def _tf_pixels(data: bytes) -> np.ndarray:
    """The JAX package's decode (`nuscenes._decode_image`): tf's default
    dct_method, 3 channels."""
    return tf.io.decode_jpeg(data, channels=3).numpy()


def _jpeg(img: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="JPEG", **kw)
    return bio.getvalue()


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) % 256], -1).astype(np.uint8)


def _random(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


JPEG_CASES = {
    "smooth_900x1600": lambda: _jpeg(_smooth(900, 1600), quality=90),
    "random_37x53": lambda: _jpeg(
        _random(1, (37, 53, 3)), quality=90),
    "random_17x9": lambda: _jpeg(
        _random(2, (17, 9, 3)), quality=90),
    "random_444": lambda: _jpeg(
        _random(3, (37, 53, 3)), quality=90,
        subsampling=0),
    "random_422": lambda: _jpeg(
        _random(4, (37, 53, 3)), quality=90,
        subsampling=1),
    "restart_markers": lambda: _jpeg(
        _random(5, (37, 53, 3)), quality=90,
        restart_marker_blocks=1),
    "grayscale": lambda: _jpeg(
        _random(6, (37, 53)), quality=75),
}


@pytest.mark.parametrize("name", sorted(JPEG_CASES))
def test_decoder_bitwise_equal_to_tf(name):
    """Full width, partial MCUs, 4:4:4 / 4:2:2 / 4:2:0, restart markers and
    one component: every pixel equal (tolerance 0)."""
    data = JPEG_CASES[name]()
    if name == "restart_markers":
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    got = decode_jpeg(data)
    want = _tf_pixels(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decoder_on_random_files_bitwise_equal_to_tf():
    """200 files drawn from a seed: sizes 1-119 on each side, noise,
    patterns and clipped Gaussians, qualities 5-100, all three
    subsamplings, restart intervals, optimised Huffman tables and one
    component: every pixel of every file equal to tf's."""
    rng = np.random.RandomState(1)
    for i in range(200):
        h, w = rng.randint(1, 120, 2)
        kind = rng.randint(3)
        if kind == 0:
            img = rng.randint(0, 256, (h, w, 3), np.uint8)
        elif kind == 1:
            yy, xx = np.mgrid[0:h, 0:w]
            img = np.stack([xx * 3 % 256, yy * 5 % 256, (xx * yy) % 256],
                           -1).astype(np.uint8)
        else:
            img = np.clip(rng.randn(h, w, 3) * 80 + 128, 0,
                          255).astype(np.uint8)
        kw = dict(quality=int(rng.choice([5, 30, 75, 90, 95, 100])),
                  subsampling=int(rng.randint(3)))
        if rng.rand() < 0.3:
            kw["restart_marker_blocks"] = int(rng.randint(1, 5))
        if rng.rand() < 0.2:
            kw["optimize"] = True
        data = _jpeg(img[..., 0] if rng.rand() < 0.1 else img, **kw)
        np.testing.assert_array_equal(decode_jpeg(data), _tf_pixels(data),
                                      err_msg=f"file {i}: {(h, w)} {kw}")


def test_decoder_on_the_miniset_and_the_committed_fixtures(tmp_path):
    """The random quality-90 JPEGs of `_write_miniset` and the six full-width
    camera fixtures that `chip_smoke.py` decodes on the card: bitwise equal
    to tf, and the fixtures' pixels hash to `digests.json`."""
    root = str(tmp_path)
    ann = _write_miniset(root, 1, IMG_HW, grid=GRID)
    with open(ann, "rb") as f:
        info = pickle.load(f)["infos"][0]
    for cam in info["cams"].values():
        path = os.path.join(root, cam["data_path"])
        with open(path, "rb") as f:
            np.testing.assert_array_equal(read_jpeg(path),
                                          _tf_pixels(f.read()))
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)["sha256_of_rgb_uint8"]
    assert sorted(digests) == sorted(NAMES)
    for name in NAMES:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            data = f.read()
        got = read_jpeg(path)
        assert got.shape == (900, 1600, 3)
        assert pixel_digest(_tf_pixels(data)) == digests[name]
        assert pixel_digest(got) == digests[name]


def test_decoder_refuses_what_it_does_not_decode():
    """A progressive JPEG and a corrupt one raise; neither is decoded
    approximately."""
    img = _smooth(64, 64)
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(_jpeg(img, quality=90, progressive=True))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n")
    with pytest.raises(ValueError):
        decode_jpeg(_jpeg(img, quality=90)[:200])


@pytest.mark.parametrize("version", ["v1.0-trainval", "LightwheelOcc-v1.0"])
def test_camera_matrices_bitwise_equal_to_jax(version):
    info = _synthetic_info()
    if "Lightwheel" in version:
        for cam in info["cams"].values():
            rot = cam["sensor2lidar_rotation"]
            qw = np.sqrt(max(np.trace(rot) + 1.0, 1e-12)) / 2.0
            cam["sensor2lidar_rotation"] = np.array([
                qw, (rot[2, 1] - rot[1, 2]) / (4 * qw),
                (rot[0, 2] - rot[2, 0]) / (4 * qw),
                (rot[1, 0] - rot[0, 1]) / (4 * qw)])
    ours = nuscenes.build_camera_matrices(info, version)
    theirs = jax_nusc.build_camera_matrices(info, version)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        if k == "img_paths":
            assert ours[k] == theirs[k]
        else:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k])
    assert nuscenes.CAM_ORDER == jax_nusc.CAM_ORDER


def _assert_samples_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in theirs:
        if isinstance(theirs[k], np.ndarray):
            assert ours[k].dtype == theirs[k].dtype, k
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        else:
            assert ours[k] == theirs[k], k


def test_dataset_samples_bitwise_equal_to_jax(tmp_path):
    """`get_sample` key by key against JAX's with device_normalize=True
    (uint8 images, unpadded), a frame without its labels.npz included
    (zeros at data.occ_size); `collate`, tokens and `load_occ_gt`."""
    root = str(tmp_path)
    ann = _write_miniset(root, 3, IMG_HW, grid=GRID, n_scenes=2)
    with open(ann, "rb") as f:
        payload = pickle.load(f)
    payload["infos"][2]["occ_path"] = "openocc_v2/missing/labels.npz"
    with open(ann, "wb") as f:
        pickle.dump(payload, f)
    data = dataclasses.replace(get_config("tiny_occ").data, data_root=root,
                               occ_size=GRID)
    jdata = dataclasses.replace(jax_get_config("tiny_occ").data,
                                data_root=root, occ_size=GRID)
    ds = nuscenes.NuSceneOccDataset(data, ann, training=False)
    jds = jax_nusc.NuSceneOccDataset(jdata, ann, training=False,
                                     device_normalize=True)
    assert len(ds) == len(jds) == 3
    for i in range(3):
        ours, theirs = ds.get_sample(i), jds.get_sample(i)
        _assert_samples_equal(ours, theirs)
        assert ours["img"].dtype == np.uint8
        assert ours["img"].shape == (6, *IMG_HW, 3)
        assert ds.sample_token(i) == jds.sample_token(i)
    assert not ds.get_sample(2)["voxel_semantics"].any()
    batch, jbatch = (d.collate([d.get_sample(0), d.get_sample(1)])
                     for d in (ds, jds))
    assert batch["tokens"] == jbatch["tokens"] == ["tok0", "tok1"]
    for k in ("img", "ego2img", "voxel_semantics", "voxel_flow"):
        np.testing.assert_array_equal(batch[k], jbatch[k])
    occ = os.path.join(root, payload["infos"][0]["occ_path"])
    from occnet_tpu.data.pipeline import load_occ_gt as jax_load_occ_gt
    for path in (occ, None, os.path.join(root, "absent.npz")):
        for a, b in zip(load_occ_gt(path, GRID), jax_load_occ_gt(path, GRID)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_lightwheel_concat_train_dataset_equals_jax(tmp_path):
    """`build_train_dataset` with an extra LightwheelOcc train set: the
    ConcatOccDataset's samples (the quaternion branch in the second half)
    bitwise equal to JAX's; without extras the plain dataset."""
    nusc_root, lw_root = str(tmp_path / "nusc"), str(tmp_path / "lw")
    os.makedirs(nusc_root), os.makedirs(lw_root)
    _write_miniset(nusc_root, 2, IMG_HW, grid=GRID,
                   ann_name="infos_train.pkl")
    _write_miniset(lw_root, 2, IMG_HW, grid=GRID,
                   version="LightwheelOcc-v1.0", ann_name="lw_train.pkl")
    kw = dict(data_root=nusc_root, train_ann="infos_train.pkl",
              occ_size=GRID, extra_trainsets=((lw_root, "lw_train.pkl"),))
    ds = nuscenes.build_train_dataset(
        dataclasses.replace(get_config("base_occ_w_lightwheel").data, **kw))
    jds = jax_nusc.build_train_dataset(
        dataclasses.replace(jax_get_config("base_occ_w_lightwheel").data,
                            **kw), device_normalize=True)
    assert isinstance(ds, nuscenes.ConcatOccDataset) and len(ds) == 4
    for i in range(4):
        assert ds.sample_token(i) == jds.sample_token(i)
        _assert_samples_equal(ds.get_sample(i), jds.get_sample(i))
    assert ds.datasets[1].version == "LightwheelOcc-v1.0"
    plain = nuscenes.build_train_dataset(dataclasses.replace(
        get_config("tiny_occ").data, **{**kw, "extra_trainsets": ()}))
    assert isinstance(plain, nuscenes.NuSceneOccDataset) and len(plain) == 2


def test_contiguous_sampler_and_devkit_scanner_equal_jax():
    for n, shards in ((10, 1), (10, 3), (7, 4), (1, 2)):
        for s in range(shards):
            np.testing.assert_array_equal(
                sampler.contiguous_shard_indices(n, shards, s),
                jax_sampler.contiguous_shard_indices(n, shards, s))
            np.testing.assert_array_equal(
                sampler.shuffled_shard_indices(n, shards, s, 3, 1),
                jax_sampler.shuffled_shard_indices(n, shards, s, 3, 1))
    tables, _ = _fabricate()
    rows = {k: tables.table(k) for k in jax_devkit.NuScenesTables.TABLES}
    ours = devkit_ego_pose.EgoPoseScanner(
        devkit_ego_pose.NuScenesTables("/nonexistent", tables=rows))
    theirs = jax_devkit.EgoPoseScanner(tables)
    assert len(ours) == len(theirs) and ours.flip_flags == theirs.flip_flags
    for i in range(len(theirs)):
        (tok, o), (jtok, jo) = ours[i], theirs[i]
        assert tok == jtok
        np.testing.assert_array_equal(o, jo)
    split = devkit_ego_pose.EgoPoseScanner(
        devkit_ego_pose.NuScenesTables("/nonexistent", tables=rows),
        split_scenes=["sg-1"], max_origins=1)
    assert len(split) == 2 and split[1][1].shape == (1, 3)
