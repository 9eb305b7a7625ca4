"""Reference PyTorch checkpoints into the port (`utils/torch_convert.py`)
against the JAX package's converters on the CPU: a fabricated reference
BEVFormerOcc state dict and a torchvision-layout ResNet-50 go through JAX's
`load_*_into_variables` and then `convert.from_jax_variables`, and through
the port's `load_*_into_state_dict`; the two give the same tensors bit for
bit.  Then the train CLI on the nuScenes-layout miniset with
`--backbone-checkpoint`, `--autoscale-lr` and `--eval-dynamic-intervals`."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from occnet_tpu import config as jax_config
from occnet_tpu.training.train import make_lr_schedule as jax_lr_schedule
from occnet_tpu.utils.torch_convert import (load_bevformer_into_variables,
                                            load_resnet_into_variables)
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.utils.torch_convert import (
    load_bevformer_into_state_dict, load_resnet_into_state_dict)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from test_convert_vis import _fake_torchvision_resnet50_sd  # noqa: E402
from test_full_convert import _fabricate_state_dict  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401


def _small_gather_cfg():
    """tiny_occ cut to the size of tests/test_full_convert.py's model."""
    cfg = config.tiny_occ()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, img_h=64, img_w=96, bev_h=10, bev_w=10, pillar_h=4,
        embed_dims=32, out_dim=8, compute_dtype="float32",
        encoder=dataclasses.replace(cfg.model.encoder, num_layers=1,
                                    ffn_dim=64, num_points_in_pillar=4)))


def _assert_state_dicts_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(),
                                      err_msg=k)


@pytest.fixture(scope="module")
def small():
    cfg = _small_gather_cfg()
    init = init_jax_style_variables(cfg, seed=0)
    want = randomize_variables(init, seed=1)
    ref = _fabricate_state_dict(want["params"], want["batch_stats"])
    return cfg, init, want, ref


def test_bevformer_checkpoint_bitwise_equal_to_jax(small):
    """Every tensor of the port's state_dict equals JAX's conversion carried
    across by `from_jax_variables` (tolerance 0), the checkpoint's values
    come back exactly, and the model loads it strictly."""
    cfg, init, want, ref = small
    ours = load_bevformer_into_state_dict(from_jax_variables(init), ref,
                                          depth=50, num_encoder_layers=1)
    theirs = from_jax_variables(load_bevformer_into_variables(
        init, ref, depth=50, num_encoder_layers=1))
    _assert_state_dicts_equal(ours, theirs)
    _assert_state_dicts_equal(ours, from_jax_variables(want))
    OccNet(cfg.model).load_state_dict(ours)


def test_bevformer_converter_rejects_mismatches(small):
    """A shape mismatch raises ValueError (as tests/test_full_convert.py:157
    expects of JAX's) and a converted module the model lacks KeyError; the
    input state dict is left as it was."""
    _, init, _, ref = small
    sd = from_jax_variables(init)
    before = {k: v.clone() for k, v in sd.items()}
    bad = dict(ref)
    bad["pts_bbox_head.bev_embedding.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_bevformer_into_state_dict(sd, bad, depth=50,
                                       num_encoder_layers=1)
    extra = dict(ref)
    for k, v in ref.items():
        if ".encoder.layers.0." in k:
            extra[k.replace(".encoder.layers.0.", ".encoder.layers.1.")] = v
    with pytest.raises(KeyError, match="unexpected converted key"):
        load_bevformer_into_state_dict(sd, extra, depth=50,
                                       num_encoder_layers=2)
    _assert_state_dicts_equal(sd, before)


def test_torchvision_resnet_bitwise_equal_to_jax(small):
    """The torchvision R50 of tests/test_convert_vis.py:10 into the
    backbone: equal to JAX's `load_resnet_into_variables` carried across,
    conv1 flipped BGR -> RGB, every key outside the backbone untouched."""
    _, init, _, _ = small
    tv = _fake_torchvision_resnet50_sd()
    sd = from_jax_variables(init)
    ours = load_resnet_into_state_dict(sd, tv, depth=50)
    theirs = from_jax_variables(load_resnet_into_variables(init, tv,
                                                           depth=50))
    _assert_state_dicts_equal(ours, theirs)
    np.testing.assert_array_equal(ours["backbone.conv1.weight"].numpy(),
                                  tv["conv1.weight"][:, ::-1])
    for k in sd:
        if not k.startswith("backbone."):
            assert torch.equal(ours[k], sd[k]), k
    no_layer4 = {k: v for k, v in sd.items()
                 if not k.startswith("backbone.layer4_")}
    with pytest.raises(KeyError, match="unexpected converted key"):
        load_resnet_into_state_dict(no_layer4, tv, depth=50)


def _scaled_resnet50(path):
    """The torchvision R50 fixture with conv weights scaled to 1 / sqrt(fan
    in), so that a forward through 16 random blocks stays finite."""
    sd = _fake_torchvision_resnet50_sd()
    for k, v in sd.items():
        if v.ndim == 4:
            sd[k] = v * np.float32(1.0 / np.sqrt(np.prod(v.shape[1:])))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return sd


# tiny_turbo_occ cut to a 64 x 96 input and a 10 x 10 x 4 grid (the full
# ResNet-50 the checkpoint fills is kept)
SMALL_TURBO = ["model.img_h=64", "model.img_w=96", "model.bev_h=10",
               "model.bev_w=10", "model.pillar_h=4", "model.embed_dims=32",
               "model.out_dim=8", "model.encoder.num_layers=1",
               "model.encoder.ffn_dim=64",
               "model.encoder.num_points_in_pillar=4", "data.occ_size=10,10,4"]


def test_train_cli_trains_on_the_miniset_with_a_backbone_checkpoint(
        tmp_path):
    """2 small tiny_turbo_occ steps on a 1-frame nuScenes-layout train split:
    `--autoscale-lr` gives JAX's schedule at lr / 8 (one device; held to
    2.4e-7 relative, two float32 steps: the port evaluates the schedule in
    float64, JAX in float32), `--eval-dynamic-intervals
    2:1` scores the val split after epoch 2 only (JAX's rule: the interval
    of the last milestone reached), and the frozen stem keeps the
    converted conv1 (the checkpoint's, channel-flipped) bit for bit."""
    from occnet_tpu_torch.tools import train as cli
    root = str(tmp_path / "data")
    _write_miniset(root, 1, (64, 96), grid=(10, 10, 4),
                   ann_name="infos_train.pkl")
    _write_miniset(root, 2, (64, 96), grid=(10, 10, 4),
                   ann_name="infos_val.pkl")
    tv = _scaled_resnet50(str(tmp_path / "r50.pth"))
    work = tmp_path / "work"
    history = cli.main([
        "--config", "tiny_turbo_occ", "--device", "cpu", "--work-dir",
        str(work), "--max-steps", "2", "--backbone-checkpoint",
        str(tmp_path / "r50.pth"), "--autoscale-lr",
        "--eval-dynamic-intervals", "2:1", "--set",
        f"data.data_root={root}", "data.train_ann=infos_train.pkl",
        "data.val_ann=infos_val.pkl", "data.workers=2", *SMALL_TURBO])
    steps = [h for h in history if "loss" in h]
    evals = [h for h in history if h.get("tag") == "eval"]
    assert [h["step"] for h in steps] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in steps)
    assert [h["step"] for h in evals] == [2]
    assert np.isfinite(evals[0]["RayIoU"])
    jcfg = jax_config.apply_overrides(jax_config.tiny_turbo_occ(), {
        "optim.lr": jax_config.tiny_turbo_occ().optim.lr / 8.0,
        "optim.steps_per_epoch": 1})
    schedule = jax_lr_schedule(jcfg)
    for h in steps:
        np.testing.assert_allclose(h["lr"], float(schedule(h["step"])),
                                   rtol=2.4e-7)
    with open(work / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["step"] for e in events if e.get("tag") == "eval"] == [2]
    saved = torch.load(work / "ckpt.pt", weights_only=True)
    np.testing.assert_array_equal(
        saved["model"]["backbone.conv1.weight"].numpy(),
        tv["conv1.weight"][:, ::-1])
