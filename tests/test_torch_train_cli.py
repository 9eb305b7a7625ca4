"""The port's train CLI (`occnet_tpu_torch/tools/train.py`) on the CPU at a
small size: it aborts on a nonzero exactness certificate (the top-K of the
gather encoder, the window DCN), as the JAX package's `tools/train.py`
does, and it saves every epoch and resumes from there.  Its own file, so
that the test runner spreads these runs apart from `test_torch_train.py`."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from occnet_tpu_torch import config as config_mod
from occnet_tpu_torch import convert
from occnet_tpu_torch.tools import train as cli
from occnet_tpu_torch.training import checkpoint
from occnet_tpu_torch.training.train import create_train_state, make_train_step
from _torch_threads import one_torch_thread  # noqa: E402,F401

# the small model of `tests/test_torch_train.small_cfg` as CLI overrides
CLI_SMALL = ["model.img_h=64", "model.img_w=96", "model.bev_h=10",
             "model.bev_w=10", "model.pillar_h=4", "model.embed_dims=32",
             "model.out_dim=8", "model.encoder.num_layers=1",
             "model.encoder.ffn_dim=64",
             "model.encoder.num_points_in_pillar=4"]


def _cli(work_dir, *args):
    return cli.main(["--device", "cpu", "--work-dir", str(work_dir), *args])


def _abort_event(work_dir):
    with open(work_dir / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert events[-1]["tag"] == "abort", events
    return events[-1]


def test_cli_aborts_when_the_topk_certificate_fails(tmp_path):
    """A gather config whose static top-K (1 query a camera) drops visible
    queries: the step's `cert_overflow` is nonzero and the CLI aborts at its
    first log, as JAX's `tools/train.py` does, without saving a checkpoint."""
    with pytest.raises(SystemExit, match="exactness certificate"):
        _cli(tmp_path, "--config", "tiny_occ", "--synthetic-data",
             "--max-steps", "2", "--set", *CLI_SMALL,
             "model.encoder.sca.max_queries_per_cam=1")
    assert _abort_event(tmp_path)["cert_overflow"] > 0
    assert not (tmp_path / "ckpt.pt").exists()


def _offsets_above_one_px(init):
    """``init`` with every DCN conv_offset bias at 1.5 px on its 18 offset
    channels: floor(offset) = 1 everywhere."""
    def wrapped(cfg, seed=0):
        v = init(cfg, seed)
        for stage in v["params"]["backbone"].values():
            co = stage.get("conv2", {}).get("conv_offset")
            if co is not None:
                co["bias"][:18] = 1.5
        return v
    return wrapped


def test_window_dcn_certificate_reaches_the_step_and_aborts_the_cli(
        tmp_path, monkeypatch):
    """`turbo_r101_dcn_occ` cut to a small ResNet-50 with window DCN in its
    last stage at radius 0, offsets of 1.5 px: the train step sums
    `dcn_window_overflow` into a nonzero `cert_overflow` (JAX's
    `collect_overflow` sums every `*_overflow`), and the CLI aborts."""
    init = _offsets_above_one_px(convert.init_jax_style_variables)
    cfg = config_mod.apply_overrides(config_mod.turbo_r101_dcn_occ(), dict(
        kv.split("=", 1) for kv in CLI_SMALL))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(
            cfg.model.backbone, type="resnet50",
            dcn_stages=(False, False, False, True), dcn_window_radius=0)))
    state = create_train_state(cfg, convert.from_jax_variables(init(cfg, 0)),
                               "cpu")
    met = make_train_step(cfg)(state, cli.to_device(cli.make_synthetic_batch(
        cfg, 1, np.random.RandomState(0)), "cpu"))
    assert int(met["cert_overflow"]) > 0 and np.isfinite(float(met["loss"]))

    monkeypatch.setattr(convert, "init_jax_style_variables", init)
    monkeypatch.setattr(config_mod, "get_config", lambda name: cfg)
    with pytest.raises(SystemExit, match="exactness certificate"):
        _cli(tmp_path, "--config", "turbo_r101_dcn_occ", "--synthetic-data",
             "--max-steps", "2")
    assert _abort_event(tmp_path)["cert_overflow"] == float(
        met["cert_overflow"])


def test_cli_saves_every_epoch_and_resumes(tmp_path):
    """`synth_tiny_turbo_occ` (cut to a small model on a 25 x 25 x 4 grid of
    1.6 m voxels) on 4 synthetic scenes at B = 2, two steps an epoch, two
    epochs: the checkpoint manager keeps each epoch's checkpoint
    (`ckpt_2.pt`, `ckpt_4.pt`, `ckpt.pt` a link to the newest).  A run
    stopped in its second epoch leaves the first epoch's checkpoint on disk;
    `--resume` from it restarts at step 2 and ends with the weights of the
    uninterrupted run (1e-6)."""
    args = ["--config", "synth_tiny_turbo_occ", "--synthetic-geometric", "4",
            "--set", *CLI_SMALL, "model.bev_h=25", "model.bev_w=25",
            "data.occ_size=(25,25,4)", "data.batch_size_per_device=2",
            "data.workers=1", "optim.total_epochs=2"]
    whole = tmp_path / "whole"
    _cli(whole, *args)
    assert checkpoint.CheckpointManager(str(whole)).all_steps() == [2, 4]
    assert os.readlink(whole / "ckpt.pt") == "ckpt_4.pt"
    (tmp_path / "cut").mkdir()
    shutil.copy(whole / "ckpt_2.pt", tmp_path / "cut" / "ckpt_2.pt")
    history = _cli(tmp_path / "cut", "--resume", *args)
    assert [h["step"] for h in history] == [2, 3]
    want = torch.load(whole / "ckpt_4.pt", weights_only=True)
    resumed = torch.load(tmp_path / "cut" / "ckpt.pt", weights_only=True)
    assert resumed["step"] == 4
    assert json.loads(resumed["config"])["optim"]["total_epochs"] == 2
    for n, a in want["model"].items():
        torch.testing.assert_close(resumed["model"][n], a, rtol=0, atol=1e-6,
                                   msg=n)
