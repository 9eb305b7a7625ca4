"""The port's own config module (`occnet_tpu_torch/config.py`) against the
JAX package's, the port's independence from the JAX package (and from
tensorflow and PIL), and the training and test CLIs' refusal to leave the
card without being asked."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from occnet_tpu import config as jax_config
from occnet_tpu_torch import config
from _torch_threads import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OVERRIDES = {
    "optim.lr": "1e-4",
    "model.compute_dtype": "float32",
    "model.use_grid_mask": "false",
    "model.encoder.sca.per_cam_topk": "(1024,2048,1024,2048,1024,2048)",
    "model.backbone.dcn_window_radii": "1,2,3",
    "model.backbone.dcn_stages": "(0,0,1,1)",
    "data.occ_size": "(50,50,8)",
}


@pytest.mark.parametrize("name", sorted(jax_config.CONFIGS))
def test_named_config_equals_jax(name):
    """Every named config, as built and after dotted overrides of each leaf
    type (float, str, bool, empty-default and typed tuples)."""
    assert sorted(config.CONFIGS) == sorted(jax_config.CONFIGS)
    ours, theirs = config.get_config(name), jax_config.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    ours = config.apply_overrides(ours, OVERRIDES)
    theirs = jax_config.apply_overrides(theirs, OVERRIDES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.model.backbone.dcn_window_radii == (1, 2, 3)


def test_class_names_and_unknown_config():
    assert config.FLOW_CLASS_NAMES == jax_config.FLOW_CLASS_NAMES
    assert config.OCC_CLASS_NAMES == jax_config.OCC_CLASS_NAMES
    with pytest.raises(KeyError, match="unknown config"):
        config.get_config("r50_dcn_occ")


def test_port_modules_import_without_the_jax_package():
    """Every module of `occnet_tpu_torch` (the evaluation and data slices'
    among them) imports with `occnet_tpu`, `jax`, `flax`, `tensorflow` and
    `PIL` made to fail, and none of them is loaded afterwards."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'flax', 'jaxlib', 'occnet_tpu', 'tensorflow',\n"
        "             'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import occnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    occnet_tpu_torch.__path__, 'occnet_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k, m in sys.modules.items() if m is not None and\n"
        "       k.split('.')[0] in ('jax', 'flax', 'jaxlib', 'occnet_tpu',\n"
        "                           'tensorflow', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('IMPORTED', ' '.join(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    mods = set(r.stdout.split("IMPORTED")[1].split())
    assert len(mods) >= 45, r.stdout
    # the evaluation slice's modules among them
    assert {f"occnet_tpu_torch.{m}" for m in (
        "ops.lift_pass2", "ops.ray_march", "ops.ray_march_vec",
        "evaluation", "evaluation.ray_metrics", "evaluation.ego_pose",
        "data.quat", "data.synthetic", "data.loader", "data.sampler",
        "training.eval_loop", "tools.bench_lift_passes",
        "tools.bench_ray_march", "tools.synth_learn")} <= mods, r.stdout
    # and the data / conversion / offline-CLI slice's
    assert {f"occnet_tpu_torch.{m}" for m in (
        "data.jpeg", "data.nuscenes", "data.devkit_ego_pose",
        "data.pipeline", "utils", "utils.torch_convert",
        "evaluation.submission", "tools.test", "tools.ray_casting",
        "tools.metric", "tools.train")} <= mods, r.stdout
    # and the temporal slice's
    assert {f"occnet_tpu_torch.{m}" for m in (
        "ops.transforms", "training.temporal", "data.clips")} <= mods, \
        r.stdout
    # and the runtime slice's
    assert {f"occnet_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.multihost",
        "training.checkpoint", "utils.events", "utils.profiling", "entry",
        "tools.bench", "tools.step_noise")} <= mods, r.stdout
    # and the VoVNet / detection / library slice's
    assert {f"occnet_tpu_torch.{m}" for m in (
        "models.vovnet", "models.decoder", "models.perception",
        "models.bbox", "models.positional", "ops.render_diff",
        "ops.ray_march_fast", "utils.vis")} <= mods, r.stdout


def test_train_cli_needs_the_card_or_device_cpu(monkeypatch, tmp_path):
    """With no CUDA device and no --device, the train CLI, the test CLI and
    the ray-casting CLI exit naming `--device cpu` before they write
    anything; with it, the train CLI trains.  --distributed asking for
    NCCL without a card raises naming gloo (never carries on without the
    device), and --temporal-queue exits on a synthetic source, which has no
    clips."""
    from occnet_tpu_torch.tools import ray_casting, test, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--config", "tiny_turbo_occ", "--synthetic-data",
            "--max-steps", "1", "--set", "model.img_h=64", "model.img_w=96",
            "model.bev_h=8", "model.bev_w=8", "model.pillar_h=4",
            "model.embed_dims=32", "model.out_dim=8",
            "model.encoder.num_layers=1", "model.encoder.ffn_dim=32"]
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(argv)
    monkeypatch.setenv("WORLD_SIZE", "1")
    for cli in (train, test):
        with pytest.raises(RuntimeError, match="gloo"):
            cli.main(argv[:2] + ["--distributed", "--dist-backend", "nccl",
                                 "--device", "cpu"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="no clips"):
        train.main(argv + ["--temporal-queue=2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device cpu"):
        test.main(["--config", "tiny_occ", "--eval"])
    with pytest.raises(SystemExit, match="--device cpu"):
        ray_casting.main(["--pred-dir", "p", "--infos", "i.pkl"])
    assert not os.listdir(tmp_path)
    history = train.main(argv + ["--device", "cpu", "--work-dir",
                                 str(tmp_path / "run")])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert os.path.exists(tmp_path / "run" / "ckpt.pt")
