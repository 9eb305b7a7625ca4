"""The port's evaluation path against the JAX package's on the CPU: the
synthetic geometric benchmark (scenes, rig, palette, rendered views, the
dataset protocol), ego origins, the ray-metric render + counts, and
`run_evaluation` of a tiny synthetic turbo model with the same weights
(carried over by `convert.from_jax_variables`); then the train CLI's eval
hook on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import config as jax_config
from occnet_tpu.data import synthetic as jax_syn
from occnet_tpu.evaluation import ego_pose as jax_ego
from occnet_tpu.evaluation import ray_metrics as jax_rm
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.training import eval_loop as jax_eval_loop
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.data import synthetic as syn
from occnet_tpu_torch.evaluation import ego_pose
from occnet_tpu_torch.evaluation import ray_metrics as rm
from occnet_tpu_torch.serve import Predictor
from occnet_tpu_torch.training.eval_loop import run_evaluation

OCC_SIZE = (20, 20, 6)
PC_RANGE = (-8.0, -8.0, -1.0, 8.0, 8.0, 3.8)    # cubic 0.8 m voxels
IMG_HW = (32, 64)
# a micro synthetic turbo config (the JAX CLI test's geometry), one origin
TINY = {"model.img_h": "32", "model.img_w": "64", "model.bev_h": "20",
        "model.bev_w": "20", "model.pillar_h": "6", "model.embed_dims": "48",
        "model.out_dim": "8", "model.num_cams": "2",
        "model.compute_dtype": "float32",
        "model.pc_range": "-8,-8,-1,8,8,3.8", "model.encoder.num_layers": "1",
        "model.encoder.ffn_dim": "64",
        "model.encoder.num_points_in_pillar": "2",
        "data.occ_size": "20,20,6", "data.workers": "2",
        "eval.occ_size": "20,20,6", "eval.voxel_size": "0.8",
        "eval.pc_range": "-8,-8,-1,8,8,3.8", "eval.max_origins": "1"}


def test_fan_scene_rig_palette_bitwise_equal_to_jax():
    np.testing.assert_array_equal(rm.generate_lidar_rays(),
                                  jax_rm.generate_lidar_rays())
    assert rm.generate_lidar_rays().shape == (14040, 3)
    np.testing.assert_array_equal(syn.class_palette(),
                                  jax_syn.class_palette())
    for seed, size in ((0, OCC_SIZE), (5, (50, 50, 8)), (7, (200, 200, 16))):
        for a, b in zip(syn.make_scene(seed, size),
                        jax_syn.make_scene(seed, size)):
            np.testing.assert_array_equal(a, b)
    for n, hw in ((2, IMG_HW), (6, (928, 1600))):
        ours, theirs = syn.ring_camera_rig(n, hw), \
            jax_syn.ring_camera_rig(n, hw)
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k])


def test_render_views_matches_jax():
    rig = syn.ring_camera_rig(6, IMG_HW)
    pal = syn.class_palette()
    for seed in range(3):
        sem, _ = syn.make_scene(seed, OCC_SIZE)
        want = np.asarray(jax_syn.render_views(
            jnp.asarray(sem), jnp.asarray(rig["R"]), jnp.asarray(rig["t"]),
            jnp.asarray(rig["K"]), jnp.asarray(pal), IMG_HW, PC_RANGE, 50))
        got = syn.render_views(torch.from_numpy(sem), rig["R"], rig["t"],
                               rig["K"], pal, IMG_HW, PC_RANGE, 50)
        assert got.dtype == torch.uint8 and got.shape == want.shape
        assert (got.numpy() != want).any(-1).mean() <= 1e-3


def _assert_scores_equal(got, want):
    """RayIoU from integer counts: exactly; mAVE / OccScore from fp32 flow
    sums in another order: 1e-6 relative."""
    assert got.keys() == want.keys()
    for k in want:
        if k.startswith("RayIoU"):
            assert got[k] == want[k], (k, got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def _grids(seed, size=(200, 200, 16)):
    rng = np.random.RandomState(seed)
    sem_gt = np.full(size, 16, np.int32)
    blob = rng.rand(*size) < 0.01
    sem_gt[blob] = rng.randint(0, 16, int(blob.sum()))
    sem_pred = sem_gt.copy()
    flip = rng.rand(*size) < 0.002
    sem_pred[flip] = rng.randint(0, 17, int(flip.sum()))
    flow_gt = rng.randn(*size, 2).astype(np.float32)
    flow_pred = flow_gt + 0.3 * rng.randn(*size, 2).astype(np.float32)
    return sem_pred, flow_pred, sem_gt, flow_gt


def test_render_pred_gt_counts_bitwise_equal_to_jax():
    sem_pred, flow_pred, sem_gt, flow_gt = _grids(1)
    rays = rm.generate_lidar_rays()
    origins = np.array([[0.5, 0.3, 1.8], [5.0, -3.0, 1.9], [0.0, 0.0, 0.0]],
                       np.float32)
    valid = np.array([True, True, False])
    pj, gj = jax_rm.render_pred_gt(
        *(jnp.asarray(a) for a in (sem_pred, flow_pred, sem_gt, flow_gt)),
        jnp.asarray(rays), jnp.asarray(origins), jnp.asarray(valid))
    pp, gp = rm.render_pred_gt(
        *(torch.from_numpy(a) for a in (sem_pred, flow_pred, sem_gt,
                                        flow_gt)), rays, origins, valid)
    for ours, theirs in ((pp, pj), (gp, gj)):
        for k in ("label", "valid", "flow"):
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]))
        np.testing.assert_allclose(ours["dist"].numpy(),
                                   np.asarray(theirs["dist"]), rtol=1e-6,
                                   atol=0)
    accs = []
    for count in (lambda: rm.count_sample(pp, gp),
                  lambda: jax_rm._count_sample(pj, gj)):
        acc = rm.RayMetricAccumulator()
        acc.update_counts(count())
        accs.append(acc)
    for k in ("gt_cnt", "pred_cnt", "tp_cnt", "ave_cnt"):
        np.testing.assert_array_equal(getattr(accs[0], k),
                                      getattr(accs[1], k))
    # fp32 sums of the flow errors, in another order
    np.testing.assert_allclose(accs[0].ave_sum, accs[1].ave_sum, rtol=1e-6)
    jacc = jax_rm.RayMetricAccumulator()
    jacc.update(pj, gj)
    ours = rm.occ_score_from_metrics(accs[0].finalize())
    _assert_scores_equal(ours, jax_rm.occ_score_from_metrics(
        jacc.finalize()))
    assert 0.5 < ours["RayIoU"] < 1.0
    assert "MEAN" in rm.format_metrics_table(accs[0].finalize())
    # ground truth against itself scores a perfect RayIoU
    same = rm.RayMetricAccumulator()
    same.update(gp, gp)
    assert rm.occ_score_from_metrics(same.finalize())["RayIoU"] == 1.0


def _tiny_data_model():
    cfg = config.synth_tiny_occ()
    model = dataclasses.replace(cfg.model, img_h=IMG_HW[0], img_w=IMG_HW[1],
                                num_cams=2, pc_range=PC_RANGE)
    return dataclasses.replace(cfg.data, occ_size=OCC_SIZE), model


def test_dataset_protocol_cache_and_ego_origins(tmp_path):
    data, model = _tiny_data_model()
    ds = syn.SyntheticOccDataset(data, model, 3, seed=0, device="cpu",
                                 cache_dir=str(tmp_path))
    jds = jax_syn.SyntheticOccDataset(data, model, 3, seed=0)
    assert len(ds) == 3 and ds.infos == jds.infos
    assert [ds.sample_token(i) for i in range(3)] == \
        ["synth-0", "synth-1", "synth-2"]
    for (img, sem, flow), (jimg, jsem, jflow) in zip(ds.samples,
                                                     jds.samples):
        assert (img != jimg).any(-1).mean() <= 1e-3
        np.testing.assert_array_equal(sem, jsem)
        np.testing.assert_array_equal(flow, jflow)
    rng = np.random.RandomState(0)
    s, js = ds.get_sample(0, rng), jds.get_sample(0, rng)
    assert s.keys() == js.keys()
    assert s["img"].dtype == np.float32 and s["img"].shape == js["img"].shape
    batch = ds.collate([ds.get_sample(i) for i in range(2)])
    assert batch["img"].shape == (2, 2, *IMG_HW, 3)
    assert batch["tokens"] == ["synth-0", "synth-1"]
    # the cache: a second construction loads the same scenes, no render
    assert len(os.listdir(tmp_path)) == 1
    again = syn.SyntheticOccDataset(data, model, 3, seed=0, device="cpu",
                                    cache_dir=str(tmp_path))
    assert again.render_ms == [] and len(ds.render_ms) == 3
    for a, b in zip(ds.samples, again.samples):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # render_scale: a low-res cast pixel-repeated to the model size, uint8
    ds2 = syn.SyntheticOccDataset(data, model, 1, seed=0, training=False,
                                  render_scale=2, device_normalize=True,
                                  device="cpu")
    raw = ds2.get_sample(0)["img"]
    assert raw.dtype == np.uint8 and raw.shape == (2, *IMG_HW, 3)
    assert (raw[:, ::2, ::2] == raw[:, 1::2, ::2]).all()
    assert (raw[:, ::2, ::2] == raw[:, ::2, 1::2]).all()
    # ego origins of the synthetic infos and of a multi-frame scene
    assert dict(ego_pose.extract_ego_origins(ds.infos)).keys() == \
        {"synth-0", "synth-1", "synth-2"}
    infos = [{"token": f"t{i}", "scene_token": "s",
              "occ_path": f"openocc_v2/scene-X/t{i}/labels.npz",
              "lidar2ego_translation": [0.9, 0.1 * i, 1.8],
              "lidar2ego_rotation": [np.cos(0.1 * i), 0, 0, np.sin(0.1 * i)],
              "ego2global_translation": [7.0 * i, 2.0 * i, 0.0],
              "ego2global_rotation": [1.0, 0, 0, 0]} for i in range(12)]
    for dataset_type in ("openocc_v2", "occ3d"):
        ours = ego_pose.extract_ego_origins(infos, dataset_type)
        theirs = jax_ego.extract_ego_origins(infos, dataset_type)
        for (ta, oa), (tb, ob) in zip(ours, theirs):
            assert ta == tb
            np.testing.assert_array_equal(oa, ob)
    for o in (ours[0][1], np.zeros((0, 3), np.float32)):
        for a, b in zip(ego_pose.pad_origins(o, 8), jax_ego.pad_origins(o, 8)):
            np.testing.assert_array_equal(a, b)


def test_run_evaluation_matches_jax():
    """Same weights and frames: the scores within 2e-3; the port's render
    and counts fed JAX's predicted grids give exactly JAX's scores."""
    jcfg = jax_config.apply_overrides(jax_config.synth_tiny_turbo_occ(),
                                      TINY)
    cfg = config.apply_overrides(config.synth_tiny_turbo_occ(), TINY)
    ds = syn.SyntheticOccDataset(cfg.data, cfg.model, 3, seed=0,
                                 training=False, device="cpu")
    jm = JaxOccNet(jcfg.model)
    # the flax tree, drawn by the port's numpy init (the flax init runs the
    # forward eagerly, ~25 s here); tests/test_torch_model.py holds the two
    # trees equal
    v = randomize_variables(init_jax_style_variables(cfg, seed=0), seed=1)
    quiet = dict(log=lambda *a: None)
    want = jax_eval_loop.run_evaluation(jcfg, jm, v["params"],
                                        v["batch_stats"], ds, **quiet)
    pred = Predictor(cfg, from_jax_variables(v), "cpu")
    got = run_evaluation(cfg, pred, ds, **quiet)
    assert set(got) == set(want)
    assert np.isfinite(got["RayIoU"])
    for k in want:
        if np.isfinite(want[k]):
            assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])

    # the jitted apply JAX's run_evaluation compiled above
    infer = jax_eval_loop._cached_infer(jm, jcfg.data)

    class JaxPredictions:
        """JAX's decoded grids behind the Predictor call signature."""
        device = torch.device("cpu")

        def __call__(self, img, e2i):
            outs = infer(v["params"], v["batch_stats"], jnp.asarray(img),
                         jnp.asarray(e2i))
            return (torch.from_numpy(np.asarray(
                jnp.argmax(outs["occ"].astype(jnp.float32), -1))),
                    torch.from_numpy(np.asarray(outs["flow"], np.float32)))

    _assert_scores_equal(run_evaluation(cfg, JaxPredictions(), ds, **quiet),
                         want)


def test_predictor_wrap_shares_the_model():
    from occnet_tpu_torch.models.detector import OccNet
    cfg = config.apply_overrides(config.synth_tiny_turbo_occ(), TINY)
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(init_jax_style_variables(cfg)))
    pred = Predictor.wrap(cfg, model)
    assert pred.model is model and pred.device == torch.device("cpu")
    img = np.random.RandomState(0).randint(0, 256, (1, 2, *IMG_HW, 3),
                                           dtype=np.uint8)
    occ, flow = pred(img, syn.ring_camera_rig(2, IMG_HW)["ego2img"][None])
    assert occ.shape == (1, 20, 20, 6) and flow.shape == (1, 20, 20, 6, 2)


def test_train_cli_evaluates_synthetic_geometric(tmp_path):
    """--synthetic-geometric 2 --eval-interval-epochs 1 --max-steps 2 on the
    CPU: two steps (one epoch), then one evaluation on max(8, 2 // 16) = 8
    held-out scenes, in the returned history and in metrics.jsonl."""
    from occnet_tpu_torch.tools import train
    work = tmp_path / "run"
    history = train.main(
        ["--config", "synth_tiny_turbo_occ", "--device", "cpu",
         "--synthetic-geometric", "2", "--eval-interval-epochs", "1",
         "--max-steps", "2", "--work-dir", str(work), "--set"]
        + [f"{k}={v}" for k, v in TINY.items()])
    steps = [h for h in history if "loss" in h]
    evals = [h for h in history if h.get("tag") == "eval"]
    assert len(steps) == 2 and all(np.isfinite(h["loss"]) for h in steps)
    assert len(evals) == 1 and evals[0]["step"] == 2
    assert np.isfinite(evals[0]["RayIoU"])
    with open(work / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [e["step"] for e in lines if e.get("tag") == "eval"] == [2]


def test_synth_learn_runs_the_turbo_arm(tmp_path):
    """The learnability tool on the CPU at the micro size: 2 steps with an
    evaluation after step 1, the final val and train-split scores, and the
    JSON summary."""
    from occnet_tpu_torch.tools import synth_learn
    out = tmp_path / "synth.json"
    res = synth_learn.main(
        ["--configs", "synth_tiny_turbo_occ", "--device", "cpu", "--scenes",
         "2", "--val-scenes", "1", "--steps", "2", "--batch", "1",
         "--eval-every", "1", "--log-interval", "1", "--out", str(out),
         "--set"] + [f"{k}={v}" for k, v in TINY.items()])
    (r,) = res["results"]
    assert [h["step"] for h in r["history"]] == [0, 1, 1]
    assert np.isfinite(r["history"][-1]["eval"]["RayIoU"])
    assert np.isfinite(r["final_loss"]) and np.isfinite(
        r["scores"]["RayIoU"]) and np.isfinite(r["train_scores"]["RayIoU"])
    assert json.loads(out.read_text())["results"][0]["config"] == \
        "synth_tiny_turbo_occ"


@pytest.mark.parametrize("name", ["synth_tiny_occ"])
def test_synth_learn_runs_the_exact_encoder(tmp_path, name):
    """The exact (gather) arm trains: 2 steps of synth_tiny_occ at the tiny
    size on the CPU, finite loss and RayIoU, certificate 0 over the run."""
    from occnet_tpu_torch.tools import synth_learn
    res = synth_learn.main(
        ["--configs", name, "--device", "cpu", "--scenes", "2",
         "--val-scenes", "1", "--steps", "2", "--batch", "1",
         "--log-interval", "1", "--out", str(tmp_path / "synth.json"),
         "--set"] + [f"{k}={v}" for k, v in TINY.items()])
    (r,) = res["results"]
    assert r["config"] == name and [h["step"] for h in r["history"]] == [0, 1]
    assert np.isfinite(r["final_loss"]) and np.isfinite(
        r["scores"]["RayIoU"])
    assert r["cert_overflow_total"] == 0
