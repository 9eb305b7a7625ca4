"""The port's test CLI (`occnet_tpu_torch/tools/test.py`) on the CPU against
the JAX package's functions on a nuScenes-layout miniset: the same
reference checkpoint scores the same within 2e-3, the submission holds the
same tokens, the auto top-K is JAX's, origins come from the full info list
under --max-samples, and a nonzero certificate aborts unless allowed.  The
JAX side runs the model apply, `render_pred_gt` and `RayMetricAccumulator`
directly: the JAX CLI itself is a slow-tier test (its compile time)."""

import dataclasses
import gzip
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import config as jax_config
from occnet_tpu import geometry as jax_geometry
from occnet_tpu.data import nuscenes as jax_nusc
from occnet_tpu.data.pipeline import make_device_normalizer
from occnet_tpu.evaluation import ray_metrics as jax_rm
from occnet_tpu.evaluation.ego_pose import (extract_ego_origins,
                                            pad_origins)
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.models.head import get_occ
from occnet_tpu.utils.torch_convert import load_bevformer_into_variables
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.tools import test as test_cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from test_full_convert import _fabricate_state_dict  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

# tiny_occ at the size of tests/test_full_convert.py's model (one encoder
# layer, the fabricated checkpoint's layout) in fp32, its 50 x 50 x 8 grid
# kept, a static top-K below Q so that the CLI sizes it per camera, and the
# eval's origins padded to the miniset scene's 3 (not 8)
SMALL = ["model.img_h=64", "model.img_w=96", "model.embed_dims=32",
         "model.out_dim=8", "model.compute_dtype=float32",
         "model.encoder.num_layers=1", "model.encoder.ffn_dim=64",
         "model.encoder.num_points_in_pillar=4",
         "model.encoder.sca.max_queries_per_cam=2048", "eval.max_origins=3"]
SCORE_ATOL = 2e-3


@pytest.fixture(scope="module")
def miniset(tmp_path_factory):
    """3 frames of one scene, and a reference checkpoint fabricated from
    random weights."""
    tmp = tmp_path_factory.mktemp("miniset")
    root = str(tmp / "data")
    cfg = config.apply_overrides(config.tiny_occ(), dict(
        kv.split("=", 1) for kv in SMALL))
    m = cfg.model
    ann = _write_miniset(root, 3, (m.img_h, m.img_w),
                         grid=(m.bev_w, m.bev_h, m.pillar_h))
    v = randomize_variables(init_jax_style_variables(cfg, seed=0), seed=1)
    ref = _fabricate_state_dict(v["params"], v["batch_stats"])
    pth = str(tmp / "ref.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(a))
                               for k, a in ref.items()}}, pth)
    return root, ann, pth, ref


def _run(miniset, tmp_path, *extra, sets=()):
    root, _, pth, _ = miniset
    return test_cli.main([
        "--config", "tiny_occ", "--device", "cpu", "--torch-checkpoint",
        pth, "--work-dir", str(tmp_path / "work"), "--out",
        str(tmp_path / "sub.gz"), *extra, "--set", f"data.data_root={root}",
        "data.val_ann=infos_val.pkl", *SMALL, *sets])


def _jax_scores(miniset):
    """JAX's scores of the same checkpoint on the miniset, and its auto
    top-K: JAX's `calibration_topk` on the first frame, the JAX converter,
    model apply, `render_pred_gt` and `RayMetricAccumulator`."""
    root, ann, _, ref = miniset
    jcfg = jax_config.apply_overrides(jax_config.tiny_occ(), dict(
        kv.split("=", 1) for kv in SMALL + [f"data.data_root={root}"]))
    ds = jax_nusc.NuSceneOccDataset(jcfg.data, ann, training=False,
                                    device_normalize=True)
    first = ds.get_sample(0)
    ks = jax_geometry.calibration_topk(jcfg.model,
                                       jnp.asarray(first["ego2img"][None]),
                                       per_camera=True)
    jcfg = jax_config.apply_overrides(
        jcfg, {"model.encoder.sca.per_cam_topk": ks})
    init = init_jax_style_variables(config.apply_overrides(
        config.tiny_occ(), dict(kv.split("=", 1) for kv in SMALL)), seed=0)
    v = load_bevformer_into_variables(init, ref, depth=50,
                                      num_encoder_layers=1)
    model = JaxOccNet(jcfg.model)
    norm = make_device_normalizer(jcfg.data)
    infer = jax.jit(lambda p, bs, i, e: model.apply(
        {"params": p, "batch_stats": bs}, norm(i), e))
    origins = dict(extract_ego_origins(ds.infos))
    rays = jnp.asarray(jax_rm.generate_lidar_rays())
    acc = jax_rm.RayMetricAccumulator()
    for i in range(len(ds)):
        s = ds.get_sample(i)
        occ, flow = get_occ(infer(v["params"], v["batch_stats"],
                                  jnp.asarray(s["img"][None]),
                                  jnp.asarray(s["ego2img"][None])))
        padded, valid = pad_origins(origins[s["token"]],
                                    jcfg.eval.max_origins)
        pred, gt = jax_rm.render_pred_gt(
            occ[0].astype(jnp.int32), flow[0].astype(jnp.float32),
            jnp.asarray(s["voxel_semantics"]), jnp.asarray(s["voxel_flow"]),
            rays, jnp.asarray(padded), jnp.asarray(valid))
        acc.update(pred, gt)
    return jax_rm.occ_score_from_metrics(acc.finalize()), tuple(ks)


def test_test_cli_scores_a_reference_checkpoint_as_jax_does(miniset,
                                                            tmp_path):
    """--eval --format-only on 3 frames: every score within SCORE_ATOL of
    JAX's on the same checkpoint (NaN where JAX's is NaN), the same auto
    top-K, certificate 0, eval_results.json written, and the submission's
    tokens those of the val split."""
    got = _run(miniset, tmp_path, "--eval", "--format-only")
    want, ks = _jax_scores(miniset)
    assert got["per_cam_topk"] == ks and max(ks) < 2048
    assert got["overflow"] == 0 and got["dcn_radii"] is None
    assert got["scores"].keys() == want.keys()
    for k, w in want.items():
        if np.isnan(w):
            assert np.isnan(got["scores"][k]), k
        else:
            assert abs(got["scores"][k] - w) <= SCORE_ATOL, (k, got, want)
    assert 0 < got["scores"]["RayIoU"]
    with open(tmp_path / "work" / "eval_results.json") as f:
        assert json.load(f).keys() == want.keys()
    with gzip.open(tmp_path / "sub.gz", "rb") as f:
        results = pickle.load(f)["results"]
    assert sorted(results) == got["tokens"] == ["tok0", "tok1", "tok2"]
    assert len(got["load_ms"]) == 3


def test_test_cli_origins_from_the_full_infos_and_certificate_abort(
        miniset, tmp_path):
    """A top-K of 1 query a camera overflows the certificate: the CLI
    aborts after the run, and with --allow-topk-overflow it reports the
    count and writes the submission, whose one frame under --max-samples 1
    is rendered from all 3 origins of its scene (`extract_ego_origins` of
    the full info list, 14,040 rays each)."""
    tight = ["--max-samples", "1", "--no-auto-topk"]
    sets = ["model.encoder.sca.max_queries_per_cam=1"]
    with pytest.raises(RuntimeError, match="certificate"):
        _run(miniset, tmp_path, *tight, sets=sets)
    got = _run(miniset, tmp_path, *tight, "--format-only",
               "--allow-topk-overflow", sets=sets)
    assert got["overflow"] > 0 and got["per_cam_topk"] is None
    with gzip.open(tmp_path / "sub.gz", "rb") as f:
        results = pickle.load(f)["results"]
    assert list(results) == got["tokens"] == ["tok0"]
    assert results["tok0"]["pcd_cls"].shape == (3 * 14040,)
