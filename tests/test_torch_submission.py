"""The port's challenge submission (`evaluation/submission.py`) and its
offline CLIs (`tools/ray_casting.py`, `tools/metric.py`) against the JAX
package's on the CPU: the rendered point clouds, the scorer and the merge
of partial files."""

import gzip
import json
import os
import pickle
import sys

import numpy as np
import pytest

from occnet_tpu.evaluation import submission as jax_sub
from occnet_tpu_torch.evaluation import submission as sub
from occnet_tpu_torch.evaluation.ray_metrics import FREE_ID
from occnet_tpu_torch.tools import metric as metric_cli
from occnet_tpu_torch.tools import ray_casting as ray_casting_cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

GRID = (200, 200, 16)
# float16 point clouds of one grid rendered by the two packages: the
# distances are fp32 sums of the same crossings in another order, so after
# rounding to float16 a few rays may land one float16 step apart
F16_ULPS = 1
F16_SHARE = 1e-3


def _grids(seed):
    """A sparse labelled grid (1 % occupied) with flow on half of its
    occupied voxels."""
    rng = np.random.RandomState(seed)
    sem = np.full(GRID, FREE_ID, np.int32)
    occ = rng.rand(*GRID) < 0.01
    sem[occ] = rng.randint(0, FREE_ID, int(occ.sum()))
    flow = np.zeros(GRID + (2,), np.float32)
    moving = occ & (rng.rand(*GRID) < 0.5)
    flow[moving] = rng.randn(int(moving.sum()), 2).astype(np.float32)
    return sem, flow


ORIGINS = [np.array([[0.5, 0.3, 1.8], [5.0, -3.0, 1.9]], np.float32),
           np.array([[-2.0, 1.0, 1.7]], np.float32)]


def _f16_apart(a, b):
    """Share of entries further apart than F16_ULPS float16 steps."""
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    return np.mean(np.abs(a32 - b32) > F16_ULPS * ulp.astype(np.float32))


def test_write_submission_matches_jax(tmp_path):
    """Same grids and origins: pcd_cls equal; pcd_dist and pcd_flow equal
    but for at most F16_SHARE of rays F16_ULPS float16 step apart; the
    same metadata."""
    samples = [(f"tok{i}", *_grids(i), ORIGINS[i]) for i in range(2)]
    ours, theirs = str(tmp_path / "ours.gz"), str(tmp_path / "theirs.gz")
    sub.write_submission(ours, samples)
    jax_sub.write_submission(theirs, samples)
    got, want = sub.load_submission(ours), jax_sub.load_submission(theirs)
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert got["results"].keys() == want["results"].keys()
    for tok, w in want["results"].items():
        g = got["results"][tok]
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
        np.testing.assert_array_equal(g["pcd_cls"], w["pcd_cls"])
        assert (g["pcd_cls"] != FREE_ID).mean() > 0.05
        for k in ("pcd_dist", "pcd_flow"):
            assert _f16_apart(g[k], w[k]) <= F16_SHARE, k
        assert np.abs(w["pcd_flow"]).max() > 0


def _payload_results(seed, tokens, n=3000, flow_classes=True):
    """Random point clouds: classes 0..16 (or only classes without flow),
    distances near 10 m, flows."""
    rng = np.random.RandomState(seed)
    lo = 10 if not flow_classes else 0
    return {t: {"pcd_cls": rng.randint(lo, FREE_ID + 1, n).astype(np.uint8),
                "pcd_dist": (10 + 3 * rng.randn(n)).astype(np.float16),
                "pcd_flow": rng.randn(n, 2).astype(np.float16)}
            for t in tokens}


def _assert_scores_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert (np.isnan(ours[k]) and np.isnan(theirs[k])) \
            or ours[k] == theirs[k], (k, ours[k], theirs[k])


@pytest.mark.parametrize("flow_classes", [True, False])
def test_score_and_merge_bitwise_equal_to_jax(tmp_path, flow_classes):
    """`score_submissions` on the same files gives JAX's numbers exactly,
    NaN for NaN (without flow classes mAVE and OccScore are NaN);
    `merge_submissions` writes JAX's payload, later parts winning."""
    toks = ["a", "b", "c"]
    gt = _payload_results(0, toks, flow_classes=flow_classes)
    pred = {t: {k: v.copy() for k, v in r.items()} for t, r in gt.items()}
    noise = _payload_results(1, toks, flow_classes=flow_classes)
    for t in toks:     # a third of the rays: other class / dist / flow
        pred[t]["pcd_cls"][::3] = noise[t]["pcd_cls"][::3]
        pred[t]["pcd_dist"][1::3] = noise[t]["pcd_dist"][1::3]
        pred[t]["pcd_flow"][::2] = noise[t]["pcd_flow"][::2]
    paths = {}
    for name, res in (("gt", gt), ("pred", pred)):
        paths[name] = str(tmp_path / f"{name}.gz")
        sub.save_submission(paths[name], res)
    ours = sub.score_submissions(paths["pred"], paths["gt"])
    _assert_scores_equal(ours, jax_sub.score_submissions(paths["pred"],
                                                         paths["gt"]))
    assert np.isnan(ours["OccScore"]) != flow_classes
    assert 0 < ours["RayIoU"] < 1
    parts = []
    for i, keep in enumerate((["a", "b"], ["b", "c"])):
        parts.append(str(tmp_path / f"part{i}.gz"))
        sub.save_submission(parts[-1], {t: (pred if i else gt)[t]
                                        for t in keep}, meta={"team": "x"})
    outs = [str(tmp_path / "merged.gz"), str(tmp_path / "jmerged.gz")]
    assert sub.merge_submissions(parts, outs[0]) == \
        jax_sub.merge_submissions(parts, outs[1]) == 3
    got, want = (pickle.load(gzip.open(p, "rb")) for p in outs)
    assert got.keys() == want.keys() and got["team"] == "x"
    for t in toks:
        for k, v in want["results"][t].items():
            np.testing.assert_array_equal(got["results"][t][k], v)
    np.testing.assert_array_equal(got["results"]["b"]["pcd_cls"],
                                  pred["b"]["pcd_cls"])


def test_ray_casting_and_metric_clis(tmp_path):
    """Offline path on the nuScenes-layout miniset (--device cpu): a
    prediction .npz dir (the ground truth with 30 % of its occupied voxels
    emptied) + infos -> two submissions -> scores.  The ground truth scores
    OccScore 1 against itself (to 1e-9, as the JAX CLI test holds it); the
    prediction scores what `score_submissions` and JAX's scorer give for
    the same files."""
    root = str(tmp_path / "data")
    os.makedirs(root)
    ann = _write_miniset(root, 2, (64, 96), n_scenes=2)
    with open(ann, "rb") as f:
        infos = pickle.load(f)["infos"]
    preds = tmp_path / "preds"
    preds.mkdir()
    rng = np.random.RandomState(3)
    for info in infos:
        gt = np.load(os.path.join(root, info["occ_path"]))
        sem = gt["semantics"].copy()
        occ = np.argwhere(sem != FREE_ID)
        drop = occ[rng.rand(len(occ)) < 0.3]
        sem[tuple(drop.T)] = FREE_ID
        np.savez(preds / f"{info['token']}.npz", semantics=sem,
                 flow=gt["flow"])
    pred_out, gt_out = str(tmp_path / "pred.gz"), str(tmp_path / "gt.gz")
    ray_casting_cli.main(["--pred-dir", str(preds), "--infos", ann,
                          "--data-root", root, "--pred-out", pred_out,
                          "--gt-out", gt_out, "--device", "cpu"])
    same = metric_cli.main(["--pred", gt_out, "--gt", gt_out])
    assert abs(same["OccScore"] - 1.0) < 1e-9, same
    out_json = str(tmp_path / "scores.json")
    scores = metric_cli.main(["--pred", pred_out, "--gt", gt_out,
                              "--out", out_json])
    _assert_scores_equal(scores, sub.score_submissions(pred_out, gt_out))
    _assert_scores_equal(scores, jax_sub.score_submissions(pred_out, gt_out))
    assert 0.3 < scores["RayIoU"] < 1.0, scores
    with open(out_json) as f:
        assert json.load(f).keys() == scores.keys()
    assert set(sub.load_submission(gt_out)["results"]) == {"tok0", "tok1"}
