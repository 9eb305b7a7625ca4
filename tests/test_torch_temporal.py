"""The port's temporal path (`occnet_tpu_torch/ops/transforms.py`,
`training/temporal.py`, `data/clips.py`, the model's history inputs and the
CLIs' `--video` / `--temporal-queue`) against the JAX package on the CPU,
on numpy inputs from a seed: the alignment scalars and the clips bitwise,
the nearest rotation tie-exact, the history BEV, the clip train step and
the streaming logits within the single-frame tests' tolerances, and the
`--video` CLI's scores within 2e-3 of JAX's streaming state.  The model is
the micro model of tests/test_temporal.py (BEV 6 x 6, 16 dims, 1 layer,
2 cameras, fp32) at 32 x 64 images (so uint8 frames pad to the input size),
dense and gather."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occnet_tpu import config as jax_config
from occnet_tpu.data import ClipDataset as JaxClipDataset
from occnet_tpu.data import NuSceneOccDataset as JaxNuSceneOccDataset
from occnet_tpu.data.clips import clip_alignment as jax_clip_alignment
from occnet_tpu.data.pipeline import make_device_normalizer
from occnet_tpu.models.detector import OccNet as JaxOccNet
from occnet_tpu.ops.transforms import shift_bev_ref as jax_shift_bev_ref
from occnet_tpu.training import temporal as jax_temporal
from occnet_tpu.training.train import TrainState as JaxTrainState
from occnet_tpu.training.train import make_optimizer as jax_optimizer
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (from_jax_variables,
                                      init_jax_style_variables,
                                      randomize_variables)
from occnet_tpu_torch.data import ClipDataset, NuSceneOccDataset
from occnet_tpu_torch.data.clips import clip_alignment
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.ops.transforms import (nearest_source_index,
                                             rotate_bev, rotation_cos_sin,
                                             rotation_source, shift_bev_ref)
from occnet_tpu_torch.serve import Predictor
from occnet_tpu_torch.tools import test as test_cli
from occnet_tpu_torch.tools import train as train_cli
from occnet_tpu_torch.tools.train import ring_rig
from occnet_tpu_torch.training.temporal import (StreamingInferenceState,
                                                align_prev_bev,
                                                ego_deltas_from_poses,
                                                make_history_bev_fn,
                                                make_temporal_train_step)
from occnet_tpu_torch.training.train import create_train_state, lr_mult

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from test_torch_train import jax_lift_at_port_rounding  # noqa: E402,F401

MICRO = {"model.img_h": "32", "model.img_w": "64", "model.bev_h": "6",
         "model.bev_w": "6", "model.pillar_h": "2", "model.embed_dims": "16",
         "model.out_dim": "4", "model.num_cams": "2",
         "model.compute_dtype": "float32", "model.encoder.num_layers": "1",
         "model.encoder.ffn_dim": "32",
         "model.encoder.num_points_in_pillar": "2",
         "data.occ_size": "(6,6,2)",
         # nothing random in a step, nothing clipped (JAX's first Adam
         # moment is then 0.1 x grad)
         "model.use_grid_mask": "false", "model.encoder.ffn_dropout": "0",
         "model.encoder.tsa.dropout": "0", "model.encoder.sca.dropout": "0",
         "optim.grad_clip_norm": "1e9"}
# the single-frame tests' logit / BEV tolerances: the dense model's lift
# rounds its features to bf16 (tests/test_torch_model.py), the gather
# model is fp32 throughout (tests/test_torch_gather.py)
TOL = {"dense": 5e-2, "gather": 1e-4}
TIE = 6.1e-5            # px: a source coordinate this near a .5 tie may
                        # round either way under another cos / sin


def micro_cfg(mode):
    base = {"dense": config.tiny_turbo_occ,
            "gather": config.tiny_occ}[mode]()
    return config.apply_overrides(base, MICRO)


def jax_cfg(cfg):
    name = ("tiny_turbo_occ" if cfg.model.encoder.mode == "dense"
            else "tiny_occ")
    return jax_config.apply_overrides(jax_config.get_config(name), MICRO)


@pytest.fixture(scope="module", params=["dense", "gather"])
def micro(request):
    """(mode, cfg, JAX variables, the port's OccNet in eval mode)."""
    cfg = micro_cfg(request.param)
    v = randomize_variables(init_jax_style_variables(cfg, seed=3), seed=4)
    model = OccNet(cfg.model)
    model.load_state_dict(from_jax_variables(v))
    return request.param, cfg, v, model.eval()


def rig(m, b):
    """The 2-camera ring of `tools.train.ring_rig` (90-degree fields of
    view) turned by 0.3 rad about the ego z axis: on the plain ring the
    diagonal BEV cells lie exactly on the field-of-view edges, where one
    ulp of the projection (XLA contracts it into FMAs under jit) flips a
    cell's visibility."""
    c, s = np.cos(0.3), np.sin(0.3)
    rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return (ring_rig(m, b) @ rz).astype(np.float32)


def _yaw_pose(x, y, yaw_deg):
    a = np.deg2rad(yaw_deg)
    p = np.eye(4)
    p[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    p[:2, 3] = x, y
    return p


# ---------------------------------------------------------------------------
# alignment scalars and the rotation


def test_ego_deltas_and_clip_alignment_bitwise():
    """ego_deltas_from_poses (float64 and float32 poses, as the streaming
    CLI hands it float32 ones) and clip_alignment equal JAX's bit for bit
    on 50 random pose pairs."""
    rng = np.random.RandomState(0)
    pc, hw = jax_config.get_config("base_occ").model.pc_range, (200, 200)
    for _ in range(50):
        p0 = _yaw_pose(*rng.uniform(-500, 500, 2), rng.uniform(-180, 180))
        p1 = _yaw_pose(*(p0[:2, 3] + rng.uniform(-5, 5, 2)),
                       rng.uniform(-180, 180))
        for a, b in ((p0, p1), (p0.astype(np.float32),
                                p1.astype(np.float32))):
            for x, y in zip(ego_deltas_from_poses(a, b),
                            jax_temporal.ego_deltas_from_poses(a, b)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        for x, y in zip(clip_alignment(p0, p1, pc, hw),
                        jax_clip_alignment(p0, p1, pc, hw)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_rotation():
    """JAX's jitted `align_prev_bev` at 200 x 200 on 254 angles (200 in
    +-5 deg, 50 in +-180 deg, 0, +-90, 180), its source index map read off
    a BEV whose cells hold their own index + 1, and XLA's cos / sin of the
    same angles."""
    rng = np.random.RandomState(1)
    ang = np.concatenate([rng.uniform(-5, 5, 200), rng.uniform(-180, 180, 50),
                          [0.0, 90.0, -90.0, 180.0]]).astype(np.float32)
    h = w = 200
    marks = jnp.broadcast_to(
        (jnp.arange(h * w, dtype=jnp.float32) + 1)[None, :, None],
        (len(ang), h * w, 1))
    out = jax.jit(lambda a: jax_temporal.align_prev_bev(marks, a, (h, w)))(
        jnp.asarray(ang))
    idx = np.asarray(out)[..., 0].astype(np.int64) - 1        # -1: invalid
    cos, sin = jax.jit(lambda a: (jnp.cos(-a * jnp.pi / 180.0),
                                  jnp.sin(-a * jnp.pi / 180.0)))(
        jnp.asarray(ang))
    return ang, idx, np.asarray(cos), np.asarray(sin)


def _index_map(cos, sin):
    idx, valid = nearest_source_index(cos, sin, (200, 200), (100.0, 100.0))
    return torch.where(valid, idx, -1).numpy()


def test_rotation_source_indices_tie_exact(jax_rotation):
    """(b) fed XLA's cos / sin, the port's nearest-rotation index map equals
    JAX's on every cell of every angle; (a) with the port's own cos / sin it
    equals JAX's except where JAX's fp32 source coordinate lies within
    6.1e-5 px of a .5 tie.  The rotated BEV of `align_prev_bev` is the
    gather of that map, batched and one map at a time."""
    ang, want, jcos, jsin = jax_rotation
    got = _index_map(torch.from_numpy(jcos), torch.from_numpy(jsin))
    np.testing.assert_array_equal(got, want)
    sx, sy = rotation_source(torch.from_numpy(jcos), torch.from_numpy(jsin),
                             (200, 200), (100.0, 100.0))
    tie = torch.minimum((sx - sx.floor() - 0.5).abs(),
                        (sy - sy.floor() - 0.5).abs()).reshape(len(ang), -1)
    own = _index_map(*rotation_cos_sin(torch.from_numpy(ang)))
    differ = own != want
    assert (tie.numpy()[differ] < TIE).all(), tie.numpy()[differ].max()
    assert (want >= 0).sum() > 0.7 * want.size
    # the rotation itself: the gather of the map, masked
    rng = np.random.RandomState(2)
    bev = torch.from_numpy(rng.randn(3, 200 * 200, 4).astype(np.float32))
    sel = [0, 201, 253]
    out = align_prev_bev(bev, torch.from_numpy(ang[sel]), (200, 200))
    for k, j in enumerate(sel):
        ref = torch.where(torch.from_numpy(own[j] >= 0)[:, None],
                          bev[k, torch.from_numpy(own[j]).clamp(min=0)], 0.0)
        assert torch.equal(out[k], ref)
        one = rotate_bev(bev[k].reshape(200, 200, 4), float(ang[j]),
                         center=(100.0, 100.0))
        assert torch.equal(one.reshape(-1, 4), out[k])


def test_rotation_bilinear_and_shift_match_jax():
    """Bilinear rotation within 1e-6 of JAX's (B, H, W, C); `shift_bev_ref`
    within 1e-6 relative of JAX's jitted fp32 chain on 50 draws."""
    from occnet_tpu.ops.transforms import rotate_bev as jax_rotate
    rng = np.random.RandomState(3)
    bev = rng.randn(20, 20, 3).astype(np.float32)
    for a in rng.uniform(-180, 180, 6).astype(np.float32):
        want = jax.jit(lambda b, a: jax_rotate(b, a, center=(10.0, 10.0),
                                               method="bilinear"))(
            jnp.asarray(bev), jnp.float32(a))
        got = rotate_bev(torch.from_numpy(bev), float(a), center=(10.0, 10.0),
                         method="bilinear")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    gl, hw = (0.4, 0.4), (200, 200)
    shift = jax.jit(lambda d, y: jax_shift_bev_ref(d, y, gl, hw))
    for _ in range(50):
        d = rng.uniform(-3, 3, 2).astype(np.float32)
        y = np.float32(rng.uniform(-180, 180))
        want = np.asarray(shift(jnp.asarray(d), y))
        got = shift_bev_ref(torch.from_numpy(d), torch.tensor(y), gl, hw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the model's history inputs, the history BEV and the clip train step


def test_history_inputs_shift_only_the_gather_encoder(micro):
    """`OccNet.forward(prev_bev, shift_ref_2d, only_bev)`: only_bev gives
    the full forward's BEV (and the certificate in gather mode); the
    history changes the BEV; a second shift changes it in gather mode (the
    prev slot is sampled at the shifted reference) and leaves it bitwise
    unchanged in dense mode (the tap attention has no reference points)."""
    mode, cfg, _, model = micro
    m = cfg.model
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.randn(1, 2, 32, 64, 3).astype(np.float32))
    e2i = torch.from_numpy(rig(m, 1))
    prev = torch.from_numpy(rng.randn(1, 36, 16).astype(np.float32))
    with torch.no_grad():
        full = model(img, e2i)
        only = model(img, e2i, only_bev=True)
        assert torch.equal(only["bev_embed"], full["bev_embed"])
        assert set(only) == {"bev_embed"} | (
            {"sca_topk_overflow"} if mode == "gather" else set())
        a, b = (model(img, e2i, prev_bev=prev,
                      shift_ref_2d=torch.full((1, 36, 1, 2), s))["bev_embed"]
                for s in (0.05, -0.1))
    assert not torch.allclose(a, full["bev_embed"], atol=1e-3)
    assert torch.equal(a, b) == (mode == "dense")


def _clip_batch(cfg, seed=6):
    """B = 2, T = 3: sample 0 a whole clip, sample 1 with its frame 1
    padded (prev_exists [F, F, T]: a mid-queue reset of the history)."""
    m = cfg.model
    rng = np.random.RandomState(seed)
    B, T = 2, 3
    exists = np.array([[False, True, True], [False, False, True]])
    rot = rng.uniform(-40, 40, (B, T)).astype(np.float32) * exists
    shifts = rng.uniform(-0.1, 0.1, (B, T, 2)).astype(np.float32) \
        * exists[..., None]
    return {
        "img": rng.randn(B, T, 2, m.img_h, m.img_w, 3).astype(np.float32),
        "ego2img": np.broadcast_to(rig(m, B)[:, None],
                                   (B, T, 2, 4, 4)).copy(),
        "rot_deg": rot, "shifts": shifts, "prev_exists": exists,
        "shift": shifts[:, -1].copy(),
        "voxel_semantics": rng.randint(0, 17, (B, m.bev_w, m.bev_h,
                                               m.pillar_h)).astype(np.int32),
        "voxel_flow": rng.randn(B, m.bev_w, m.bev_h, m.pillar_h,
                                2).astype(np.float32)}


def test_history_bev_and_temporal_train_step_match_jax(
        micro, jax_lift_at_port_rounding):
    """The history BEV of frames 0..1 (one of them a mid-queue reset) to
    the single-frame BEV tolerance of JAX's `make_history_bev_fn`; one clip
    train step (T = 3) against JAX's `make_temporal_train_step`: the loss to
    1e-3 relative, every gradient (JAX's from its first Adam moment) to
    5e-2 x max|g_jax| per leaf as tests/test_torch_train.py holds the
    single-frame step, frozen leaves unchanged, certificates 0.

    The dense model's trunk gradients pass through the lift's feature
    gradient, which both packages round to bf16 at their own points; at
    this size that moves two trunk leaves by 5.4 % and 8.7 % of their
    max|g| (measured; 1.1 % in L2, every other leaf <= 1.9 %; the gather
    model's leaves agree to 2e-5).  Dense trunk leaves are held in L2,
    ||diff|| <= 0.1 ||g_jax||, as tests/test_torch_train.py holds the
    trunk leaves it cannot hold by max."""
    mode, cfg, v, _ = micro
    jcfg = jax_cfg(cfg)
    batch = _clip_batch(cfg)
    jm = JaxOccNet(jcfg.model)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    want_hist = jax.jit(jax_temporal.make_history_bev_fn(jm, jcfg))(
        v["params"], v["batch_stats"], jb["img"][:, :2], jb["ego2img"][:, :2],
        jb["rot_deg"][:, :2], jb["shifts"][:, :2], jb["prev_exists"][:, :2])
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    tx = jax_optimizer(jcfg, params)
    js = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, v["batch_stats"]),
                       opt_state=tx.init(params))
    js2, jmet = jax.jit(jax_temporal.make_temporal_train_step(jcfg, jm, tx))(
        js, jb, jax.random.PRNGKey(0))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda mu: np.asarray(mu) / np.float32(0.1), js2.opt_state[1].mu)})

    state = create_train_state(cfg, from_jax_variables(v), "cpu")
    tb = {k: torch.from_numpy(np.ascontiguousarray(x))
          for k, x in batch.items()}
    tb["voxel_semantics"] = tb["voxel_semantics"].long()
    hist, cert = make_history_bev_fn(cfg)(
        state.model, tb["img"][:, :2], tb["ego2img"][:, :2],
        tb["rot_deg"][:, :2], tb["shifts"][:, :2], tb["prev_exists"][:, :2])
    np.testing.assert_allclose(hist.numpy(), np.asarray(want_hist), rtol=0,
                               atol=TOL[mode])
    assert (cert is None) == (mode == "dense") and not (cert or 0)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    phases = []
    met = make_temporal_train_step(cfg)(state, tb, mark=phases.append)
    assert phases == ["history", "forward", "backward", "optimizer"]
    assert state.step == 1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-3)
    assert int(met["cert_overflow"]) == int(jmet["cert_overflow"]) == 0
    for n, p in state.model.named_parameters():
        ref = jgrads[n]
        if lr_mult(n, cfg) == 0.0:
            assert p.grad is None and not ref.any(), n
            assert torch.equal(p.detach(), before[n]), n
            continue
        if mode == "dense" and n.startswith("backbone."):
            err = (p.grad - ref).norm().item()
            assert err <= 0.1 * ref.norm().item(), (n, err)
            continue
        scale = max(ref.abs().max().item(), 1e-12)
        err = (p.grad - ref).abs().max().item()
        assert err <= 5e-2 * scale, (n, err, scale)


# ---------------------------------------------------------------------------
# streaming inference


def test_streaming_state_matches_jax(micro):
    """2 scenes x 3 uint8 frames with a yaw and a translation a frame: the
    logits of every frame within the single-frame tolerance of JAX's
    `StreamingInferenceState` on the same weights; frames 2-3 of a scene
    differ from a single-frame pass (history engaged); the first frame of
    the second scene (a scene change) equals a fresh single-frame pass
    bitwise; the state keeps the last BEV."""
    mode, cfg, v, model = micro
    jcfg = jax_cfg(cfg)
    m = cfg.model
    rng = np.random.RandomState(7)
    frames = [(rng.randint(0, 256, (1, 2, 32, 64, 3), dtype=np.uint8),
               rig(m, 1), "scene-A" if i < 3 else "scene-B",
               _yaw_pose(2.0 * (i % 3), 0.5 * (i % 3), 25.0 * (i % 3) + 5))
              for i in range(6)]
    jm = JaxOccNet(jcfg.model)
    jstate = jax_temporal.StreamingInferenceState(
        jcfg, jm, v["params"], v["batch_stats"],
        preprocess=make_device_normalizer(jcfg.data))
    pred = Predictor.wrap(cfg, model)
    state = StreamingInferenceState(pred)
    for i, (img, e2i, scene, pose) in enumerate(frames):
        want = jstate.step(jnp.asarray(img), jnp.asarray(e2i), scene, pose)
        marks = []
        got = state.step(img, e2i, scene, pose, mark=marks.append)
        assert marks == ([] if i % 3 == 0 else ["align"])
        np.testing.assert_allclose(got["occ"].numpy(),
                                   np.asarray(want["occ"]), rtol=0,
                                   atol=TOL[mode], err_msg=f"frame {i}")
        single = pred.infer(img, e2i)
        assert torch.equal(got["occ"], single["occ"]) == (i % 3 == 0), i
        assert state.prev_bev is got["bev_embed"]
    assert state.prev_scene == "scene-B"


# ---------------------------------------------------------------------------
# clips and the CLIs


def test_clip_dataset_matches_jax(tmp_path):
    """`ClipDataset` (T = 3) over a 2-scene miniset against JAX's: clip
    indices, rot_deg, shifts, prev_exists, shift and the images / ground
    truth bitwise on every clip, and the collated batch."""
    m = micro_cfg("gather").model
    root = str(tmp_path / "data")
    ann = _write_miniset(root, 6, (m.img_h, m.img_w),
                         grid=(m.bev_w, m.bev_h, m.pillar_h), n_scenes=2)
    dcfg = dataclasses.replace(micro_cfg("gather").data, data_root=root)
    jdcfg = dataclasses.replace(jax_cfg(micro_cfg("gather")).data,
                                data_root=root)
    ours = ClipDataset(NuSceneOccDataset(dcfg, ann, training=False), 3,
                       m.pc_range, (m.bev_h, m.bev_w))
    theirs = JaxClipDataset(JaxNuSceneOccDataset(jdcfg, ann, training=False,
                                                 device_normalize=True),
                            3, m.pc_range, (m.bev_h, m.bev_w))
    assert len(ours) == len(theirs) == 6
    got = [ours.get_sample(i) for i in range(6)]
    for i, s in enumerate(got):
        np.testing.assert_array_equal(ours.clip_indices(i),
                                      theirs.clip_indices(i))
        w = theirs.get_sample(i)
        assert s.keys() == w.keys() and s["token"] == w["token"]
        for k in s:
            if k != "token":
                assert s[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(s[k], w[k], err_msg=f"{k} {i}")
    assert got[2]["prev_exists"].tolist() == [False, True, True]
    assert got[4]["prev_exists"].tolist() == [False, False, True]
    assert abs(got[2]["rot_deg"][2]) > 0
    batch = ours.collate([got[2], got[4]])
    assert batch["img"].shape[:2] == (2, 3) and batch["tokens"] == [
        "tok2", "tok4"]


# tiny_occ at the size of tests/test_torch_test_cli.py (50 x 50 x 8 grid for
# the ray metric; a static top-K that the CLI sizes per camera)
SMALL = ["model.img_h=64", "model.img_w=96", "model.embed_dims=32",
         "model.out_dim=8", "model.compute_dtype=float32",
         "model.encoder.num_layers=1", "model.encoder.ffn_dim=64",
         "model.encoder.num_points_in_pillar=4",
         "model.encoder.sca.max_queries_per_cam=2048", "eval.max_origins=2"]


def test_video_cli_matches_jax_streaming(tmp_path):
    """The test CLI's `--video --eval --format-only` on a 2-scene, 4-frame
    miniset from a saved checkpoint: every score within 2e-3 of JAX's
    `StreamingInferenceState` driven over the same frames with the same
    weights and JAX's auto top-K, certificate 0, a submission entry a
    frame.  (The JAX CLI itself is a slow-tier test.)"""
    from occnet_tpu import geometry as jax_geometry
    from occnet_tpu.evaluation import ray_metrics as jax_rm
    from occnet_tpu.evaluation.ego_pose import (extract_ego_origins,
                                                pad_origins)
    from occnet_tpu.models.head import get_occ
    overrides = dict(kv.split("=", 1) for kv in SMALL)
    cfg = config.apply_overrides(config.tiny_occ(), overrides)
    m = cfg.model
    root = str(tmp_path / "data")
    ann = _write_miniset(root, 4, (m.img_h, m.img_w),
                         grid=(m.bev_w, m.bev_h, m.pillar_h), n_scenes=2)
    v = randomize_variables(init_jax_style_variables(cfg, seed=0), seed=1)
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"step": 0, "model": from_jax_variables(v)}, ckpt)
    got = test_cli.main([
        "--config", "tiny_occ", "--device", "cpu", "--checkpoint", ckpt,
        "--work-dir", str(tmp_path / "work"), "--out",
        str(tmp_path / "sub.gz"), "--video", "--eval", "--format-only",
        "--set", f"data.data_root={root}", "data.val_ann=infos_val.pkl",
        *SMALL])

    jcfg = jax_config.apply_overrides(jax_config.tiny_occ(), {
        **overrides, "data.data_root": root})
    ds = JaxNuSceneOccDataset(jcfg.data, ann, training=False,
                              device_normalize=True)
    ks = jax_geometry.calibration_topk(
        jcfg.model, jnp.asarray(ds.get_sample(0)["ego2img"][None]),
        per_camera=True)
    jcfg = jax_config.apply_overrides(jcfg,
                                      {"model.encoder.sca.per_cam_topk": ks})
    stream = jax_temporal.StreamingInferenceState(
        jcfg, JaxOccNet(jcfg.model), v["params"], v["batch_stats"],
        preprocess=make_device_normalizer(jcfg.data))
    origins = dict(extract_ego_origins(ds.infos))
    rays = jnp.asarray(jax_rm.generate_lidar_rays())
    acc = jax_rm.RayMetricAccumulator()
    for i in range(len(ds)):
        s = ds.get_sample(i)
        occ, flow = get_occ(stream.step(
            jnp.asarray(s["img"][None]), jnp.asarray(s["ego2img"][None]),
            s["scene_token"], s["ego2global"]))
        padded, valid = pad_origins(origins[s["token"]],
                                    jcfg.eval.max_origins)
        pred, gt = jax_rm.render_pred_gt(
            occ[0].astype(jnp.int32), flow[0].astype(jnp.float32),
            jnp.asarray(s["voxel_semantics"]), jnp.asarray(s["voxel_flow"]),
            rays, jnp.asarray(padded), jnp.asarray(valid))
        acc.update(pred, gt)
    want = jax_rm.occ_score_from_metrics(acc.finalize())
    assert got["per_cam_topk"] == tuple(ks) and got["overflow"] == 0
    assert got["tokens"] == [f"tok{i}" for i in range(4)]
    assert got["scores"].keys() == want.keys()
    for k, w in want.items():
        if np.isnan(w):
            assert np.isnan(got["scores"][k]), k
        else:
            assert abs(got["scores"][k] - w) <= 2e-3, (k, got, want)
    assert os.path.exists(tmp_path / "sub.gz")


def test_train_cli_temporal_queue(tmp_path):
    """`--temporal-queue 2` trains one step on the clips of a 2-scene
    miniset on the CPU (finite metrics, a checkpoint), resumes for a
    second; the synthetic sources are refused with it."""
    cfg = micro_cfg("dense")
    m = cfg.model
    root = str(tmp_path / "data")
    _write_miniset(root, 4, (m.img_h, m.img_w),
                   grid=(m.bev_w, m.bev_h, m.pillar_h), n_scenes=2,
                   ann_name="infos_train.pkl")
    sets = [f"{k}={x}" for k, x in MICRO.items()] + [
        "model.num_cams=6", f"data.data_root={root}",
        "data.train_ann=infos_train.pkl", "data.workers=2"]
    argv = ["--config", "tiny_turbo_occ", "--device", "cpu", "--work-dir",
            str(tmp_path / "work"), "--temporal-queue", "2",
            "--ckpt-interval-epochs", "1000"]
    for source in (["--synthetic-data"], ["--synthetic-geometric", "4"]):
        with pytest.raises(SystemExit, match="temporal-queue"):
            train_cli.main(argv + source + ["--set", *sets])
    hist = train_cli.main(argv + ["--max-steps", "1", "--set", *sets])
    assert len(hist) == 1 and hist[0]["cert_overflow"] == 0
    for k in ("loss", "loss_occ", "loss_flow", "grad_norm", "lr"):
        assert np.isfinite(hist[0][k]), k
    assert os.path.exists(tmp_path / "work" / "ckpt.pt")
    hist = train_cli.main(argv + ["--max-steps", "2", "--resume",
                                  "--set", *sets])
    assert [h["step"] for h in hist] == [1] and np.isfinite(hist[0]["loss"])
