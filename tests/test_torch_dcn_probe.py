"""The test CLI's window-DCN radius probe (`occnet_tpu_torch/tools/test.py`)
on the CPU: turbo_r101_dcn_occ cut to a small ResNet-50-DCN (DCN in stages
3-4, window mode, dense encoder) with random, calibrated DCN offsets
on a nuScenes-layout miniset.  The probed per-layer radii equal the JAX
package's `needed_radius` of each layer's own offsets on the layers it runs
on its window kernel (`window_supported`), 0 elsewhere, and the model
rebuilt at those radii answers with certificate 0."""

import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

from occnet_tpu.ops.dcn_window import needed_radius, window_supported
from occnet_tpu_torch import config
from occnet_tpu_torch.convert import (calibrate_dcn_offsets,
                                      from_jax_variables,
                                      init_jax_style_variables)
from occnet_tpu_torch.data.nuscenes import NuSceneOccDataset
from occnet_tpu_torch.models.detector import OccNet
from occnet_tpu_torch.models.resnet import dcn_layer_indices
from occnet_tpu_torch.ops.deform_conv import ModulatedDeformConv
from occnet_tpu_torch.serve import Predictor
from occnet_tpu_torch.tools import test as test_cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_cli import _write_miniset  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

SMALL = ["model.backbone.type=resnet50", "model.img_h=64", "model.img_w=96",
         "model.bev_h=10", "model.bev_w=10", "model.pillar_h=4",
         "model.embed_dims=32",
         "model.out_dim=8", "model.encoder.num_layers=1",
         "model.encoder.ffn_dim=64", "model.encoder.num_points_in_pillar=4",
         "model.compute_dtype=float32"]
MAX_PX = 2.5     # largest |offset| after calibration, as chip_smoke's


def _calibrated_weights(cfg, imgs, e2i):
    """The JAX-style init with every DCN conv_offset kernel drawn from a
    seed, scaled so that no layer's |offset| on this frame exceeds
    MAX_PX."""
    v = init_jax_style_variables(cfg, seed=0)
    rng = np.random.RandomState(11)
    for blk in v["params"]["backbone"].values():
        co = blk.get("conv2", {}).get("conv_offset")
        if co is not None:
            co["kernel"] = rng.randn(*co["kernel"].shape).astype(np.float32)
    model = OccNet(cfg.model).eval()
    model.load_state_dict(from_jax_variables(v))
    x = Predictor.wrap(cfg, model).normalize(torch.from_numpy(imgs))
    calibrate_dcn_offsets(model, x, torch.from_numpy(e2i), MAX_PX)
    return model.state_dict()


def _jax_needs(cfg, sd, imgs, e2i):
    """Each DCN layer's need by JAX's `needed_radius` on the port's offsets
    (flattened to JAX's (B, h, w, 18) layout) where JAX's
    `window_supported` holds, else 0, in `dcn_window_radii` order."""
    pred = Predictor(cfg, sd, "cpu")
    bb = cfg.model.backbone
    idx = dcn_layer_indices(int(bb.type.replace("resnet", "")), bb.dcn_stages)
    needs, hooks = {}, []

    def probe(i, mod, inputs):
        x = inputs[0]
        h, w = x.shape[2:]
        off, _ = mod.offset_and_mask(x)
        flat = jnp.asarray(off.reshape(*off.shape[:3], -1).numpy())
        needs[i] = (int(needed_radius(flat, h, w))
                    if window_supported(w, 3, mod.stride, 1) else 0)

    for name, mod in pred.model.backbone.named_modules():
        if isinstance(mod, ModulatedDeformConv):
            i = idx[name.split(".")[0]]
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, i=i: probe(i, m, inp)))
    pred.infer(imgs, e2i)
    for h in hooks:
        h.remove()
    return tuple(needs[i] for i in range(len(idx)))


def test_dcn_radius_probe_matches_jax_needed_radius(tmp_path):
    cfg = config.apply_overrides(config.turbo_r101_dcn_occ(), dict(
        kv.split("=", 1) for kv in SMALL))
    root = str(tmp_path / "data")
    ann = _write_miniset(root, 2, (64, 96), grid=(10, 10, 4))
    s0 = NuSceneOccDataset(config.apply_overrides(cfg, {
        "data.data_root": root}).data, ann, training=False).get_sample(0)
    imgs, e2i = s0["img"][None], s0["ego2img"][None]
    sd = _calibrated_weights(cfg, imgs, e2i)
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"step": 0, "model": sd}, ckpt)
    want = _jax_needs(cfg, sd, imgs, e2i)
    got = test_cli.main([
        "--config", "turbo_r101_dcn_occ", "--device", "cpu", "--checkpoint",
        ckpt, "--eval", "--max-samples", "1", "--work-dir",
        str(tmp_path / "work"), "--set", f"data.data_root={root}",
        "data.val_ann=infos_val.pkl", *SMALL])
    assert got["dcn_radii"] == want
    # the stride-2 stage entries take 0; calibrated layers need 1-3
    assert want[0] == 0 and max(want) == 3 and len(set(want)) > 2
    assert got["overflow"] == 0
    assert np.isfinite(got["scores"]["RayIoU"])
