"""The benchmark's only contact with the program under test
(`occnet_tpu_torch`): building the model on the device, its weights' names,
the serving and training entries, and, in a traced run, wrappers that
record the shapes of the calls into the hand-written kernels so that the
yardstick can work out each call's least time.  The wrappers run only in
the pass after the traced window that reads the calls; they change no
result.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

from occbench import yardstick


def build_model(cfg, device):
    """The program's `OccNet` for ``cfg``, built on ``device``."""
    import torch
    from occnet_tpu_torch.models.detector import OccNet
    with torch.device(device):
        model = OccNet(cfg.model)
    return model.to(device)


def weight_spec(model) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, shape, is_parameter) of every entry of the state dict."""
    params = {n for n, _ in model.named_parameters()}
    return [(n, tuple(t.shape), n in params)
            for n, t in model.state_dict().items()]


def predictor(cfg, model):
    from occnet_tpu_torch.serve import Predictor
    return Predictor.wrap(cfg, model.eval())


def train_state(cfg, model):
    from occnet_tpu_torch.training.train import TrainState, make_optimizer
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model))


def train_step(cfg, seed: int):
    from occnet_tpu_torch.training.train import make_train_step
    return make_train_step(cfg, seed=seed)


@contextlib.contextmanager
def patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def recording_calls(calls: Dict[str, list]):
    """Record, for every call into the lift, its backward, the tap
    attention and MSDA made inside the block, what the yardstick needs of
    it (shapes, element sizes, live cells, touched value rows)."""
    from occnet_tpu_torch.models import attention, dense_attention
    from occnet_tpu_torch.ops import planar_lift

    lift, lift_bwd = planar_lift.lift_level, planar_lift.lift_level_bwd
    tap = dense_attention.tap_attention
    msda = attention.multi_scale_deformable_attention

    def lift_rec(feat, pos1, pos2, steep, inv_count, out, **kw):
        B, A, h, w, C = feat.shape
        calls.setdefault("lift", []).append(dict(
            B=B, A=A, h=h, w=w, C=C, ZR=pos2.shape[2], M=pos2.shape[3],
            Q=inv_count.shape[1], live=int((pos2 > -2).sum()),
            feat_bytes=feat.element_size(), out_bytes=out.element_size()))
        return lift(feat, pos1, pos2, steep, inv_count, out, **kw)

    def lift_bwd_rec(g, pos1, pos2, steep, inv_count, hw, **kw):
        dfeat = lift_bwd(g, pos1, pos2, steep, inv_count, hw, **kw)
        B, A, h, w, C = dfeat.shape
        calls.setdefault("lift_bwd", []).append(dict(
            B=B, A=A, h=h, w=w, C=C, ZR=pos2.shape[2], M=pos2.shape[3],
            Q=inv_count.shape[1], live=int((pos2 > -2).sum()),
            g_bytes=g.element_size(), dfeat_bytes=dfeat.element_size()))
        return dfeat

    def tap_rec(vgrid, attn):
        out = tap(vgrid, attn)
        B, nq, H, W, C = vgrid.shape
        calls.setdefault("tap", []).append(dict(
            B=B, nq=nq, H=H, W=W, C=C, heads=attn.shape[-1],
            taps=attn.shape[-2], v_bytes=vgrid.element_size(),
            attn_bytes=attn.element_size(), out_bytes=out.element_size()))
        return out

    def msda_rec(value, shapes, loc, attn):
        rows, corners = yardstick.msda_touched(tuple(value.shape),
                                               list(shapes), loc.detach())
        calls.setdefault("msda", []).append(dict(
            value_shape=tuple(value.shape), value_bytes=value.element_size(),
            rows=rows, corners=corners, Q=loc.shape[1],
            loc_bytes=loc.numel() * loc.element_size(),
            attn_bytes=attn.numel() * attn.element_size()))
        return msda(value, shapes, loc, attn)

    with patched(planar_lift, "lift_level", lift_rec), \
            patched(planar_lift, "lift_level_bwd", lift_bwd_rec), \
            patched(dense_attention, "tap_attention", tap_rec), \
            patched(attention, "multi_scale_deformable_attention", msda_rec):
        yield calls
