"""How closely the arithmetic determines a train step's gradients: the
in-process B = 2 step of a config (dropout 0, `tools.train`'s synthetic
batch from seed 0) run again in the same order, and with its two samples
swapped, in bf16 and in fp32, with and without the step's augmentation
(grid mask, photometric distortion).

    python -m occnet_tpu_torch.tools.step_noise --config turbo_occ

For each variant and each rerun it prints the loss, the grad norm and the
whole gradient's relative difference from the first run, the leaves whose
gradient moved by more than 2.5 % of their max |g|, and the worst leaves.
The augmentation's draws follow the sample's index in the global batch,
so with it on a swapped batch is a different step (other masks and
distortions for each image); with it off the swap is the same step in
another order of sums.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

VARIANTS = {
    "bf16_aug": {},
    "bf16_noaug": {"model.use_grid_mask": "false",
                   "data.device_distortion": "false"},
    "fp32_noaug": {"model.use_grid_mask": "false",
                   "data.device_distortion": "false",
                   "model.compute_dtype": "float32"},
}
NO_DROPOUT = {"model.encoder.ffn_dropout": "0",
              "model.encoder.tsa.dropout": "0",
              "model.encoder.sca.dropout": "0"}


def b2_step(cfg, sd, order, device) -> tuple:
    """(gradients on the host, metrics) of the B = 2 step with the batch's
    samples in ``order``."""
    from occnet_tpu_torch.tools.train import make_synthetic_batch, to_device
    from occnet_tpu_torch.training.train import (create_train_state,
                                                 make_train_step)
    state = create_train_state(cfg, sd, device)
    batch = make_synthetic_batch(cfg, 2, np.random.RandomState(0))
    batch = {k: v[order] for k, v in batch.items()}
    met = make_train_step(cfg, seed=0)(state, to_device(batch, device))
    grads = {n: p.grad.detach().float().cpu()
             for n, p in state.model.named_parameters() if p.grad is not None}
    return grads, {k: float(v) for k, v in met.items()}


def compare(grads: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """([(max-norm ratio, L2 ratio, name)] worst first, whole-gradient L2
    ratio)."""
    rows = []
    for n, r in ref.items():
        d = grads[n] - r
        rows.append((d.abs().max().item() / max(r.abs().max().item(), 1e-30),
                     d.norm().item() / max(r.norm().item(), 1e-30), n))
    rows.sort(reverse=True)
    a = torch.cat([grads[n].reshape(-1) for n in ref])
    b = torch.cat([r.reshape(-1) for r in ref.values()])
    return rows, ((a - b).norm() / b.norm()).item()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from occnet_tpu_torch.config import apply_overrides, get_config
    from occnet_tpu_torch.convert import (from_jax_variables,
                                          init_jax_style_variables)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="turbo_occ")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("step_noise: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    out = {}
    for variant, overrides in VARIANTS.items():
        cfg = apply_overrides(get_config(args.config),
                              {**NO_DROPOUT, **overrides})
        sd = from_jax_variables(init_jax_style_variables(cfg, seed=0))
        ref, met = b2_step(cfg, sd, [0, 1], args.device)
        for label, order in (("repeat", [0, 1]), ("swap", [1, 0])):
            grads, m = b2_step(cfg, sd, order, args.device)
            rows, whole = compare(grads, ref)
            over = sum(r[0] > 2.5e-2 for r in rows)
            out[f"{variant} {label}"] = {
                "loss": abs(m["loss"] - met["loss"]) / abs(met["loss"]),
                "grad_norm": abs(m["grad_norm"] - met["grad_norm"])
                / met["grad_norm"], "grad_l2": whole,
                "worst_leaf_max": rows[0][0], "leaves_over_2.5e-2": over}
            print(f"{args.config} {variant} {label}: loss {m['loss']!r} vs "
                  f"{met['loss']!r}; grad norm "
                  f"{out[f'{variant} {label}']['grad_norm']:.3e}; whole "
                  f"gradient L2 {whole:.3e}; leaves over 2.5e-2 of max|g|: "
                  f"{over}/{len(rows)}", flush=True)
            for e, e2, n in rows[:4]:
                print(f"    {e:.3e} (L2 {e2:.3e}) {n}, max|g| "
                      f"{ref[n].abs().max().item():.3e}", flush=True)
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
