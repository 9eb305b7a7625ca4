#!/usr/bin/env bash
# Data-parallel training launcher of the port: torchrun around the train
# CLI, one rank a device (the reference's tools/dist_train.sh).
#
#   occnet_tpu_torch/tools/dist_train.sh <config> <num_ranks> [train args...]
#
# e.g.  occnet_tpu_torch/tools/dist_train.sh turbo_occ 8 \
#           --set data.data_root=/data/nuscenes/
#
# The ranks use NCCL, one card each; pass --dist-backend gloo for ranks on
# the CPU (with --device cpu) or sharing a card.  torchrun's exit code is
# nonzero if any rank fails, and it stops the other ranks then.
set -euo pipefail

CONFIG=$1
NPROC=$2
shift 2
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"

PYTHONPATH="$ROOT:${PYTHONPATH:-}" exec python -m torch.distributed.run \
  --standalone --nproc_per_node "$NPROC" \
  -m occnet_tpu_torch.tools.train --config "$CONFIG" --distributed "$@"
