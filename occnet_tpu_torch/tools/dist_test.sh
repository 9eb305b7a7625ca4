#!/usr/bin/env bash
# Distributed evaluation / submission launcher of the port: torchrun around
# the test CLI, each rank a contiguous shard of the val split (the
# reference's tools/dist_test.sh).
#
#   occnet_tpu_torch/tools/dist_test.sh <config> <checkpoint> <num_ranks> \
#       [test args...]
#
# e.g.  occnet_tpu_torch/tools/dist_test.sh base_occ work/ckpt.pt 8 \
#           --eval --format-only --out sub.gz --set data.data_root=...
#
# <checkpoint> is the port's checkpoint file or a directory of them; pass
# --torch-checkpoint among the test args (with any placeholder here, e.g.
# "-") to evaluate a reference .pth.  NCCL by default; --dist-backend gloo
# for the CPU or ranks sharing a card.
set -euo pipefail

CONFIG=$1
CKPT=$2
NPROC=$3
shift 3
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"

PYTHONPATH="$ROOT:${PYTHONPATH:-}" exec python -m torch.distributed.run \
  --standalone --nproc_per_node "$NPROC" \
  -m occnet_tpu_torch.tools.test --config "$CONFIG" --checkpoint "$CKPT" \
  --distributed "$@"
