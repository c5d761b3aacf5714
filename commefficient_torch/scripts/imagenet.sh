#!/bin/bash
# ImageNet federated recipe on the card: the port's copy of the JAX
# package's scripts/imagenet.sh, the reference's only tuned large-scale
# config (reference imagenet.sh:1-21): FixupResNet50, 7 workers / 7
# clients iid, uncompressed mode, virtual momentum 0.9, weight decay 1e-4,
# batch size 64 per client, 24 epochs with the LR peaking at epoch 5.
#
# It runs python -m commefficient_torch.cv_train on the card (cuda; pass
# --device cpu among the extra flags to run on the CPU). The dataset is a
# local ImageNet directory: nothing is downloaded.
#
# Usage: commefficient_torch/scripts/imagenet.sh <imagenet_dir> [extra flags...]
set -euo pipefail
cd "$(dirname "$0")/../.."
DATASET_DIR="${1:?usage: commefficient_torch/scripts/imagenet.sh <imagenet_dir> [extra flags]}"
shift || true

exec python -m commefficient_torch.cv_train \
  --dataset_name ImageNet \
  --dataset_dir "$DATASET_DIR" \
  --model FixupResNet50 \
  --mode uncompressed \
  --error_type none \
  --iid \
  --num_clients 7 \
  --num_workers 7 \
  --local_batch_size 64 \
  --valid_batch_size 64 \
  --local_momentum 0 \
  --virtual_momentum 0.9 \
  --weight_decay 1e-4 \
  --num_epochs 24 \
  --pivot_epoch 5 \
  --lr_scale 0.4 \
  "$@"
