#!/usr/bin/env bash
# VoxCeleb1 speaker-ID runs on the port, the counterpart of the JAX repo's
# scripts/voxceleb_run.sh (reference: voxceleb_run.sh:7-8): 2 cfgs x 5
# seeds, each a `python -m leaf_tpu_torch.train` run from the repository
# root, on the card (arguments given to this script are passed to every
# run). The cfgs read VoxCeleb1 manifests that the repository does not
# hold. Its runs go under their own EXP_ROOT, so a port sweep never
# writes into a JAX sweep's checkpoint directories.
#   EXP_ROOT=... EPOCHS=... bash leaf_tpu_torch/scripts/voxceleb_run.sh
set -euo pipefail
cd "$(dirname "${BASH_SOURCE[0]}")/../.."
EXP_ROOT=${EXP_ROOT:-./experiments/torch_voxceleb}
EPOCHS=${EPOCHS:-100}
for cfg in efficientnet-b0-leaf-default resnet-18-leaf-default; do
  for seed in 8881 8882 8883 8884 8885; do
    python -m leaf_tpu_torch.train \
      --cfg_file "cfgs/voxceleb/${cfg}.cfg" \
      --expdir "${EXP_ROOT}/${cfg}_seed${seed}" \
      --epochs "${EPOCHS}" \
      --random_seed "${seed}" "$@"
  done
done
