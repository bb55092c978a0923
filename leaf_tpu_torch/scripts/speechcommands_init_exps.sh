#!/usr/bin/env bash
# SpeechCommands-v2 initializer sweep on the port, the counterpart of the
# JAX repo's scripts/speechcommands_init_exps.sh (reference:
# speechcommands_init_exps.sh:3-11): 3 cfgs x 5 seeds, each a
# `python -m leaf_tpu_torch.train` run from the repository root, on the
# card (arguments given to this script are passed to every run, e.g.
# `--bf16` or `--device cpu`). Its runs go under their own EXP_ROOT, so a
# port sweep never writes into a JAX sweep's checkpoint directories.
#   EXP_ROOT=... EPOCHS=... bash leaf_tpu_torch/scripts/speechcommands_init_exps.sh
set -euo pipefail
cd "$(dirname "${BASH_SOURCE[0]}")/../.."
EXP_ROOT=${EXP_ROOT:-./experiments/torch_scv2_init_sweep}
EPOCHS=${EPOCHS:-100}
for cfg in efficientnet-b0-leaf-default_random \
           efficientnet-b0-leaf-default_kaiming \
           efficientnet-b0-leaf-default_xavier; do
  for seed in 8881 8882 8883 8884 8885; do
    python -m leaf_tpu_torch.train \
      --cfg_file "cfgs/speechcommands/${cfg}.cfg" \
      --expdir "${EXP_ROOT}/${cfg}_seed${seed}" \
      --epochs "${EPOCHS}" \
      --random_seed "${seed}" "$@"
  done
done
