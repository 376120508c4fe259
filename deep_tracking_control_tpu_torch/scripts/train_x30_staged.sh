#!/bin/bash
# Staged X30 DTC training with the PyTorch/CUDA port (the protocol of
# scripts/train_x30_staged.sh, on the card): from-scratch x30_dtc does not
# take off (harsh DTC penalties and torso termination trap a flailing
# 50 kg robot in a terminate-fast attractor), so the policy first learns
# to walk on x30_rough.
#
# Stage 1: x30_rough: soft-tracking positives, only_positive_rewards, the
#          53-dim DTC obs layout (foothold block zero), so weights transfer.
# Stage 2: x30_dtc --resume from the rough run: params, both optimizers,
#          the learning rate and the iteration transfer; the env state
#          starts fresh (its episode-sum rows differ; runner/train.py load).
#
# Usage: deep_tracking_control_tpu_torch/scripts/train_x30_staged.sh \
#            [LOG_ROOT] [ROUGH_ITERS] [DTC_ITERS]
# DTC_TASK=x30_dtc_descent switches stage 2 to the descent-clamp variant
# (same obs and reward semantics, so checkpoints transfer both ways);
# NUM_ENVS sets both stages' env count (default 4096).
set -euo pipefail
cd "$(dirname "$0")/../.."

LOG_ROOT="${1:-logs}"
ROUGH_ITERS="${2:-4000}"
DTC_ITERS="${3:-30000}"
NUM_ENVS="${NUM_ENVS:-4096}"
DTC_TASK="${DTC_TASK:-x30_dtc}"

echo "=== stage 1: x30_rough ${ROUGH_ITERS} iters ==="
python -m deep_tracking_control_tpu_torch.scripts.train --task x30_rough \
    --num_envs "$NUM_ENVS" --max_iterations "$ROUGH_ITERS" \
    --log_root "$LOG_ROOT"

ROUGH_RUN=$(ls -1t "$LOG_ROOT/rough_X30/" | head -1)
echo "=== stage 1 run: $ROUGH_RUN ==="

mkdir -p "$LOG_ROOT/x30_dtc"
ln -sfn "$(cd "$LOG_ROOT/rough_X30/$ROUGH_RUN" && pwd)" \
    "$LOG_ROOT/x30_dtc/$ROUGH_RUN"

echo "=== stage 2: $DTC_TASK ${DTC_ITERS} iters (resume from rough) ==="
python -m deep_tracking_control_tpu_torch.scripts.train --task "$DTC_TASK" \
    --num_envs "$NUM_ENVS" --max_iterations "$DTC_ITERS" \
    --log_root "$LOG_ROOT" --resume --load_run "$ROUGH_RUN"
