#!/bin/bash
# Train a task with the PyTorch/CUDA port, then evaluate its last
# checkpoint: the stepping-stone eval at difficulty 0.30 and 0.45
# (eval_stones: 64 envs x 1500 steps) and the termination analysis on the
# curriculum world (analyze_terminations: 256 envs x 2000 steps).
#
# Usage: deep_tracking_control_tpu_torch/scripts/train_and_evaluate.sh \
#            [LOG_ROOT] [ITERS] [SEED]
# TASK sets the task (default lite3_dtc).  Every stage runs on the card;
# the train log prints reward, episode length and lr every 10 iterations.
set -euo pipefail
cd "$(dirname "$0")/../.."

LOG_ROOT="${1:-logs}"
ITERS="${2:-500}"
SEED="${3:-1}"
TASK="${TASK:-lite3_dtc}"
COMMON=(--task "$TASK" --seed "$SEED" --log_root "$LOG_ROOT")

echo "=== train: $TASK, $ITERS iterations, seed $SEED ==="
python -m deep_tracking_control_tpu_torch.scripts.train "${COMMON[@]}" \
    --max_iterations "$ITERS"
for d in 0.30 0.45; do
    echo "=== eval_stones: difficulty $d ==="
    python -m deep_tracking_control_tpu_torch.scripts.eval_stones \
        "${COMMON[@]}" --difficulty "$d"
done
echo "=== analyze_terminations ==="
python -m deep_tracking_control_tpu_torch.scripts.analyze_terminations \
    "${COMMON[@]}"
