"""Training entry point (legged_gym/scripts/train.py parity).

    python -m deep_tracking_control_tpu_torch.scripts.train --task lite3_dtc

Trains on the card; `--device cpu` runs on the CPU (tiny runs only, e.g.
`--num_envs 16 --max_iterations 2`).  Checkpoints (model_{it}.pt) and the
TensorBoard events, when tensorboard is installed, go under
<log_root>/<experiment_name>/<date>_<run_name>/.
"""
import dataclasses
import os
from datetime import datetime

from ..env.legged_env import LeggedEnv
from ..runner import checkpoint as ckpt
from ..runner.train import OnPolicyRunner
from ..tasks.registry import get_cfgs
from ..utils.cli import get_args, update_cfg_from_args

DEVICE_ARG = ((["--device"], dict(type=str, default="cuda",
                                  help="cuda (default) or cpu")),)


def train(args):
    task_cfg, train_cfg = get_cfgs(args.task)
    task_cfg, train_cfg = update_cfg_from_args(task_cfg, train_cfg, args)

    run_name = (datetime.now().strftime("%b%d_%H-%M-%S") + "_"
                + train_cfg.runner.run_name)
    log_dir = os.path.join(args.log_root, train_cfg.runner.experiment_name,
                           run_name)
    os.makedirs(log_dir, exist_ok=True)

    # reward-scale snapshot (train.py:15-28 parity)
    with open(os.path.join(log_dir, "reward_scale.ini"), "w") as f:
        for fld in dataclasses.fields(task_cfg.rewards.scales):
            f.write(f"{fld.name} = "
                    f"{getattr(task_cfg.rewards.scales, fld.name)}\n")

    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(log_dir=log_dir, flush_secs=10)
    except ImportError:
        pass

    env = LeggedEnv(task_cfg, terrain_seed=train_cfg.runner.seed,
                    device=args.device)
    runner = OnPolicyRunner(env, train_cfg, log_dir=log_dir, writer=writer)
    if train_cfg.runner.resume:
        root = os.path.join(args.log_root, train_cfg.runner.experiment_name)
        path = ckpt.get_load_path(root, train_cfg.runner.load_run,
                                  train_cfg.runner.checkpoint)
        print(f"Loading checkpoint {path}")
        runner.load(path)
    # init_at_random_ep_len=True matches the reference training entry
    # (on_policy_runner.py:105-109 via train.py)
    runner.learn(train_cfg.runner.max_iterations, init_at_random_ep_len=True)
    return runner


def main(argv=None):
    return train(get_args(argv, extra=DEVICE_ARG))


if __name__ == "__main__":
    main()
