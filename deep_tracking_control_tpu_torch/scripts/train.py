"""Training entry point (legged_gym/scripts/train.py parity).

    python -m deep_tracking_control_tpu_torch.scripts.train --task lite3_dtc

Trains on the card; `--device cpu` runs on the CPU (tiny runs only, e.g.
`--num_envs 16 --max_iterations 2`).  Checkpoints (model_{it}.pt) and the
TensorBoard events, when tensorboard is installed, go under
<log_root>/<experiment_name>/<date>_<run_name>/.

Under torchrun the run is sharded over the ranks (parallel/), each rank
stepping num_envs / W envs:

    torchrun --nproc_per_node=W -m deep_tracking_control_tpu_torch.scripts.train \
        --task lite3_dtc [--backend gloo]

(nccl by default on the card; two ranks on one card need gloo).  Rank 0
writes the log directory and the checkpoints.  Without torchrun's
WORLD_SIZE the run is the unsharded one.
"""
import dataclasses
import os
from datetime import datetime

import torch.distributed as dist

from ..env.legged_env import LeggedEnv
from ..parallel import distributed as pdist
from ..runner import checkpoint as ckpt
from ..runner.train import OnPolicyRunner
from ..tasks.registry import get_cfgs
from ..utils.cli import get_args, update_cfg_from_args

DEVICE_ARG = ((["--device"], dict(type=str, default="cuda",
                                  help="cuda (default) or cpu")),
              (["--backend"], dict(type=str, default=None,
                                   help="torch.distributed backend of a "
                                        "torchrun launch (default nccl on the "
                                        "card, gloo on the CPU)")))


def train(args):
    task_cfg, train_cfg = get_cfgs(args.task)
    task_cfg, train_cfg = update_cfg_from_args(task_cfg, train_cfg, args)

    shard, device = None, args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = pdist.initialize(backend=args.backend,
                                  device_type=args.device)
        shard = pdist.global_shard(task_cfg.env.num_envs)
    main = pdist.is_main()

    run_name = (datetime.now().strftime("%b%d_%H-%M-%S") + "_"
                + train_cfg.runner.run_name)
    if shard is not None:                  # rank 0's name on every rank
        names = [run_name]
        dist.broadcast_object_list(names, src=0)
        run_name = names[0]
    log_dir = os.path.join(args.log_root, train_cfg.runner.experiment_name,
                           run_name)
    writer = None
    if main:
        os.makedirs(log_dir, exist_ok=True)
        # reward-scale snapshot (train.py:15-28 parity)
        with open(os.path.join(log_dir, "reward_scale.ini"), "w") as f:
            for fld in dataclasses.fields(task_cfg.rewards.scales):
                f.write(f"{fld.name} = "
                        f"{getattr(task_cfg.rewards.scales, fld.name)}\n")
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir=log_dir, flush_secs=10)
        except ImportError:
            pass

    env = LeggedEnv(task_cfg, terrain_seed=train_cfg.runner.seed,
                    device=device, shard=shard)
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
    pdist.shutdown()
