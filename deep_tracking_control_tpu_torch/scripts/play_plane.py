"""Flat-plane evaluation (legged_gym/scripts/play_plane.py parity): like
play_single, on mesh_type="plane".

    python -m deep_tracking_control_tpu_torch.scripts.play_plane
        --task lite3_dtc [--log_root logs] [--device cpu]

On a plane there are no terrain tables, so the physics is the plain
decimation loop over `sim_step` (no decimation or sampler kernel), the
height scan is zero, and a task with the DTC planner (lite3_dtc) plans on
that zero scan with the plain planner (no planner kernel), as the JAX
env does (legged_env.py:626-716 there).
"""
import dataclasses

from . import common
from . import play_single as single

STEPS = 500
# the rollout and the report are play_single's
rollout, report = single.rollout, single.report


def to_plane(task_cfg, train_cfg):
    """The config transform: a plane, no curriculum."""
    return dataclasses.replace(
        task_cfg, terrain=dataclasses.replace(
            task_cfg.terrain, mesh_type="plane", curriculum=False)), train_cfg


def then_plane(transform=None):
    """`transform` (if any), then `to_plane`."""
    if transform is None:
        return to_plane
    return lambda task, train: to_plane(*transform(task, train))


def setup(args, transform=None):
    return single.setup(args, then_plane(transform))


def play_plane(args, steps: int = STEPS, transform=None):
    return single.play_single(args, steps=steps,
                              transform=then_plane(transform))


def main(argv=None):
    return play_plane(common.parse_args(argv))


if __name__ == "__main__":
    main()
