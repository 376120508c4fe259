"""Task registry: name -> (TaskCfg, TrainCfg).

Capability parity with legged_gym/utils/task_registry.py:18-132 and the five
registered tasks (legged_gym/envs/__init__.py:17-23): lite3_rough, x30_rough,
lite3_fast, lite3_dtc, x30_dtc.  Env class dispatch collapses to the
`use_dtc_planner` flag (LeggedRobot vs LeggedRobotDTC).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from ..env.config import (AlgorithmCfg, AssetCfg, CommandRanges, CommandsCfg,
                          ControlCfg, EnvCfg, InitStateCfg, RewardScales,
                          RewardsCfg, RunnerCfg, TaskCfg, TerrainCfg, TrainCfg)

_REGISTRY: Dict[str, Callable[[], Tuple[TaskCfg, TrainCfg]]] = {}


def register(name: str, fn):
    _REGISTRY[name] = fn


def get_cfgs(name: str) -> Tuple[TaskCfg, TrainCfg]:
    """task_registry.get_cfgs analog (task_registry.py:29-37)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def task_names():
    return sorted(_REGISTRY)


def make_env(name: str, num_envs: int | None = None, device="cuda",
             **overrides):
    """task_registry.make_env analog (task_registry.py:39-76); the env
    lives on `device` (the card unless the caller asks for "cpu")."""
    from ..env.legged_env import LeggedEnv
    task_cfg, train_cfg = get_cfgs(name)
    if num_envs is not None:
        task_cfg = dataclasses.replace(
            task_cfg, env=dataclasses.replace(task_cfg.env, num_envs=num_envs))
    for k, v in overrides.items():
        task_cfg = dataclasses.replace(task_cfg, **{k: v})
    env = LeggedEnv(task_cfg, terrain_seed=train_cfg.runner.seed, device=device)
    return env, task_cfg, train_cfg


# --------------------------------------------------------------------------
# Lite3 shared pieces (lite3_dtc_config.py / lite3_rough_config.py)
# --------------------------------------------------------------------------

LITE3_DEFAULT_JOINT_ANGLES = (            # lite3_dtc_config.py:58-73
    ("FL_HipX_joint", 0.1), ("FL_HipY_joint", -1.0), ("FL_Knee_joint", 1.8),
    ("FR_HipX_joint", -0.1), ("FR_HipY_joint", -1.0), ("FR_Knee_joint", 1.8),
    ("HL_HipX_joint", 0.1), ("HL_HipY_joint", -1.0), ("HL_Knee_joint", 1.8),
    ("HR_HipX_joint", -0.1), ("HR_HipY_joint", -1.0), ("HR_Knee_joint", 1.8),
)

X30_DEFAULT_JOINT_ANGLES = (              # x30_dtc_config.py:63-78
    ("FL_HipX_joint", 0.1), ("FL_HipY_joint", -0.715), ("FL_Knee_joint", 1.43),
    ("FR_HipX_joint", -0.1), ("FR_HipY_joint", -0.715), ("FR_Knee_joint", 1.43),
    ("HL_HipX_joint", 0.1), ("HL_HipY_joint", -0.715), ("HL_Knee_joint", 1.43),
    ("HR_HipX_joint", -0.1), ("HR_HipY_joint", -0.715), ("HR_Knee_joint", 1.43),
)


def lite3_dtc():
    """Lite3 DTC task (lite3_dtc_config.py)."""
    task = TaskCfg(
        env=EnvCfg(num_envs=4096, num_observations=53,
                   num_privileged_obs=693 + 3 + 693, num_actions=12),
        terrain=TerrainCfg(mesh_type="heightfield", num_rows=6, num_cols=2,
                           max_init_terrain_level=5,
                           terrain_proportions=(0.0, 0.0, 0.2, 0.2, 0.2, 0.4),
                           measure_foot_clearance=True),
        commands=CommandsCfg(ranges=CommandRanges(
            lin_vel_x=(-0.75, 0.75), lin_vel_y=(-0.75, 0.75),
            ang_vel_yaw=(-0.5, 0.5))),
        init_state=InitStateCfg(pos=(0.0, 0.0, 0.4),
                                default_joint_angles=LITE3_DEFAULT_JOINT_ANGLES),
        control=ControlCfg(stiffness=(("joint", 25.0),),
                           damping=(("joint", 0.5),), action_scale=0.25),
        asset=AssetCfg(robot="lite3", foot_name="FOOT",
                       penalize_contacts_on=("TORSO", "THIGH", "SHANK"),
                       terminate_after_contacts_on=()),
        rewards=RewardsCfg(scales=RewardScales(
            # lite3_dtc_config.py:141-181
            tracking_lin_vel=0.0, tracking_ang_vel=0.0,
            soft_tracking_lin_vel=2.0, soft_tracking_ang_vel=0.5,
            orientation=-0.5, feet_air_time=1.0, torques=-0.000001,
            dof_pos_limits=-10.0, dof_acc=-2.5e-8, collision=-1.5,
            termination=-0.1, stand_still=-0.2, base_height=-4.0,
            foothold_miss=-0.05, action_rate=-0.01, ang_vel_xy=-0.01,
            lin_vel_z=-1.0, foot_clearance=-0.01, feet_slip=-0.05,
            hip_pos=-0.04, power=-6e-7, powerchange=-0.005, pos_acc=-0.005,
            foot_acc=-0.007, smooth=-0.003, tracking_optimal_footholds=1.0),
            soft_dof_pos_limit=0.9, base_height_target=0.32, max_acc=100.0),
        use_dtc_planner=True,
    )
    train = TrainCfg(runner=RunnerCfg(experiment_name="lite3_dtc",
                                      max_iterations=20000),
                     algorithm=AlgorithmCfg(entropy_coef=0.003,
                                            minibatch_perm_granule=16))
    return task, train


def lite3_rough():
    """Lite3 rough-terrain task (lite3_rough_config.py).

    Uses the reference's 45-dim obs layout (lite3_rough_config.py:8) —
    the 53-dim DTC layout minus the 8-dim foothold block.  (As committed
    the reference's own 45-dim path is stale — base compute_observations
    reads the subclass-only self.foothold_obs, legged_robot.py:353 /
    SURVEY.md quirks — here 45 simply omits the block, keeping the task
    runnable.)
    """
    task, train = lite3_dtc()
    task = dataclasses.replace(
        task,
        env=dataclasses.replace(task.env, num_envs=2048,
                                num_observations=45),
        terrain=dataclasses.replace(task.terrain, num_rows=10, num_cols=10,
                                    terrain_proportions=(0.1, 0.1, 0.35, 0.25, 0.2)),
        rewards=dataclasses.replace(task.rewards, scales=RewardScales(
            tracking_lin_vel=2.0, tracking_ang_vel=0.5,
            soft_tracking_lin_vel=0.0, soft_tracking_ang_vel=0.0,
            orientation=-0.5, feet_air_time=1.0, torques=-0.000001,
            dof_pos_limits=-10.0, dof_acc=-2.5e-8, collision=-1.0,
            termination=-0.1, stand_still=-0.2, base_height=-4.0,
            foothold_miss=0.0, action_rate=-0.01, ang_vel_xy=-0.01,
            lin_vel_z=-1.0, foot_clearance=-0.01, feet_slip=-0.05,
            hip_pos=-0.04, power=-6e-7, powerchange=-0.005, pos_acc=-0.005,
            foot_acc=-0.007, smooth=-0.003, tracking_optimal_footholds=0.0)),
        use_dtc_planner=False,
    )
    train = dataclasses.replace(
        train, runner=dataclasses.replace(train.runner,
                                          experiment_name="rough_lite3"))
    return task, train


def lite3_fast():
    """Lite3 flat-ground speed task (lite3_fast_config.py: plane terrain,
    lin_vel_x up to +-4 m/s, 4096 envs)."""
    task, train = lite3_rough()
    task = dataclasses.replace(
        task,
        env=dataclasses.replace(task.env, num_envs=4096),
        terrain=dataclasses.replace(task.terrain, mesh_type="plane",
                                    curriculum=False, measure_heights=True,
                                    measure_foot_clearance=False),
        commands=dataclasses.replace(task.commands, ranges=CommandRanges(
            lin_vel_x=(-4.0, 4.0), lin_vel_y=(-1.0, 1.0),
            ang_vel_yaw=(-1.0, 1.0))),
    )
    train = dataclasses.replace(
        train, runner=dataclasses.replace(train.runner,
                                          experiment_name="Fast_lite3"))
    return task, train


def x30_dtc():
    """X30 DTC task (x30_dtc_config.py)."""
    task, train = lite3_dtc()
    task = dataclasses.replace(
        task,
        # x30_dtc_config defines no commands class -> inherits the BASE
        # ranges (legged_robot_config.py:62-74), not lite3's +-0.75/0.5
        commands=dataclasses.replace(task.commands, ranges=CommandRanges(
            lin_vel_x=(-1.0, 1.0), lin_vel_y=(-1.0, 1.0),
            ang_vel_yaw=(-1.0, 1.0))),
        terrain=dataclasses.replace(task.terrain, horizontal_scale=0.1,
                                    num_rows=10, num_cols=10,
                                    terrain_proportions=(0.1, 0.1, 0.2, 0.2, 0.2, 0.2)),
        init_state=InitStateCfg(pos=(0.0, 0.0, 0.51),
                                default_joint_angles=X30_DEFAULT_JOINT_ANGLES),
        control=ControlCfg(stiffness=(("HipX", 120.0), ("HipY", 120.0),
                                      ("Knee", 150.0)),
                           damping=(("HipX", 3.0), ("HipY", 3.0),
                                    ("Knee", 3.5)), action_scale=0.25),
        asset=AssetCfg(robot="x30", foot_name="FOOT",
                       penalize_contacts_on=("THIGH", "SHANK"),
                       terminate_after_contacts_on=("TORSO",)),
        rewards=RewardsCfg(scales=RewardScales(
            # x30_dtc_config.py:137-167
            torques=0.0, dof_pos_limits=-10.0, termination=0.0,
            tracking_lin_vel=3.0, tracking_ang_vel=0.5,
            soft_tracking_lin_vel=0.0, soft_tracking_ang_vel=0.0,
            lin_vel_z=-4.0, ang_vel_xy=-0.2, orientation=-0.5,
            dof_vel=-0.000001, dof_acc=-2.5e-7, base_height=-10.0,
            feet_air_time=2.0, collision=-1.0, feet_stumble=-3.0,
            action_rate=-0.02, powerchange=-0.01, pos_acc=-0.01,
            big_pitch=-10.0, feet_contact_forces=-0.005,
            stand_still=0.0, foothold_miss=0.0, foot_clearance=0.0,
            feet_slip=0.0, hip_pos=0.0, power=0.0, foot_acc=0.0, smooth=0.0,
            tracking_optimal_footholds=0.08),
            soft_dof_pos_limit=0.99, soft_torque_limit=0.99,
            base_height_target=0.56, max_acc=100.0),
        use_dtc_planner=True,
    )
    train = TrainCfg(runner=RunnerCfg(experiment_name="x30_dtc",
                                      max_iterations=30000),
                     algorithm=AlgorithmCfg(entropy_coef=0.01,
                                            minibatch_perm_granule=16))
    return task, train


def x30_rough():
    """X30 rough-terrain pretraining task (x30_rough_config.py).

    The reference's committed x30_rough has every base reward scale
    commented out (legged_robot_config.py:146-170) and its own runs were
    resumed from pre-existing checkpoints (x30_rough_config.py:75-76) —
    as committed it trains nothing.  This recipe is the working stage-1
    for the staged X30 protocol the reference's commented resume lines
    imply (see PARITY.md): lite3-style soft-tracking positives, softened
    penalties, and only_positive_rewards=True (the base config's own
    "avoids early termination problems" device) so early X30 policies
    don't collapse into terminate-fast exploits.  Obs layout stays
    53-dim (foothold obs zeroed by the disabled planner) so checkpoints
    transfer into x30_dtc."""
    task, train = x30_dtc()
    task = dataclasses.replace(
        task,
        env=dataclasses.replace(task.env, num_envs=2048),
        rewards=dataclasses.replace(
            task.rewards,
            only_positive_rewards=True,
            base_height_target=0.49,       # x30_rough_config.py:63
            scales=dataclasses.replace(task.rewards.scales,
                                       tracking_lin_vel=0.0,
                                       tracking_ang_vel=0.0,
                                       soft_tracking_lin_vel=2.0,
                                       soft_tracking_ang_vel=0.5,
                                       lin_vel_z=-1.0,
                                       base_height=-4.0,
                                       big_pitch=-2.0,
                                       feet_stumble=-1.0,
                                       tracking_optimal_footholds=0.0)),
        use_dtc_planner=False,
    )
    train = dataclasses.replace(
        train, runner=dataclasses.replace(train.runner,
                                          experiment_name="rough_X30"))
    return task, train


def x30_dtc_descent():
    """x30_dtc + the descent-frontier command clamp (round-5 intervention,
    CommandsCfg.descent_clamp — no reference analog).  Same policy/obs/
    reward semantics as x30_dtc, so checkpoints transfer both ways; only
    the command DISTRIBUTION on rough_slope/stairs_down columns at
    terrain_level >= 6 narrows to <= 0.5 m/s.  Logs under the x30_dtc
    experiment name so --resume/--load_run find the staged checkpoints."""
    task, train = x30_dtc()
    task = dataclasses.replace(
        task, commands=dataclasses.replace(
            task.commands, descent_clamp=0.5, descent_clamp_level=6))
    return task, train


register("lite3_dtc", lite3_dtc)
register("lite3_rough", lite3_rough)
register("lite3_fast", lite3_fast)
register("x30_dtc", x30_dtc)
register("x30_rough", x30_rough)
register("x30_dtc_descent", x30_dtc_descent)
