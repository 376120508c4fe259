"""Config schema — frozen dataclasses mirroring LeggedRobotCfg.

The reference uses nested Python classes with inheritance, recursively
instantiated (base_config.py:3-27, legged_robot_config.py:3-226).  Here the
same schema is frozen dataclasses (hashable -> usable as jit static args);
per-task configs (tasks/*.py) build them with dataclasses.replace-style
overrides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static solver parameters (legged_robot_config.py:209-226 equivalents).

    Field for field the same as the JAX package's physics/engine.py
    SimParams, defined here so that the config schema imports no physics
    module; physics/engine.py re-exports it."""
    dt: float = 0.005
    substeps: int = 1                 # inner contact/integration substeps
    gravity: float = -9.81
    contact_stiffness: float = 12000.0   # N/m (URDF foot contact: 30000, softened for explicit stepping)
    contact_damping: float = 150.0       # N s/m, on approach
    friction_vel_eps: float = 0.1        # regularized Coulomb slip velocity [m/s]
    max_contact_force: float = 1500.0    # per-point clamp (max_depenetration analog)
    armature: float = 0.008              # kg m^2, TGS-stabilization analog
    joint_friction: float = 0.02         # N m viscous
    bounce_threshold: float = 0.5        # [m/s] (legged_robot_config.py:222)
    limit_stiffness: float = 300.0       # N m/rad joint-limit spring
    limit_damping: float = 3.0           # N m s/rad beyond the limit
    tangential_stiffness: float = 12000.0  # N/m stiction anchor spring
    tangential_damping: float = 80.0     # N s/m tangential
    # slope cap for the CONTACT NORMAL on walkable cells (the samplers cap
    # geometry at 3.0); 1.0 = 45deg, above every walkable generated slope.
    normal_slope_cap: float = 1.0
    # Cliff cells (bilinear pseudo-slope >= cliff_threshold: stepping-stone
    # rims, stair risers) get sphere-on-corner semantics: a point within
    # cliff_active_depth of the cell's TOP corner is supported AT the top
    # with an UP normal; a point deeper down hits the face ramp with the
    # full tilted normal (the riser "wall").
    cliff_threshold: float = 2.0
    cliff_active_depth: float = 0.06


def _t(x):
    return tuple(x)


@dataclasses.dataclass(frozen=True)
class EnvCfg:
    # legged_robot_config.py:4-14
    num_envs: int = 4096
    num_observations: int = 53
    num_privileged_obs: int = 693 + 3 + 693
    num_actions: int = 12
    num_observation_history: int = 5
    episode_length_s: float = 20.0
    send_timeouts: bool = True
    debug_viz: bool = False           # export planner internals each step
    env_spacing: float = 1.0
    play_command: bool = False        # play_commond, lite3_dtc_config.py:15


@dataclasses.dataclass(frozen=True)
class TerrainCfg:
    # legged_robot_config.py:16-58 / lite3_dtc_config.py:20-52
    mesh_type: str = "heightfield"     # none | plane | heightfield
    horizontal_scale: float = 0.05
    vertical_scale: float = 0.005
    border_size: float = 20.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    measure_heights: bool = True
    measured_points_x: Tuple[float, ...] = _t(
        round(-0.8 + 0.05 * i, 2) for i in range(33))
    measured_points_y: Tuple[float, ...] = _t(
        round(-0.5 + 0.05 * i, 2) for i in range(21))
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 6
    num_cols: int = 2
    terrain_proportions: Tuple[float, ...] = (0.0, 0.0, 0.2, 0.2, 0.2, 0.4)
    slope_treshold: float = 0.75
    measure_foot_clearance: bool = True
    # selected-terrain mode (terrain.py:64-77): fill every tile with one
    # named generator; kwargs as a (key, value) tuple for hashability
    selected: bool = False
    selected_terrain_type: str = "pyramid_stairs_terrain"
    selected_terrain_kwargs: Tuple[Tuple[str, float], ...] = ()

    @property
    def measured_x_dim(self) -> int:
        return len(self.measured_points_x)

    @property
    def measured_y_dim(self) -> int:
        return len(self.measured_points_y)

    @property
    def num_height_points(self) -> int:
        return self.measured_x_dim * self.measured_y_dim


@dataclasses.dataclass(frozen=True)
class CommandRanges:
    lin_vel_x: Tuple[float, float] = (-0.75, 0.75)
    lin_vel_y: Tuple[float, float] = (-0.75, 0.75)
    ang_vel_yaw: Tuple[float, float] = (-0.5, 0.5)
    heading: Tuple[float, float] = (-3.14, 3.14)


@dataclasses.dataclass(frozen=True)
class CommandsCfg:
    # legged_robot_config.py:62-74
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4
    resampling_time: float = 10.0
    heading_command: bool = True
    ranges: CommandRanges = field(default_factory=CommandRanges)
    # Descent-frontier intervention (round 5, NO reference analog, default
    # OFF): on descent-family terrain columns (rough_slope / stairs_down,
    # terrain/generator.py DESCENT_FAMILIES) at terrain_level >=
    # descent_clamp_level, rescale the sampled planar command velocity to
    # at most descent_clamp m/s.  The X30 termination analysis shows
    # 97-99% of high-level episodes on those families end in falls: the
    # sampled commands (up to ~1 m/s) are unreachable down 30-40 cm steps
    # for a 50 kg robot, so the policy never collects on-feet descent
    # experience.  Clamping keeps the tracking target achievable (0.5 m/s
    # still clears the 0.24 m/s curriculum promotion bar,
    # legged_robot.py:690-714) while leaving every other family and all
    # lower levels at exact reference command ranges.
    descent_clamp: float = 0.0          # 0 disables
    descent_clamp_level: int = 6


@dataclasses.dataclass(frozen=True)
class InitStateCfg:
    # legged_robot_config.py:76-83 / lite3_dtc_config.py:56-73
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.4)
    rot: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    lin_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ang_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # (joint name, default angle) pairs, ordered like the robot's joints
    default_joint_angles: Tuple[Tuple[str, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class ControlCfg:
    # legged_robot_config.py:85-93
    control_type: str = "P"
    stiffness: Tuple[Tuple[str, float], ...] = (("joint", 25.0),)
    damping: Tuple[Tuple[str, float], ...] = (("joint", 0.5),)
    action_scale: float = 0.25
    decimation: int = 4


@dataclasses.dataclass(frozen=True)
class AssetCfg:
    # legged_robot_config.py:95-117
    robot: str = "lite3"             # registry key or URDF path
    foot_name: str = "FOOT"
    thigh_name: str = "THIGH"
    penalize_contacts_on: Tuple[str, ...] = ("TORSO", "THIGH", "SHANK")
    terminate_after_contacts_on: Tuple[str, ...] = ()
    collision_state: Tuple[str, ...] = ("TORSO", "THIGH", "SHANK")
    self_collisions: int = 0
    fix_base_link: bool = False


@dataclasses.dataclass(frozen=True)
class DomainRandCfg:
    # legged_robot_config.py:120-144
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    randomize_restitution: bool = True
    restitution_range: Tuple[float, float] = (0.0, 1.0)
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    max_push_force_xy: float = 0.0
    max_push_force_offset: float = 0.1
    randomize_link_mass: bool = False
    link_mass_range: Tuple[float, float] = (0.95, 1.05)
    randomize_motor_strength: bool = True
    motor_strength: Tuple[float, float] = (0.9, 1.1)
    randomize_kp_factor: bool = False
    kp_range: Tuple[float, float] = (0.95, 1.05)
    randomize_kd_factor: bool = False
    kd_range: Tuple[float, float] = (0.95, 1.05)
    init_joint_range: Tuple[float, float] = (0.5, 1.5)
    lag_timesteps: int = 6            # action lag buffer depth (legged_robot.py:827)


@dataclasses.dataclass(frozen=True)
class RewardScales:
    """Reward term -> scale; zero scale = term disabled (legged_robot.py:934).

    Defaults are the Lite3 DTC task scales (lite3_dtc_config.py:141-181).
    """
    termination: float = -0.1
    tracking_lin_vel: float = 0.0
    tracking_ang_vel: float = 0.0
    soft_tracking_lin_vel: float = 2.0
    soft_tracking_ang_vel: float = 0.5
    orientation: float = -0.5
    feet_air_time: float = 1.0
    torques: float = -0.000001
    dof_pos_limits: float = -10.0
    dof_acc: float = -2.5e-8
    dof_vel: float = 0.0
    collision: float = -1.5
    stand_still: float = -0.2
    base_height: float = -4.0
    foothold_miss: float = -0.05
    action_rate: float = -0.01
    ang_vel_xy: float = -0.01
    lin_vel_z: float = -1.0
    foot_clearance: float = -0.01
    feet_slip: float = -0.05
    hip_pos: float = -0.04
    power: float = -6e-7
    powerchange: float = -0.005
    pos_acc: float = -0.005
    foot_acc: float = -0.007
    smooth: float = -0.003
    tracking_optimal_footholds: float = 1.0
    feet_stumble: float = 0.0
    feet_contact_forces: float = 0.0
    big_pitch: float = 0.0
    stumble: float = 0.0
    dof_vel_limits: float = 0.0
    torque_limits: float = 0.0
    orientation_roll: float = 0.0


@dataclasses.dataclass(frozen=True)
class RewardsCfg:
    # legged_robot_config.py:145-179 / lite3_dtc_config.py:136-140
    scales: RewardScales = field(default_factory=RewardScales)
    only_positive_rewards: bool = False
    tracking_sigma: float = 0.25
    soft_dof_pos_limit: float = 0.9
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 0.32
    max_contact_force: float = 100.0
    max_acc: float = 100.0


@dataclasses.dataclass(frozen=True)
class ObsScales:
    # legged_robot_config.py:182-188
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    height_measurements: float = 5.0
    force: float = 0.005


@dataclasses.dataclass(frozen=True)
class NormalizationCfg:
    obs_scales: ObsScales = field(default_factory=ObsScales)
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclasses.dataclass(frozen=True)
class NoiseScales:
    # legged_robot_config.py:195-201
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclasses.dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: NoiseScales = field(default_factory=NoiseScales)


@dataclasses.dataclass(frozen=True)
class TaskCfg:
    """Full task configuration (LeggedRobotCfg analog)."""
    env: EnvCfg = field(default_factory=EnvCfg)
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    asset: AssetCfg = field(default_factory=AssetCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    sim: SimParams = field(default_factory=SimParams)
    use_dtc_planner: bool = True      # LeggedRobotDTC vs LeggedRobot path

    @property
    def dt(self) -> float:
        """Policy dt = decimation * sim dt (legged_robot.py:1231)."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        import math
        return int(math.ceil(self.env.episode_length_s / self.dt))

    @property
    def push_interval(self) -> int:
        import math
        return int(math.ceil(self.domain_rand.push_interval_s / self.dt))


# --- PPO / runner side (LeggedRobotCfgPPO analog) ---------------------------

@dataclasses.dataclass(frozen=True)
class PolicyCfg:
    # legged_robot_config.py:231-239 + actor_critic_decoder.py AC_Args
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    activation: str = "elu"
    terrain_latent: int = 512
    cenet_latent: int = 16            # z dim; mu is 3 (vel) + 16
    policy_class_name: str = "ActorCriticDecoder"
    # latent_var outlier filter: "median" (exact reference semantics,
    # sort-free bitwise selection) or "mean" (cheap approximation)
    outlier_filter: str = "median"
    rnn_type: str = "gru"
    rnn_hidden_size: int = 256
    rnn_num_layers: int = 1


@dataclasses.dataclass(frozen=True)
class AlgorithmCfg:
    # legged_robot_config.py:241-254
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.003
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1.0e-3
    vae_learning_rate: float = 5.0e-4     # ppo.py:79
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    kld_weight: float = 4.0               # ppo.py:247
    # Belief-distillation loss weight (NO reference analog; default 0 =
    # exact reference semantics).  The reference's act_teacher deploys
    # through b_t = b_t1 + l_t*b_t1 from vae.memory_mlp, but NO loss
    # touches that module — its params stay at init, so the deployed
    # actor sees a random small-scale feature where training fed raw l_t
    # (update_distribution :431).  Policies vary in robustness to the
    # swap: the round-5 X30 run lost 3x episode length through
    # act_teacher while the raw-l_t path walked fine (CLAUDE.md).  With
    # weight w > 0 the VAE step adds w * mse(b_t, stop_grad(l_t)),
    # training the belief head to reconstruct the terrain latent from
    # history (the classic belief-state distillation) so act_teacher
    # matches the training-path actor at convergence.
    belief_loss_coef: float = 0.0
    # Minibatch shuffle granularity.  1 = exact reference semantics
    # (rollout_storage.py:165 randperm over individual transitions).
    # G > 1 permutes GROUPS of G flat-adjacent transitions (same timestep,
    # adjacent env ids) instead of single rows: the gradient estimator
    # stays unbiased (uniformly random partition at group granularity) and
    # adjacent-env samples are nearly independent (different terrains /
    # commands / phases), but the TPU row gather shrinks from T*N tiny
    # transfers to T*N/G large ones.  Deviation documented in PARITY.md.
    minibatch_perm_granule: int = 1
    # Minibatch-shuffle stratification (multi-chip data parallelism).
    # The flat (T*N) batch is split into S env-block strata and the
    # permutation is drawn independently WITHIN each stratum; every
    # minibatch takes an equal per-stratum slice.  With the env axis
    # sharded over D devices and D | S, the shuffle gather stays
    # device-LOCAL, so the PPO update runs data-parallel with one
    # gradient all-reduce per minibatch step — instead of GSPMD
    # all-gathering the whole rollout (~36 all-gathers, update then
    # replicated on every chip; observed in the compiled HLO,
    # tests/test_multichip_scaling.py).  The estimator is a uniformly
    # random partition stratified by env block — same spirit as the
    # G-grouping above; PARITY.md "Known deviations".  The value is a
    # CAP: the effective S is its gcd with the env count, further
    # reduced until per-stratum minibatch slices stay group-aligned.
    # S=1 reproduces the single global permutation exactly.  Measured on
    # the v5e: S=1 522.5k fps, S=8 489.5k at 4096 envs (the batched
    # per-stratum gather costs ~2-6% single-chip) — so 0 = AUTO picks
    # S = the mesh's env-shard count: exact round-4 program on one chip,
    # device-local data-parallel shuffle on meshes (where the
    # alternative is GSPMD all-gathering the rollout 36x and replicating
    # the whole update).  Pin an explicit S when 1-vs-D runs must draw
    # the SAME minibatch partition for bit-comparability
    # (tests/test_multichip_equiv.py pins 8).
    shuffle_strata: int = 0
    # Fused VAE+policy minibatch step (decoder policy only).  False = the
    # reference's sequential semantics: VAE loss f/b, VAE optimizer step,
    # then the policy f/b re-runs the (updated) cenet/terrain encoders
    # (ppo.py:197-254 then :265).  True = ONE shared encoder forward feeds
    # both heads and both grads are taken at the pre-VAE-step params
    # (Jacobi- instead of Gauss-Seidel-ordered optimizer pair); the two
    # optimizers and their routing stay exactly as in the reference.
    # Deviation + A/B evidence in PARITY.md "Known deviations".
    # Default ON since round 4: 73.6 vs 81.7 ms/update at 4096 envs,
    # 159.9 vs 180.3 at 8192 (profile_update_chain, v5e), with
    # per-minibatch loss trajectories matching the sequential path to
    # tolerance (tests/test_ppo.py::test_fused_joint_step_close_to_sequential).
    fused_joint_step: bool = True


@dataclasses.dataclass(frozen=True)
class RunnerCfg:
    # legged_robot_config.py:256-270
    num_steps_per_env: int = 24
    max_iterations: int = 20000
    save_interval: int = 50
    experiment_name: str = "lite3_dtc"
    run_name: str = ""
    resume: bool = False
    load_run: str = "-1"
    checkpoint: int = -1
    seed: int = 1
    # two-program mode measuring collection vs learning wall clock
    # (Perf/collection time + Perf/learning_time, on_policy_runner.py:196-198);
    # opt-in: it costs one extra host round-trip per iteration
    perf_split: bool = False
    # iterations chained into one dispatched program (lax.scan over the
    # full train iteration).  Identical math: the scan body IS train_iter
    # with the same key threading, so params after K chained iterations
    # match K single dispatches bit-for-bit (tests/test_train.py).
    #
    # DEFAULT 1 (block dispatch OFF).  Round-4 shipped K=10 as default
    # with only a CPU equivalence test; on the real v5e the K-scan
    # program runs ~23x SLOWER per iteration than K single dispatches
    # (29.2k vs 516.9k fps, VERDICT.md round 4) — XLA schedules the
    # Pallas-kernel-heavy body far worse inside the outer scan.  The
    # host-RPC overhead it targeted is already eliminated by packed
    # stats + in-graph RNG + async saves.  Do not raise this default
    # without a same-day on-TPU bench (CLAUDE.md process rule).
    iters_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    policy: PolicyCfg = field(default_factory=PolicyCfg)
    algorithm: AlgorithmCfg = field(default_factory=AlgorithmCfg)
    runner: RunnerCfg = field(default_factory=RunnerCfg)
