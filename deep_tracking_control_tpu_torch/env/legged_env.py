"""LeggedEnv — the vectorized quadruped environment on torch tensors.

Counterpart of the JAX package's env/legged_env.py (LeggedRobot.step +
LeggedRobotDTC.post_physics_step, legged_robot.py:55-1622 and
legged_robot_dtc.py:29-586): `step(params, state, actions, generator)`
over one state dict, masked resets with `torch.where`, the physics
decimation step, the fused terrain sampler, the foothold planner, the
reward stack and the observation tail.  On the card those five run as
CUDA kernels, and the reset's uniform draws come from the noise kernel;
on the CPU their plain versions run.

The route through a step is the JAX package's, chosen by the same
switches read at the same points (utils/flags.py):
  * default: the decimation kernel reading its contact window from the
    blocked table (K1), the fused sampler (K2), the fused planner (K3);
  * DTC_FUSED_WINDOW=0: the window copy (K5), then the decimation
    kernel's window variant (K1w);
  * DTC_PALLAS_SAMPLER=0: the 3-table patch copy (K4), K1w on its raw
    rows, and the plain samplers on the patches (heights, clearance, the
    next step's body planes);
  * DTC_PALLAS_PHYSICS=0 (read at init) or DTC_STRICT_PARITY=1: K4 and the
    plain decimation loop over physics/sim.py `sim_step`, where every
    contact point samples the terrain at every substep (the reference's
    semantics; the kernel freezes body-point planes for a step), the
    plain samplers, and the body planes left as they are;
  * DTC_PALLAS_PLANNER=0, physics off, or strict parity: the plain
    planner.
The reward, obs and noise kernels (K6-K8) run on every route.  The
decimation kernel steps a 4x3 quadruped at one physics substep on blocked
tables, as in the JAX package (legged_env.py:194-198 there); any other
revolute tree the URDF reader accepts (`AssetCfg.robot` a .urdf path), or
`cfg.sim.substeps` above 1, takes the route of physics off: K4, the plain
decimation loop over `sim_step` (the generic FK/ABA for a robot without
the 4x3 layout), the plain samplers and planner.

Every registry task steps here.  Tasks without the DTC planner
(lite3_rough, x30_rough, lite3_fast) launch no planner kernel: their
foothold obs are zero (45-dim obs omit the block) and they terminate by
the base-height checks of the non-DTC env (legged_robot.py:178-198).  A
plane task (lite3_fast) has no blocked tables, as in the JAX package:
the plain decimation loop over `sim_step` on the flat grid, zero height
scans, origins on the env_spacing grid and no reset offset; so it
launches no decimation or sampler kernel either.

Layout as in the JAX package: the physics core is env-trailing (k, N);
everything obs/reward-facing is env-leading (N, D).

`params` holds what stays fixed through a run: the per-env inertias, mass,
friction and restitution, and the world — the blocked terrain tables
(`terrain`, a PatchSource) and the tile origins (`terrain_origins`), both
None on a plane.
Random draws come from an explicit torch.Generator on the env's device;
`draws` can inject named draws instead (tests feed the JAX package's).
The obs noise and the reset's uniforms are Philox streams keyed by seeds
drawn from that generator (ops/cuda_rng.py), so the CPU and the card
draw the same noise from the same seed.

The step updates the (K, N) episode sums of the state it is given in
place (they are the widest per-step accumulator); do not step one state
twice.

Inside `graphed_steps` (the runner's collect), a step on the default
kernel route on the card, unsharded and without injected draws, runs as
a CUDA graph of its body (env/step_graph.py): the tensors it returns
then stay valid only until the next step.  The step reads its constant
vectors from the device (`_t`), so its body makes no host-device copy.

With `shard` (parallel/mesh.py EnvShard) the env steps one rank's block
of envs of a run sharded over torch.distributed ranks: `num_envs` is the
block's count.  `init` builds the whole world's state and keeps the
block (the terrain types and origins depend on the global env index);
every draw of a leading env axis is made at the global count and sliced,
so the ranks' generators stay in lockstep and each rank draws its rows of
the unsharded run's draws; the noise kernels take the block's first row;
the command curriculum reads its counts over all envs.  The step's
metrics are the block's sums (the runner adds them up over the ranks).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import cuda_rng
from ..ops import quat as qm
from ..parallel import mesh as pmesh
from ..physics import cuda_substep, engine, quadruped
from ..physics import sim as psim
from ..robot import quadrupeds
from ..robot.model import RobotModel, load_urdf
from ..terrain import cuda_sampler
from ..terrain import grid as tgrid
from ..terrain import patch as tpatch
from ..terrain.generator import DESCENT_FAMILIES, Terrain, column_families
from ..terrain.grid import TerrainGrid
from ..utils import trace
from ..utils.flags import kernel_flag
from . import cuda_obs, cuda_planner, cuda_rewards, planner, step_graph
from . import rewards as rew_mod
from .config import TaskCfg

F32 = torch.float32


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


class LeggedEnv:
    """Static env object: robot model, terrain, constants.  All step/reset
    logic is in methods over (params, state) dicts."""

    def __init__(self, cfg: TaskCfg, terrain_seed: int = 0, device="cuda",
                 shard=None):
        if shard is not None and shard.num_envs != cfg.env.num_envs:
            raise ValueError(f"shard of {shard.num_envs} envs for a task of "
                             f"{cfg.env.num_envs}")
        self.cfg = cfg
        self.shard = shard
        # the shard that the draws and reductions read: None while `init`
        # builds the whole world
        self._sh = shard
        self.device = torch.device(device)
        dev = self.device
        if cfg.asset.robot.endswith(".urdf"):
            self.model: RobotModel = load_urdf(cfg.asset.robot)
        else:
            self.model = quadrupeds.get_robot(cfg.asset.robot)
        m = self.model
        self.geom = psim.default_contact_geometry(m)

        # --- terrain (the native generator where g++ builds it, as the JAX
        # package's env: Terrain's backend="auto"); a plane task steps a
        # flat grid, has no tile origins and no blocked tables ------------
        if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            self.terrain = Terrain(cfg.terrain, seed=terrain_seed)
            self.grid = TerrainGrid(
                height=torch.as_tensor(self.terrain.heights_meters(),
                                       device=dev),
                horizontal_scale=cfg.terrain.horizontal_scale,
                border_size=cfg.terrain.border_size)
            self.terrain_origins = torch.as_tensor(self.terrain.env_origins,
                                                   dtype=F32, device=dev)
            self.patch_src = self.make_patch_source(self.grid)
        else:
            self.terrain = None
            self.grid = tgrid.flat_grid(2 * cfg.terrain.border_size,
                                        cfg.terrain.horizontal_scale, dev)
            self.terrain_origins = None
            self.patch_src = None

        # --- joint constants (legged_robot.py:872-888, 495-508) ----------
        jn = m.joint_names
        self.default_dof_pos = np.zeros(m.nq, dtype=np.float32)
        dja = dict(cfg.init_state.default_joint_angles)
        p_gains = np.zeros(m.nq, dtype=np.float32)
        d_gains = np.zeros(m.nq, dtype=np.float32)
        for i, name in enumerate(jn):
            self.default_dof_pos[i] = dja.get(name, 0.0)
            for key, val in cfg.control.stiffness:
                if key in name:
                    p_gains[i] = val
            for key, val in cfg.control.damping:
                if key in name:
                    d_gains[i] = val
        self.p_gains, self.d_gains = p_gains, d_gains
        self.torque_limits = (0.8 * m.effort_limit).astype(np.float32)
        self.dof_vel_limits = m.vel_limit.astype(np.float32)
        lo, hi = m.pos_limit[:, 0], m.pos_limit[:, 1]
        mid, rng = (lo + hi) / 2, hi - lo
        s = cfg.rewards.soft_dof_pos_limit
        self.soft_dof_pos_limits = (
            (mid - 0.5 * rng * s).astype(np.float32),
            (mid + 0.5 * rng * s).astype(np.float32))
        self.dof_pos_limits = (lo.astype(np.float32), hi.astype(np.float32))

        # --- body index sets (legged_robot_dtc.py:362-457) ---------------
        self.feet_idx = np.array(
            [i for i, n in enumerate(m.body_names) if cfg.asset.foot_name in n],
            dtype=np.int32)
        self.penalised_idx = np.array(sorted(
            {i for kw in cfg.asset.penalize_contacts_on for i in m.match_bodies(kw)}),
            dtype=np.int32)
        self.termination_idx = np.array(sorted(
            {i for kw in cfg.asset.terminate_after_contacts_on
             for i in m.match_bodies(kw)}), dtype=np.int32)
        self.thigh_dyn_idx = np.array(
            [m.body_dyn_index[i] for i, n in enumerate(m.body_names)
             if cfg.asset.thigh_name in n], dtype=np.int32)
        self.hip_dof_idx = np.array(
            [i for i, n in enumerate(jn) if "HipX" in n], dtype=np.int32)

        # --- height scan constants (legged_robot.py:1263-1277) -----------
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y),
                             indexing="ij")
        self.num_height_points = gx.size
        self.height_points = np.stack(
            [gx.flatten(), gy.flatten(), np.zeros_like(gx.flatten())],
            axis=1).astype(np.float32)                              # (H,3)
        A = self.height_points.copy()
        A[:, 2] = 1.0
        self.plane_pinv = (np.linalg.inv(A.T @ A) @ A.T).astype(np.float32)
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], dtype=np.float32)
        self.acc_points = corners * np.array([0.3, 0.2, 0.15],
                                             dtype=np.float32) / 2.0
        self.commands_scale = np.array(
            [cfg.normalization.obs_scales.lin_vel,
             cfg.normalization.obs_scales.lin_vel,
             cfg.normalization.obs_scales.ang_vel], dtype=np.float32)
        self._descent_cols = None
        if (cfg.commands.descent_clamp > 0.0 and self.terrain is not None
                and cfg.terrain.curriculum and not cfg.terrain.selected):
            fams = column_families(cfg.terrain)
            self._descent_cols = torch.as_tensor(
                [f in DESCENT_FAMILIES for f in fams], device=dev)
        self.noise_scale_vec = self._make_noise_scale_vec()

        # reward bookkeeping (legged_robot.py:929-948)
        sc = cfg.rewards.scales
        self.reward_names = rew_mod.active_reward_names(sc)
        self.reward_scales_dt = {n: getattr(sc, n) * cfg.dt
                                 for n in self.reward_names}
        self.termination_scale_dt = sc.termination * cfg.dt
        self.episode_sum_names = list(self.reward_names)
        if sc.termination != 0.0:
            self.episode_sum_names.append("termination")

        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.num_envs = cfg.env.num_envs if shard is None else shard.n_local
        self.num_obs_history = cfg.env.num_observation_history * self.num_obs
        self.max_episode_length = cfg.max_episode_length
        base_w = 9 + 2 * m.nq + self.num_actions
        if self.num_obs == base_w + 8:
            self._obs_has_foothold = True
        elif self.num_obs == base_w:
            self._obs_has_foothold = False
        else:
            raise ValueError(
                f"num_observations={self.num_obs} matches neither the "
                f"{base_w}-dim base layout nor the {base_w + 8}-dim DTC "
                f"layout of {m.name} ({m.nq} joints, "
                f"{len(m.foot_body_index)} feet) with {self.num_actions} "
                f"actions")

        # device copies of the constants used every step
        def t(a, dtype=F32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        self._t = dict(
            default_q=t(self.default_dof_pos), p_gains=t(p_gains),
            d_gains=t(d_gains), pos_lo=t(self.dof_pos_limits[0]),
            pos_hi=t(self.dof_pos_limits[1]),
            soft_lo=t(self.soft_dof_pos_limits[0]),
            soft_hi=t(self.soft_dof_pos_limits[1]),
            torque_limits=t(self.torque_limits),
            dof_vel_limits=t(self.dof_vel_limits),
            height_points=t(self.height_points), plane_pinv=t(self.plane_pinv),
            acc_points=t(self.acc_points), commands_scale=t(self.commands_scale),
            noise_scale_vec=t(self.noise_scale_vec),
            feet_idx=t(self.feet_idx, torch.long),
            penalised_idx=t(self.penalised_idx, torch.long),
            termination_idx=t(self.termination_idx, torch.long),
            hip_dof_idx=t(self.hip_dof_idx, torch.long),
            thigh_dyn_idx=t(self.thigh_dyn_idx, torch.long),
            win_offset=t([cuda_substep.WIN_R0, cuda_substep.WIN_C0]),
            gravity=t([0.0, 0.0, -1.0]), heading_axis=t([1.0, 0.0, 0.0]),
            init_pos=t(cfg.init_state.pos), init_rot=t(cfg.init_state.rot))
        # the decimation kernel for a 4x3 quadruped at one substep on
        # blocked tables (legged_env.py:194-198 of the JAX package); else
        # the plain decimation loop over sim_step: DTC_PALLAS_PHYSICS=0,
        # DTC_STRICT_PARITY=1, a plane, more than one substep, or another
        # robot (the generic FK/ABA)
        self._kernel_physics = (kernel_flag("DTC_PALLAS_PHYSICS", "1")
                                and self.patch_src is not None
                                and quadruped.quad_layout(m) is not None
                                and cfg.sim.substeps == 1)
        # the kernel's constant table: 4x3 rows, so on its route only
        self._consts = (torch.as_tensor(cuda_substep.pack_constants(
            m, self.geom, cfg.sim, self.thigh_dyn_idx,
            cfg.terrain.horizontal_scale), device=dev)
            if self._kernel_physics else None)
        # the step's CUDA graphs (env/step_graph.py), one a (params,
        # generator), engaged inside `graphed_steps` alone
        self._graph_scope = False
        self._step_graphs = {}

    # ------------------------------------------------------------------
    @staticmethod
    def make_patch_source(grid: TerrainGrid) -> tpatch.PatchSource:
        """Blocked [raw, min3, max10] tables of a heightfield."""
        min3, max10 = tpatch.pooled_tables(grid)
        return tpatch.make_source(grid, torch.stack([grid.height, min3, max10]))

    def _make_noise_scale_vec(self) -> np.ndarray:
        """Obs-noise scale vector (legged_robot.py:729-752)."""
        cfg = self.cfg
        ns = cfg.noise.noise_scales
        lvl = cfg.noise.noise_level
        os_ = cfg.normalization.obs_scales
        nq = self.model.nq
        v = np.zeros(cfg.env.num_observations, dtype=np.float32)
        v[0:3] = ns.ang_vel * lvl * os_.ang_vel
        v[3:6] = ns.gravity * lvl
        v[9:9 + nq] = ns.dof_pos * lvl * os_.dof_pos
        v[9 + nq:9 + 2 * nq] = ns.dof_vel * lvl * os_.dof_vel
        return v

    @staticmethod
    def _draw(draws, name, fn):
        """A random draw: injected under `name`, or made by fn()."""
        if draws is not None and name in draws:
            return draws[name]
        return fn()

    def _rows(self, draw, *shape):
        """This block's rows of draw(shape at the global env count)."""
        return pmesh.rows(draw(pmesh.global_shape(shape, self._sh)), self._sh)

    def _uni(self, gen, shape, lo, hi):
        return self._rows(lambda sh: _uniform(gen, sh, lo, hi, self.device),
                          *shape)

    def _offset(self, name, row_width=1) -> dict:
        """The noise kernels' keyword of a block's first row (element
        offset row0 * row_width, or row0): none unsharded."""
        if self._sh is None:
            return {}
        return {name: self._sh.row0 * row_width}

    # ------------------------------------------------------------------
    # construction of params + initial state
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator, draws=None):
        """(params, state): per-env DR draws, zero state, full reset
        (_create_envs legged_robot.py:416-527, _init_buffers :755-905).
        draws: optional injected draws, "init_levels" (N,) and those of
        `_apply_reset`, at the global env count.  A sharded env builds the
        global (params, state) and keeps its block (pmesh.shard_tree)."""
        if self.shard is None:
            return self._init(generator, draws)
        n_local = self.num_envs
        self.num_envs, self._sh = self.shard.num_envs, None
        try:
            params, state = self._init(generator, draws)
        finally:
            self.num_envs, self._sh = n_local, self.shard
        return (pmesh.shard_tree(params, self.shard),
                pmesh.shard_tree(state, self.shard))

    def _init(self, generator, draws):
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        gen = generator
        dr = cfg.domain_rand

        nb_buckets = 64 * 5                       # legged_robot.py:429-460
        fb = _uniform(gen, (nb_buckets,), *dr.friction_range, dev)
        rb = _uniform(gen, (nb_buckets,), *dr.restitution_range, dev)
        fid = torch.randint(0, nb_buckets, (N,), generator=gen, device=dev)
        rid = torch.randint(0, nb_buckets, (N,), generator=gen, device=dev)
        friction = fb[fid] if dr.randomize_friction else torch.ones(N, device=dev)
        restitution = (rb[rid] if dr.randomize_restitution
                       else torch.zeros(N, device=dev))
        payload = (_uniform(gen, (N,), *dr.added_mass_range, dev)
                   if dr.randomize_base_mass else torch.zeros(N, device=dev))
        # no COM displacement: the JAX package multiplies its draw by 0
        link_scale = (_uniform(gen, (N,), *dr.link_mass_range, dev)
                      if dr.randomize_link_mass else None)
        inertias, robot_mass = engine.make_inertias(
            m, payload=payload, link_mass_scale=link_scale, num_envs=N,
            device=dev)
        params = dict(inertias=inertias.contiguous(), robot_mass=robot_mass,
                      friction=friction.contiguous(),
                      restitution=restitution.contiguous(),
                      terrain=self.patch_src,
                      terrain_origins=self.terrain_origins)

        # terrain levels/types/origins (legged_robot.py:1201-1228)
        if self.terrain is not None:
            rows, cols = cfg.terrain.num_rows, cfg.terrain.num_cols
            max_init = cfg.terrain.max_init_terrain_level
            if not cfg.terrain.curriculum:
                max_init = rows - 1
            levels = self._draw(draws, "init_levels", lambda: torch.randint(
                0, max_init + 1, (N,), generator=gen, device=dev))
            types = torch.floor(torch.arange(N, device=dev, dtype=F32)
                                / max(N / cols, 1e-9)).to(torch.int32)
            types = torch.clamp(types, 0, cols - 1)
            # a level beyond the rows reads the last row, as JAX's gather
            # clamps
            origins = self.terrain_origins[
                torch.clamp(levels, max=rows - 1).long(), types.long()]
        else:
            # a plane: level and type 0, origins on the env_spacing grid
            levels = torch.zeros((N,), dtype=torch.int32, device=dev)
            types = torch.zeros((N,), dtype=torch.int32, device=dev)
            ncols = int(np.floor(np.sqrt(N)))
            nrows = int(np.ceil(N / ncols))
            xx, yy = torch.meshgrid(torch.arange(nrows, device=dev),
                                    torch.arange(ncols, device=dev),
                                    indexing="ij")
            spacing = cfg.env.env_spacing
            origins = torch.stack(
                [spacing * xx.flatten()[:N], spacing * yy.flatten()[:N],
                 torch.zeros(N, device=dev)], dim=1).to(F32)

        zeros_q = torch.zeros((m.nq, N), device=dev)
        quat = torch.zeros((4, N), device=dev)
        quat[3] = 1.0
        phys = engine.make_state(
            pos=torch.zeros((3, N), device=dev), quat=quat,
            lin_vel=torch.zeros((3, N), device=dev),
            ang_vel=torch.zeros((3, N), device=dev),
            q=zeros_q, qd=zeros_q.clone())

        nq, nf = m.nq, len(self.feet_idx)
        nbp = len(self.geom.dyn_idx) - nf

        def z(*shape, dtype=F32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        planes = z(nbp, 5, N)
        planes[:, 0] = -1e4
        state = dict(
            phys=phys,
            anchors=psim.init_anchors(self.geom, N, device=dev),
            commands=z(N, 4),
            command_lin_vel_x=torch.tensor(cfg.commands.ranges.lin_vel_x,
                                           dtype=F32, device=dev),
            episode_length=z(N, dtype=torch.int32),
            common_step=z(dtype=torch.int32),
            actions=z(N, nq), last_actions=z(N, nq), last_actions_2=z(N, nq),
            last_dof_vel=z(N, nq), last_foot_velocities=z(N, nf, 3),
            feet_air_time=z(N, nf), last_contacts=z(N, nf, dtype=torch.bool),
            contact_filt=z(N, nf, dtype=torch.bool),
            stumb_buffer=z(N, 5, nf, dtype=torch.bool),
            lag_buffer=z(N, dr.lag_timesteps, nq),
            lin_vel_buffer=z(N, 10, 2), ang_vel_buffer=z(N, 10, 1),
            cmd_buffer=z(N, 10, 4), height_noise_offset=z(N),
            terrain_levels=levels.to(torch.int32),
            terrain_types=types.to(torch.int32),
            env_origins=origins, push_force=z(N, 3),
            motor_strengths=torch.ones((N, nq), device=dev),
            kp_factors=torch.ones((N, nq), device=dev),
            kd_factors=torch.ones((N, nq), device=dev),
            motor_offsets=z(N, nq),
            episode_sums=z(len(self.episode_sum_names), N),
            pitch_est=z(N),
            obs_history=z(N, self.num_obs_history), obs=z(N, self.num_obs),
            privileged_obs=z(N, self.num_privileged_obs), base_vel=z(N, 3),
            foothold_obs=z(N, 8), optimal_footholds_world=z(N, nf, 3),
            torques=z(N, nq),
            body_pts=z(nbp, 3, N),
            # frozen contact planes [h0, gx, gy, x0, y0] of the body points;
            # h0 = -1e4 means "no contact" (reset-safe)
            planes=planes,
            reset_buf=z(N, dtype=torch.bool), time_out_buf=z(N, dtype=torch.bool),
            rew_buf=z(N), measured_heights=z(N, self.num_height_points),
            measured_foot_clearance=z(N, nf),
        )
        state = self._apply_reset(params, state,
                                  torch.ones((N,), dtype=torch.bool, device=dev),
                                  gen, draws)
        return params, state

    def reset(self, params, state, generator):
        """Reset all envs, then a zero-action step (base_task.py:115-121)."""
        N = self.num_envs
        state = self._apply_reset(params, state,
                                  torch.ones((N,), dtype=torch.bool,
                                             device=self.device), generator)
        return self.step(params, state,
                         torch.zeros((N, self.num_actions), device=self.device),
                         generator)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def graphed_steps(self):
        """Within: a step on the graph route (`_graph_route`) replays a CUDA
        graph of itself (env/step_graph.py), whose returned tensors stay
        valid only until the next step of the same (params, generator):
        copy what is kept past it.  runner/train.py `collect` opts in."""
        was, self._graph_scope = self._graph_scope, True
        try:
            yield
        finally:
            self._graph_scope = was

    def _graph_route(self, draws) -> bool:
        """Whether a step can run as a CUDA graph: inside `graphed_steps`,
        on the card, unsharded (the sharded step reduces over the ranks),
        without injected draws, and on the kernel route that has no host
        sync: the decimation kernel reading the blocked tables (K1), the
        fused sampler (K2) and, where the planner runs, its kernel (K3)."""
        cfg = self.cfg
        return (self._graph_scope and draws is None
                and self.device.type == "cuda" and self._sh is None
                and self._kernel_physics and cfg.terrain.measure_heights
                and not cfg.env.debug_viz
                and kernel_flag("DTC_PALLAS_SAMPLER", "1")
                and kernel_flag("DTC_FUSED_WINDOW", "1")
                and kernel_flag("DTC_PALLAS_PLANNER", "1"))

    @trace.spanned("dtc/env.step")
    def step(self, params, state, actions, generator, draws=None):
        """One policy step (LeggedRobot.step + DTC post_physics_step).

        Returns (new_state, out) with out = dict(obs, privileged_obs,
        obs_history, base_vel, rew, done, time_out, metrics).  `draws` may
        inject "lag" (decimation,) int64 lag indices and "noise_seed", the
        (2,) int64 seed of the obs noise; on the CPU also the noise itself,
        "height_noise" (N,H) and "obs_noise" (N, num_obs) uniforms in
        [-1, 1).  Inside `graphed_steps`, on the graph route, the step's
        CUDA graph for (params, generator) runs it."""
        if self._graph_route(draws):
            key = (id(params), id(generator))
            graph = self._step_graphs.get(key)
            if graph is None:
                graph = self._step_graphs[key] = step_graph.StepGraph(
                    params, generator)
            return graph(self._step, params, state, actions)
        trace.graph_call(step_graph.NAME, "eager")
        return self._step(params, state, actions, generator, draws)

    def _step(self, params, state, actions, generator, draws=None):
        """The step's body (see `step`)."""
        cfg = self.cfg
        dev = self.device
        gen = generator
        T = self._t
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions, -clip_a, clip_a)           # :98-99
        phys = {k: v.contiguous() for k, v in state["phys"].items()}
        lag = state["lag_buffer"]
        src = params["terrain"]

        use_kernel = self._kernel_physics
        use_sampler = (use_kernel and cfg.terrain.measure_heights
                       and kernel_flag("DTC_PALLAS_SAMPLER", "1"))

        # per-env terrain starts; the 3-table patches are materialized
        # only off the sampler route, the contact window only on
        # DTC_FUSED_WINDOW=0 (legged_env.py:393-436 of the JAX package); a
        # plane has neither
        starts = patch_origin = patches = window = None
        if src is not None:
            with trace.span("dtc/env.step/terrain"):
                starts, patch_origin = tpatch.patch_starts(
                    src, phys["pos"].T[:, :2])
                if not use_sampler:
                    patches = tpatch.extract(src, starts)   # (3,N,64,128)
                elif not kernel_flag("DTC_FUSED_WINDOW", "1"):
                    window = tpatch.extract_window(src, starts,
                                                   cuda_substep.WIN_R0,
                                                   cuda_substep.WIN_R)
        with trace.span("dtc/env.step/physics"):
            actions_scaled = actions * cfg.control.action_scale
            # action-lag indices: one randint(1,5) shared across envs per
            # sim step (legged_robot.py:608-614)
            choices = self._draw(draws, "lag", lambda: torch.randint(
                1, 5, (cfg.control.decimation,), generator=gen, device=dev))
            choices = choices.to(device=dev, dtype=torch.long)
            # PD goals per substep: the lag-buffer roll does not depend on
            # q, so all `decimation` targets are computed up front
            goals = []
            for s in range(cfg.control.decimation):
                lag = torch.cat([lag[:, 1:], actions_scaled[:, None, :]],
                                dim=1)
                g = (lag.index_select(1, choices[s:s + 1])[:, 0]
                     + T["default_q"])
                g = torch.maximum(torch.minimum(g, T["pos_hi"]), T["pos_lo"])
                goals.append(g.T)
            if use_kernel:
                state, info = self._kernel_physics_step(
                    params, state, actions, lag, goals, phys, starts,
                    patch_origin, patches, window, use_sampler)
            else:
                state, info = self._plain_physics_step(
                    params, state, actions, lag, goals, patches, patch_origin)
        return self._post_physics_step(params, state, info, gen, draws)

    def _kernel_physics_step(self, params, state, actions, lag, goals, phys,
                             starts, patch_origin, patches, window,
                             use_sampler):
        """The `decimation` sim steps in one decimation kernel call (K1, or
        K1w on a materialized window)."""
        cfg = self.cfg
        m = self.model
        T = self._t
        src = params["terrain"]
        hs = src.horizontal_scale
        goals = torch.stack(goals).contiguous()
        kp_eff = (T["p_gains"] * state["kp_factors"]).T.contiguous()
        kd_eff = (T["d_gains"] * state["kd_factors"]).T.contiguous()
        worigin = (patch_origin + hs * T["win_offset"]).T.contiguous()
        if patches is not None:
            window = patches[0][:, cuda_substep.WIN_R0:
                                cuda_substep.WIN_R0 + cuda_substep.WIN_R]
        fused = window is None
        phys, anchors, kinfo = cuda_substep.decimation_step(
            m, self.geom, cfg.sim, cfg.control.decimation, self.thigh_dyn_idx,
            params["inertias"], phys, state["anchors"].contiguous(), goals,
            kp_eff, kd_eff, state["motor_strengths"].T.contiguous(),
            state["motor_offsets"].T.contiguous(), params["friction"],
            params["restitution"], worigin, state["planes"].contiguous(), hs,
            src.blocks if fused else None, starts if fused else None,
            consts=self._consts, window=window)
        state = {**state, "phys": phys, "anchors": anchors, "lag_buffer": lag,
                 "actions": actions, "torques": kinfo["torques"].T,
                 "body_pts": kinfo["body_pts"]}
        info = dict(kinfo, patch_origin=patch_origin, starts=starts,
                    patches=patches, use_kernel=True, use_sampler=use_sampler)
        return state, info

    def _plain_physics_step(self, params, state, actions, lag, goals,
                            patches, patch_origin):
        """The JAX package's XLA decimation loop (legged_env.py:496-529):
        per sim step the PD torque (motor strength and offset, clipped at
        the torque limit) and `sim_step`, every contact point sampling the
        raw patch (on a plane, the flat grid); the env reads the last sim
        step's outputs."""
        cfg = self.cfg
        T = self._t
        if patches is None:
            def terrain_fn(x, y):
                return tgrid.height_and_slope(self.grid, x, y)
        else:
            hs = params["terrain"].horizontal_scale

            def terrain_fn(x, y):
                # physics layout (K, N) -> sampler layout (N, K), and back
                h, dx, dy, hmx = tpatch.sample_bilinear_slope(
                    patches[0], patch_origin, hs, x.T, y.T)
                return h.T, dx.T, dy.T, hmx.T

        phys, anchors = state["phys"], state["anchors"]
        kp = T["p_gains"] * state["kp_factors"]
        kd = T["d_gains"] * state["kd_factors"]
        tl = T["torque_limits"]
        for goal in goals:
            q_t, qd_t = phys["q"].T, phys["qd"].T
            tau = kp * (goal.T - q_t + state["motor_offsets"]) - kd * qd_t
            tau = tau * state["motor_strengths"]
            tau = torch.minimum(torch.maximum(tau, -tl), tl)
            phys, anchors, sinfo = psim.sim_step(
                self.model, self.geom, cfg.sim, params["inertias"], phys,
                anchors, tau.T, terrain_fn, params["friction"],
                params["restitution"])
        info = dict(contact_forces=sinfo["contact_forces"],
                    foot_pos=sinfo["foot_pos"], foot_vel=sinfo["foot_vel"],
                    thigh_pos=sinfo["kin"]["x"][T["thigh_dyn_idx"]],
                    patches=patches, patch_origin=patch_origin,
                    use_kernel=False, use_sampler=False)
        state = {**state, "phys": phys, "anchors": anchors, "lag_buffer": lag,
                 "actions": actions, "torques": tau}
        return state, info

    # ------------------------------------------------------------------
    def _post_physics_step(self, params, state, info, gen, draws):
        """LeggedRobotDTC.post_physics_step (dtc.py:56-227)."""
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        T = self._t
        phys = state["phys"]

        episode_length = state["episode_length"] + 1
        common_step = state["common_step"] + 1

        base_pos = phys["pos"].T
        base_quat = phys["quat"].T
        base_lin_vel = qm.quat_rotate_inverse(base_quat, phys["lin_vel"].T)
        base_ang_vel = qm.quat_rotate_inverse(base_quat, phys["ang_vel"].T)
        projected_gravity = qm.quat_rotate_inverse(
            base_quat, T["gravity"].expand(N, 3))
        dof_pos = phys["q"].T
        dof_vel = phys["qd"].T
        foot_positions = info["foot_pos"].permute(2, 0, 1)        # (N,4,3)
        foot_velocities = info["foot_vel"].permute(2, 0, 1)
        contact_forces = info["contact_forces"].permute(2, 0, 1)  # (N,B,3)

        # soft-tracking buffers (dtc.py:76-81)
        lin_vel_buffer = torch.cat(
            [state["lin_vel_buffer"][:, 1:], base_lin_vel[:, None, :2]], dim=1)
        ang_vel_buffer = torch.cat(
            [state["ang_vel_buffer"][:, 1:], base_ang_vel[:, None, 2:3]], dim=1)

        # commands (legged_robot.py:529-564)
        with trace.span("dtc/env.step/commands"):
            resample_every = int(cfg.commands.resampling_time / cfg.dt)
            need_resample = (episode_length % resample_every) == 0
            commands = self._resample_commands_where(
                state["commands"], need_resample, state["command_lin_vel_x"],
                gen)
            commands = self._clamp_descent_commands(
                commands, state["terrain_types"], state["terrain_levels"])
            if cfg.commands.heading_command:                      # :536-539
                fwd = qm.quat_rotate(base_quat,
                                     T["heading_axis"].expand(N, 3))
                heading = torch.atan2(fwd[:, 1], fwd[:, 0])
                commands = commands.clone()
                commands[:, 2] = torch.clamp(
                    0.5 * qm.wrap_to_pi(commands[:, 3] - heading), -1.5, 1.5)
            cmd_buffer = torch.cat(
                [state["cmd_buffer"][:, 1:], commands[:, None, :]], dim=1)

        # the terrain queries of the step: the min3 height scan, the max10
        # foot clearance and the next step's body planes
        with trace.span("dtc/env.step/terrain"):
            hp = T["height_points"]
            cy, sy = qm.yaw_rot2d(base_quat)
            scan = (cy[:, None] * hp[None, :, 0] - sy[:, None] * hp[None, :, 1]
                    + base_pos[:, 0:1],
                    sy[:, None] * hp[None, :, 0] + cy[:, None] * hp[None, :, 1]
                    + base_pos[:, 1:2])
            bp = state["body_pts"]                               # (Pb,3,N)
            nb, nf = bp.shape[0], foot_positions.shape[1]
            nh = self.num_height_points
            h10 = planes_next = None
            if info["use_sampler"]:
                # every query of the step in one fused sampler call
                def packq(c):
                    fill = base_pos[:, c:c + 1]
                    return torch.cat([
                        scan[c], fill.expand(N, cuda_sampler.Q_MIN3 - nh),
                        foot_positions[..., c],
                        fill.expand(N, cuda_sampler.Q_MAX10 - nf),
                        bp[:, c].T, fill.expand(N, cuda_sampler.Q_BIL - nb)],
                        dim=1)

                h_all, gxs, gys = cuda_sampler.sample_all(
                    params["terrain"], info["starts"], info["patch_origin"],
                    packq(0), packq(1))
                measured_heights = h_all[:, :nh]
                h10 = h_all[:, cuda_sampler.Q_MIN3:cuda_sampler.Q_MIN3 + nf]
                off = cuda_sampler.Q_MIN3 + cuda_sampler.Q_MAX10
                planes_next = torch.stack(
                    [h_all[:, off:off + nb].T, gxs[:, :nb].T, gys[:, :nb].T,
                     bp[:, 0], bp[:, 1]], dim=1)                 # (Pb,5,N)
            elif info["patches"] is not None:
                # the plain samplers on the materialized patches
                # (legged_env.py:626-650, 666-675 of the JAX package)
                patches, origin = info["patches"], info["patch_origin"]
                hs = params["terrain"].horizontal_scale
                measured_heights = (
                    tpatch.sample_nearest(patches[1], origin, hs, scan[0],
                                          scan[1])
                    if cfg.terrain.measure_heights
                    else torch.zeros((N, nh), device=dev))
                h10 = tpatch.sample_nearest(patches[2], origin, hs,
                                            foot_positions[..., 0],
                                            foot_positions[..., 1])
                if info["use_kernel"]:
                    # the kernel's next-step body planes; the plain loop
                    # samples every point each substep and keeps none
                    h0, gx0, gy0, _ = tpatch.sample_bilinear_slope(
                        patches[0], origin, hs, bp[:, 0].T, bp[:, 1].T)
                    planes_next = torch.stack(
                        [h0.T, gx0.T, gy0.T, bp[:, 0], bp[:, 1]], dim=1)
            else:
                # a plane: zero heights (legged_robot.py:1292-1293)
                measured_heights = torch.zeros((N, nh), device=dev)

        # random pushes (legged_robot.py:546-556, 673-678)
        push_force = state["push_force"]
        if cfg.domain_rand.push_robots:
            dr = cfg.domain_rand
            interval = cfg.push_interval
            do_push = (common_step % interval) == 0
            in_window = (common_step % interval) < 2
            new_vxy = self._uni(gen, (N, 2), -dr.max_push_vel_xy,
                                dr.max_push_vel_xy)
            pushed = phys["lin_vel"].clone()
            pushed[:2] = new_vxy.T
            phys = {**phys, "lin_vel": torch.where(do_push, pushed,
                                                   phys["lin_vel"])}
            new_force = torch.zeros((N, 3), device=dev)
            new_force[:, :2] = self._uni(gen, (N, 2), -dr.max_push_force_xy,
                                         dr.max_push_force_xy)
            push_force = torch.where(
                in_window, torch.where(do_push, new_force, push_force),
                torch.zeros_like(push_force))

        # foot clearance (max-of-10, legged_robot.py:1443-1472)
        if cfg.terrain.measure_foot_clearance and h10 is not None:
            measured_foot_clearance = foot_positions[..., 2] - h10
        else:
            measured_foot_clearance = foot_positions[..., 2]

        # contact filter (legged_robot.py:561-564)
        feet_contact = contact_forces[:, T["feet_idx"], 2] > 1.0
        contact_filt = feet_contact | state["last_contacts"]
        last_contacts = feet_contact

        # DTC foothold planner (dtc.py:100-204): the fused planner on the
        # kernel route; debug viz needs the score tensor, which only the
        # plain planner returns.  Without the planner the foothold obs are
        # zero and the "optimal" footholds are the feet.
        with trace.span("dtc/env.step/planner"):
            debug = None
            if cfg.use_dtc_planner and cfg.terrain.measure_heights:
                hips = info["thigh_pos"].permute(2, 0, 1)
                use_planner_kernel = (
                    info["use_kernel"] and not cfg.env.debug_viz
                    and kernel_flag("DTC_PALLAS_PLANNER", "1"))
                plan_fn = (cuda_planner.plan_footholds_fused
                           if use_planner_kernel else planner.plan_footholds)
                plan = plan_fn(cfg, base_pos, base_quat, base_lin_vel,
                               commands, hips, measured_heights,
                               self.height_points,
                               cfg.terrain.measured_points_x,
                               cfg.terrain.measured_points_y)
                foothold_obs = plan["foothold_obs"]
                optimal_footholds_world = plan["optimal_footholds_world"]
                if cfg.env.debug_viz:
                    debug = dict(heights_world=plan["heights_world"],
                                 foothold_score=plan["foothold_score"],
                                 pred_footholds=plan["pred_footholds"],
                                 foot_positions=foot_positions)
            else:
                foothold_obs = state["foothold_obs"] * 0.0
                optimal_footholds_world = foot_positions

        # termination (dtc.py:229-251 / legged_robot.py:178-198)
        if len(self.termination_idx):
            cf_term = contact_forces[:, T["termination_idx"]]
            term_contact = torch.any(
                torch.linalg.vector_norm(cf_term, dim=-1) > 100.0, dim=1)
        else:
            term_contact = torch.zeros((N,), dtype=torch.bool, device=dev)
        time_out_buf = episode_length > self.max_episode_length
        ny = cfg.terrain.measured_y_dim
        if cfg.use_dtc_planner:
            term_gravity = projected_gravity[:, 2] > 0.2          # :239
            if cfg.terrain.measure_heights:
                lo_i, hi_i = 10 * ny, (cfg.terrain.measured_x_dim - 10) * ny
                # origin-relative body height (the JAX package's fix of
                # dtc.py:243)
                oz = state["env_origins"][:, 2:3]
                center = torch.clamp(measured_heights[:, lo_i:hi_i] - oz,
                                     min=0.0)
                term_height = torch.mean(base_pos[:, 2:3] - oz - center,
                                         dim=1) < 0.15
            else:
                term_height = torch.zeros_like(term_gravity)
        else:
            # the base below its feet, and with a height scan below the
            # terrain under its middle rows (legged_robot.py:178-198)
            term_gravity = torch.zeros((N,), dtype=torch.bool, device=dev)
            term_height = torch.mean(
                base_pos[:, 2:3] - foot_positions[:, :, 2], dim=1) < 0.1
            if cfg.terrain.measure_heights:
                lo_i, hi_i = 13 * ny, (cfg.terrain.measured_x_dim - 13) * ny
                term_height = term_height | (torch.mean(
                    base_pos[:, 2:3] - measured_heights[:, lo_i:hi_i],
                    dim=1) < 0.1)
        reset_buf = term_contact | time_out_buf | term_gravity | term_height

        # rewards (legged_robot.py:274-291)
        with trace.span("dtc/env.step/rewards"):
            ctx = dict(
                dt=cfg.dt,
                base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
                projected_gravity=projected_gravity,
                dof_pos=dof_pos, dof_vel=dof_vel,
                last_dof_vel=state["last_dof_vel"],
                actions=state["actions"], last_actions=state["last_actions"],
                last_actions_2=state["last_actions_2"],
                torques=state["torques"],
                contact_forces=contact_forces,
                feet_idx=T["feet_idx"], penalised_idx=T["penalised_idx"],
                hip_dof_idx=T["hip_dof_idx"],
                feet_contact=feet_contact, last_contacts=last_contacts,
                contact_filt=contact_filt,
                feet_air_time=state["feet_air_time"],
                stumb_buffer=state["stumb_buffer"],
                commands=commands,
                cmd_buffer=cmd_buffer, lin_vel_buffer=lin_vel_buffer,
                ang_vel_buffer=ang_vel_buffer,
                lin_vel_x_max=state["command_lin_vel_x"][1],
                ang_vel_yaw_max=cfg.commands.ranges.ang_vel_yaw[1],
                tracking_sigma=cfg.rewards.tracking_sigma,
                # without an env dim, as the other tables: the reward kernel
                # stages an input with an env dim per env, and at one env a
                # (1, nq) table would take an env's row
                default_dof_pos=T["default_q"],
                soft_dof_pos_limits=(T["soft_lo"], T["soft_hi"]),
                dof_vel_limit=T["dof_vel_limits"],
                soft_dof_vel_limit=cfg.rewards.soft_dof_vel_limit,
                torque_limit=T["torque_limits"],
                soft_torque_limit=cfg.rewards.soft_torque_limit,
                max_contact_force=cfg.rewards.max_contact_force,
                max_acc=cfg.rewards.max_acc,
                base_height_target=cfg.rewards.base_height_target,
                robot_mass=params["robot_mass"],
                foot_positions=foot_positions, foot_velocities=foot_velocities,
                last_foot_velocities=state["last_foot_velocities"],
                measured_foot_clearance=measured_foot_clearance,
                measured_heights=measured_heights,
                plane_pinv=T["plane_pinv"],
                pitch_est=state["pitch_est"],
                terrain_levels=state["terrain_levels"],
                acc_points=T["acc_points"],
                optimal_footholds_world=optimal_footholds_world,
                root_z=base_pos[:, 2],
                env_origin_z=state["env_origins"][:, 2],
                reset_buf=reset_buf, time_out_buf=time_out_buf,
            )
            # in place: the (K, N) sums are the widest per-step accumulator
            episode_sums = state["episode_sums"]
            rew_buf, upd = cuda_rewards.compute_rewards_fused(
                self.reward_names, self.reward_scales_dt, ctx,
                cfg.rewards.only_positive_rewards, self.termination_scale_dt,
                self.episode_sum_names, episode_sums)

        mid_state = {**state,
                     "phys": phys,
                     "episode_length": episode_length,
                     "common_step": common_step,
                     "commands": commands,
                     "cmd_buffer": cmd_buffer,
                     "lin_vel_buffer": lin_vel_buffer,
                     "ang_vel_buffer": ang_vel_buffer,
                     "push_force": push_force,
                     "last_contacts": last_contacts,
                     "contact_filt": contact_filt,
                     "feet_air_time": upd.get("feet_air_time",
                                              state["feet_air_time"]),
                     "stumb_buffer": upd.get("stumb_buffer",
                                             state["stumb_buffer"]),
                     "pitch_est": upd.get("pitch_est", state["pitch_est"]),
                     "episode_sums": episode_sums,
                     "measured_heights": measured_heights,
                     "measured_foot_clearance": measured_foot_clearance,
                     "reset_buf": reset_buf,
                     "time_out_buf": time_out_buf,
                     "rew_buf": rew_buf,
                     "foothold_obs": foothold_obs,
                     "optimal_footholds_world": optimal_footholds_world,
                     "planes": (state["planes"] if planes_next is None
                                else planes_next)}
        with trace.span("dtc/env.step/reset"):
            metrics = self._reset_metrics(mid_state, reset_buf)
            # per-cause termination tally (causes overlap)
            metrics["term_contact"] = term_contact.float().sum()
            metrics["term_gravity"] = term_gravity.float().sum()
            metrics["term_height"] = term_height.float().sum()
            metrics["term_timeout"] = time_out_buf.float().sum()
            new_state = self._apply_reset(params, mid_state, reset_buf, gen)
            metrics["terrain_level"] = pmesh.mean(
                new_state["terrain_levels"].float(), self._sh)

        # observations (dtc.py:254-288)
        with trace.span("dtc/env.step/obs"):
            new_state, obs_out = self._compute_observations(
                new_state, base_pos[:, 2], base_lin_vel, base_ang_vel,
                projected_gravity, measured_heights, gen, draws)

        # post-step bookkeeping (dtc.py:215-223)
        new_state = {**new_state,
                     "last_actions_2": new_state["last_actions"],
                     "last_actions": new_state["actions"],
                     "last_dof_vel": new_state["phys"]["qd"].T,
                     "last_foot_velocities": foot_velocities}
        out = dict(obs=obs_out["obs"],
                   privileged_obs=obs_out["privileged_obs"],
                   obs_history=new_state["obs_history"],
                   base_vel=obs_out["base_vel"],
                   rew=rew_buf, done=reset_buf, time_out=time_out_buf,
                   metrics=metrics)
        if debug is not None:
            out["debug"] = debug
        return new_state, out

    # ------------------------------------------------------------------
    def _resample_commands_where(self, commands, mask, lin_vel_x_range, gen):
        """_resample_commands (legged_robot.py:567-593), masked."""
        cfg = self.cfg
        N = commands.shape[0]
        dev = self.device
        r = cfg.commands.ranges
        new_c = torch.zeros_like(commands)
        new_c[:, 0] = self._uni(gen, (N,), lin_vel_x_range[0],
                                lin_vel_x_range[1])
        new_c[:, 1] = self._uni(gen, (N,), *r.lin_vel_y)
        if cfg.commands.heading_command:
            new_c[:, 3] = self._uni(gen, (N,), *r.heading)
        else:
            new_c[:, 2] = self._uni(gen, (N,), *r.ang_vel_yaw)
        if cfg.env.play_command:                                   # :580-587
            new_c[:, 0] = 0.5
            new_c[:, 1] = 0.0
            new_c[:, 3 if cfg.commands.heading_command else 2] = 0.0
        small = torch.linalg.vector_norm(new_c[:, :2], dim=1) <= 0.1  # :591
        new_c[:, :2] *= torch.where(small, 0.0, 1.0)[:, None]
        return torch.where(mask[:, None], new_c, commands)

    def _clamp_descent_commands(self, commands, types, levels):
        """Planar commands capped at descent_clamp m/s on descent-family
        columns at terrain_level >= descent_clamp_level (CommandsCfg)."""
        c = self.cfg.commands
        if self._descent_cols is None:
            return commands
        on_descent = (self._descent_cols[types.long()]
                      & (levels >= c.descent_clamp_level))
        speed = torch.linalg.vector_norm(commands[:, :2], dim=1)
        scale = torch.where(on_descent & (speed > c.descent_clamp),
                            c.descent_clamp / torch.clamp(speed, min=1e-6), 1.0)
        return torch.cat([commands[:, :2] * scale[:, None], commands[:, 2:]],
                         dim=1)

    def _reset_metrics(self, state, done):
        """Episode logging at reset (legged_robot.py:252-261): per-term sums
        over done envs (the host divides by the count; a block's sums,
        sharded)."""
        out = {"n_done": done.float().sum()}
        sums = torch.where(done[None, :], state["episode_sums"], 0.0).sum(
            dim=1) / self.cfg.env.episode_length_s
        for i, n in enumerate(self.episode_sum_names):
            out["rew_" + n] = sums[i]
        return out

    # ------------------------------------------------------------------
    def _apply_reset(self, params, state, done, gen, draws=None):
        """Masked reset of `done` envs (reset_idx, legged_robot.py:200-272
        + dtc.py:291-315).  draws: optional injected draws, "reset_levels"
        (N,) int32 in [0, num_rows) and "reset_uniforms" (N, nq + 8) in
        [-1, 1): the joint scale, the xy offset and the root velocity."""
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        dev = self.device
        T = self._t
        d1 = done[:, None]

        # command curriculum (legged_robot.py:716-726), its counts over
        # every env of a sharded run
        cmd_range = state["command_lin_vel_x"]
        if (cfg.commands.curriculum
                and "tracking_lin_vel" in self.episode_sum_names):
            gate = (state["common_step"] % self.max_episode_length) == 0
            tl_row = self.episode_sum_names.index("tracking_lin_vel")
            counts = pmesh.all_sum(torch.stack([
                done.float().sum(),
                torch.where(done, state["episode_sums"][tl_row], 0.0).sum()]),
                self._sh)
            n_done = torch.clamp(counts[0], min=1.0)
            mean_track = counts[1] / n_done
            good = (mean_track / self.max_episode_length
                    > 0.8 * self.reward_scales_dt["tracking_lin_vel"])
            mc = cfg.commands.max_curriculum
            widened = torch.stack([torch.clamp(cmd_range[0] - 0.5, -mc, 0.0),
                                   torch.clamp(cmd_range[1] + 0.5, 0.0, mc)])
            cmd_range = torch.where(gate & good & (counts[0] > 0), widened,
                                    cmd_range)

        # terrain curriculum (legged_robot.py:690-714)
        levels = state["terrain_levels"]
        env_origins = state["env_origins"]
        if self.terrain is not None and cfg.terrain.curriculum:
            base_xy = state["phys"]["pos"].T[:, :2]
            distance = torch.linalg.vector_norm(base_xy - env_origins[:, :2],
                                                dim=1)
            move_up = distance > cfg.terrain.terrain_length * 0.6
            cmd_dist = (torch.linalg.vector_norm(state["commands"][:, :2], dim=1)
                        * cfg.env.episode_length_s * 0.5)
            move_down = (distance < cmd_dist) & ~move_up
            new_levels = levels + move_up.int() - move_down.int()
            max_level = cfg.terrain.num_rows
            rand_levels = self._draw(
                draws, "reset_levels", lambda: self._rows(
                    lambda sh: torch.randint(0, max_level, sh, generator=gen,
                                             device=dev, dtype=torch.int32),
                    N))
            new_levels = torch.where(new_levels >= max_level, rand_levels,
                                     torch.clamp(new_levels, min=0))
            levels = torch.where(done, new_levels, levels).to(torch.int32)
            env_origins = torch.where(
                d1, params["terrain_origins"][levels.long(),
                                              state["terrain_types"].long()],
                env_origins)

        # the reset's uniforms in one draw: the joint scale, the xy offset
        # and the root velocity
        u = self._draw(draws, "reset_uniforms", lambda: cuda_rng.uniform_pm1(
            cuda_rng.draw_seed(gen, dev), (N, m.nq + 8),
            **self._offset("offset", m.nq + 8)))

        # DOF reset: default * U(0.5, 1.5), qd = 0 (legged_robot.py:632-641)
        lo, hi = cfg.domain_rand.init_joint_range
        q_new = T["default_q"][None, :] * ((u[:, :m.nq] + 1.0) * (0.5 * (hi - lo))
                                           + lo)
        phys = state["phys"]

        def masked(new, old_t):           # env-last old, env-leading new
            return torch.where(d1, new, old_t.T).T.contiguous()
        q = masked(q_new, phys["q"])
        qd = masked(torch.zeros_like(q_new), phys["qd"])

        # root reset (dtc.py:291-315): origin + U(-0.5,0.5) xy (U(-1,1)
        # without the planner; none on a plane), vel U(-0.5,0.5)
        xy_off = 0.5 if cfg.use_dtc_planner else 1.0
        pos_new = env_origins + T["init_pos"][None, :]
        if self.terrain is not None:
            pos_new = torch.cat([pos_new[:, :2] + u[:, m.nq:m.nq + 2] * xy_off,
                                 pos_new[:, 2:]], dim=1)
        pos = masked(pos_new, phys["pos"])
        quat = masked(T["init_rot"].expand(N, 4), phys["quat"])
        vel6 = u[:, m.nq + 2:] * 0.5
        lin_vel = masked(vel6[:, :3], phys["lin_vel"])
        ang_vel = masked(vel6[:, 3:], phys["ang_vel"])
        phys = dict(pos=pos, quat=quat, lin_vel=lin_vel, ang_vel=ang_vel,
                    q=q, qd=qd)

        # commands for reset envs (legged_robot.py:225), clamped against the
        # post-curriculum levels the env respawns at
        commands = self._resample_commands_where(state["commands"], done,
                                                 cmd_range, gen)
        commands = self._clamp_descent_commands(commands,
                                                state["terrain_types"], levels)

        # per-episode actuator DR (legged_robot.py:465-481): one scalar/env
        dr = cfg.domain_rand

        def dr_field(old, rng, enabled):
            if not enabled:
                return old
            new = self._uni(gen, (N, 1), rng[0], rng[1]).expand_as(old)
            return torch.where(d1, new, old)
        motor_strengths = dr_field(state["motor_strengths"], dr.motor_strength,
                                   dr.randomize_motor_strength)
        kp_factors = dr_field(state["kp_factors"], dr.kp_range,
                              dr.randomize_kp_factor)
        kd_factors = dr_field(state["kd_factors"], dr.kd_range,
                              dr.randomize_kd_factor)

        # height-scan episode offset ~ N(0, 0.02) (legged_robot.py:229-230)
        hno = torch.where(done, 0.02 * self._rows(
            lambda sh: torch.randn(sh, generator=gen, device=dev), N),
                          state["height_noise_offset"])

        # anchors snap to the reset base; body planes go contact-free so a
        # stale plane cannot push the respawned body for its first step
        dn = done[None, None, :]
        anchors = torch.where(dn, torch.stack([pos[0], pos[1]])[None],
                              state["anchors"])
        body_pts = torch.where(dn, pos[None], state["body_pts"])
        safe_plane = torch.stack([torch.full((N,), -1e4, device=dev),
                                  torch.zeros(N, device=dev),
                                  torch.zeros(N, device=dev), pos[0], pos[1]])
        planes = torch.where(dn, safe_plane[None], state["planes"])

        def zero_where(x, mask):
            return torch.where(mask, torch.zeros((), dtype=x.dtype, device=dev), x)
        d3 = done[:, None, None]
        return {**state,
                "command_lin_vel_x": cmd_range,
                "phys": phys,
                "anchors": anchors,
                "body_pts": body_pts,
                "planes": planes,
                "terrain_levels": levels,
                "env_origins": env_origins,
                "commands": commands,
                "motor_strengths": motor_strengths,
                "kp_factors": kp_factors,
                "kd_factors": kd_factors,
                "height_noise_offset": hno,
                "last_actions": zero_where(state["last_actions"], d1),
                "last_actions_2": zero_where(state["last_actions_2"], d1),
                "last_dof_vel": zero_where(state["last_dof_vel"], d1),
                "feet_air_time": zero_where(state["feet_air_time"], d1),
                "episode_length": zero_where(state["episode_length"], done),
                "pitch_est": zero_where(state["pitch_est"], done),
                "last_contacts": zero_where(state["last_contacts"], d1),
                "contact_filt": zero_where(state["contact_filt"], d1),
                "stumb_buffer": zero_where(state["stumb_buffer"], d3),
                "lag_buffer": zero_where(state["lag_buffer"], d3),
                "lin_vel_buffer": zero_where(state["lin_vel_buffer"], d3),
                "ang_vel_buffer": zero_where(state["ang_vel_buffer"], d3),
                "cmd_buffer": zero_where(state["cmd_buffer"], d3),
                "episode_sums": zero_where(state["episode_sums"], done[None, :]),
                }

    # ------------------------------------------------------------------
    def _compute_observations(self, state, base_z, base_lin_vel,
                              base_ang_vel, projected_gravity,
                              measured_heights, gen, draws):
        """Obs assembly (dtc.py:254-288), in env/cuda_obs.py.  As in the
        reference, observations are computed after the reset from the
        pre-reset derived quantities plus the post-reset dof state
        (legged_robot.py:163)."""
        T = self._t
        seed = self._draw(draws, "noise_seed", lambda: cuda_rng.draw_seed(
            gen, self.device))
        draws = draws or {}
        obs, privileged, obs_history = cuda_obs.compute_observations_fused(
            self.cfg, self._obs_has_foothold, base_ang_vel, projected_gravity,
            state["commands"], state["phys"]["q"], state["phys"]["qd"],
            state["actions"], state["foothold_obs"], base_z, measured_heights,
            state["push_force"], state["height_noise_offset"],
            state["obs_history"], T["noise_scale_vec"], T["default_q"],
            T["commands_scale"], seed, height_noise=draws.get("height_noise"),
            obs_noise=draws.get("obs_noise"), **self._offset("row0"))
        # get_base_vel
        base_vel = base_lin_vel * self.cfg.normalization.obs_scales.lin_vel
        new_state = {**state, "obs": obs, "privileged_obs": privileged,
                     "obs_history": obs_history, "base_vel": base_vel}
        return new_state, dict(obs=obs, privileged_obs=privileged,
                               base_vel=base_vel)
