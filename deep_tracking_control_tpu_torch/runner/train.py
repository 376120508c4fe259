"""OnPolicyRunner — rollout collection, the PPO update, the training loop
and checkpoints.

Counterpart of the JAX package's runner/train.py (rsl_rl
on_policy_runner.py:45-274) for its three policy classes, picked by
`PolicyCfg.policy_class_name`: ActorCriticDecoder (the DTC teacher, PPO
with the VAE step), ActorCritic (PPO's MLP path) and
ActorCriticRecurrent (GRU or LSTM, `PolicyCfg.rnn_type`; the carries live
in the log state, are reset at dones and are not checkpointed).  Each
iteration of `learn` runs `collect` (24 x PPO.act or act_recurrent ->
LeggedEnv.step with the timeout bootstrap, bf16 storage of the privileged
obs and the obs history, episode bookkeeping, the last values and GAE),
then `PPO.update` or `update_recurrent`, in one plain loop on the env's
device; the stats leave the device once per iteration as one packed
tensor.  The JAX runner's iters_per_dispatch,
perf_split and asynchronous saves were host tricks of a remote TPU and
have no counterpart: the collection and learning seconds are measured
every iteration (synchronized) and logged under the reference's names,
beside the tracer's host time per span, syncs and kernel launches
(utils/trace.py) that each iteration's row carries.

An env built with a `shard` (parallel/mesh.py EnvShard, from
parallel/distributed.py `global_shard`) makes the runner one rank of a
data-parallel run over torch.distributed, the counterpart of the JAX
runner's `mesh=`: the env steps the rank's block of envs, the net is
drawn from the seed on every rank, the generator keeps the same seed and
stays in lockstep (every draw is made at its global shape), the update
is PPO's sharded one, and the rollout's sums are added up over the ranks
once an iteration.  Only rank 0 logs and writes checkpoints, which hold
the global state, so a checkpoint loads at any world size.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..agent.ppo import PPO
from ..agent.trajectories import tree_map
from ..env.config import TrainCfg
from ..env.legged_env import LeggedEnv
from ..models.networks import (ActorCritic, ActorCriticDecoder,
                               ActorCriticRecurrent)
from ..parallel import distributed as pdist
from ..parallel import mesh as pmesh
from ..utils import flags, trace
from . import checkpoint as ckpt

LOG_INTERVAL = 10        # iterations between log lines (the reference's default)


def _same_layout(a, b) -> bool:
    """Same keys, and tensors of the same shape and dtype, all the way down."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and set(a) == set(b)
                and all(_same_layout(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype
    return type(a) is type(b)


class OnPolicyRunner:
    def __init__(self, env: LeggedEnv, train_cfg: TrainCfg,
                 log_dir: Optional[str] = None, writer=None):
        # a sharded env's EnvShard (parallel/mesh.py), else None
        self.shard = shard = env.shard
        pol = train_cfg.policy
        if flags.strict_parity():
            # the reference's update: sequential VAE-then-policy steps and
            # a per-row permutation (runner/train.py:34-44 of the JAX
            # package); the bf16 storage is switched off in collect()
            train_cfg = dataclasses.replace(
                train_cfg, algorithm=dataclasses.replace(
                    train_cfg.algorithm, fused_joint_step=False,
                    minibatch_perm_granule=1, shuffle_strata=1))
        self.env = env
        self.cfg = train_cfg
        self.device = env.device
        self.log_dir = log_dir
        self.writer = writer
        self.current_learning_iteration = 0
        self.tot_timesteps = 0
        seed = train_cfg.runner.seed
        # weights are drawn on the CPU, so a seed gives the same net on
        # every device; the rollout and the update draw from a generator on
        # the device
        init_gen = torch.Generator().manual_seed(seed)
        heads = dict(actor_hidden=tuple(pol.actor_hidden_dims),
                     critic_hidden=tuple(pol.critic_hidden_dims),
                     activation=pol.activation,
                     init_noise_std=pol.init_noise_std, generator=init_gen)
        if pol.policy_class_name == "ActorCriticDecoder":
            net = ActorCriticDecoder(
                num_obs=env.num_obs,
                num_privileged_obs=env.num_privileged_obs,
                num_actions=env.num_actions,
                obs_history_dim=env.num_obs_history,
                terrain_dim=env.num_height_points,
                terrain_latent=pol.terrain_latent, z_dim=pol.cenet_latent,
                outlier_filter=pol.outlier_filter, shard=shard, **heads)
            kind = "decoder"
        elif pol.policy_class_name == "ActorCritic":
            net = ActorCritic(num_obs=env.num_obs, num_critic_obs=env.num_obs,
                              num_actions=env.num_actions, **heads)
            kind = "mlp"
        elif pol.policy_class_name == "ActorCriticRecurrent":
            net = ActorCriticRecurrent(
                num_obs=env.num_obs, num_critic_obs=env.num_obs,
                num_actions=env.num_actions,
                rnn_hidden_size=pol.rnn_hidden_size, rnn_type=pol.rnn_type,
                **heads)
            kind = "recurrent"
        else:
            raise ValueError(
                f"unsupported policy_class_name {pol.policy_class_name!r}")
        self.net = net.to(self.device)
        self.ppo = PPO(net=self.net, alg=train_cfg.algorithm,
                       policy_kind=kind, shard=shard)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.env_params, self.env_state = env.init(self.generator)
        N = env.num_envs
        self.log_state = dict(
            cur_reward_sum=torch.zeros(N, device=self.device),
            cur_episode_length=torch.zeros(N, device=self.device))
        self._fresh_carries()
        # episode stats (on_policy_runner.py:103-106)
        self.rewbuffer = deque(maxlen=100)
        self.lenbuffer = deque(maxlen=100)

    @property
    def recurrent(self) -> bool:
        return self.ppo.policy_kind == "recurrent"

    def init_carry(self, num_envs: int):
        """A fresh carry of the recurrent policy on the runner's device:
        zeros (N, H) for a GRU, (c, h) zeros for an LSTM (both memories
        share the layout)."""
        return self.net.memory_a.initialize_carry(num_envs, self.device)

    def _fresh_carries(self):
        """Zero carries of the recurrent policy in the log state (a new or
        just loaded runner); no-op for the other policies."""
        if self.recurrent:
            N = self.env.num_envs
            self.log_state.update(carry_a=self.init_carry(N),
                                  carry_c=self.init_carry(N))

    @trace.spanned("dtc/collect")
    @torch.no_grad()
    def collect(self):
        """One rollout of num_steps_per_env steps + GAE.

        Returns (batch, aux): batch holds (T, N, ...) tensors obs,
        privileged_obs, obs_history, base_vel, actions, values,
        old_log_prob, old_mu, old_sigma, next_obs, returns, advantages; for
        the recurrent policy obs, the PPO fields and dones (T, N), with the
        rollout-start carries init_carry_a/init_carry_c (N, H) and no
        privileged obs or history (runner/train.py:254-264 of the JAX
        package).  aux holds the summed step metrics ("metric_*") and the
        episode sums ep_rew_sum / ep_len_sum / ep_count.  Advances the
        runner's env and log state (and the carries, zeroed at dones)."""
        env, ppo, gen = self.env, self.ppo, self.generator
        T = self.cfg.runner.num_steps_per_env
        gamma = self.cfg.algorithm.gamma
        recurrent = self.recurrent
        # priv/hist are consumed only as network inputs (cast to bf16 at
        # the first layer) and as the VAE height target; DTC_STRICT_PARITY
        # restores the reference's float32 storage
        store_dt = torch.float32 if flags.strict_parity() else torch.bfloat16
        params, state, log = self.env_params, self.env_state, self.log_state
        if recurrent:
            init_a, init_c = log["carry_a"], log["carry_c"]

        def held(st):
            """Copies of what the batch keeps of a step's state (obs; priv,
            hist and base velocity): inside `graphed_steps` the next step
            overwrites the tensors a step returned."""
            if recurrent:
                return st["obs"].clone(), {}
            return st["obs"].clone(), dict(
                privileged_obs=st["privileged_obs"].to(store_dt, copy=True),
                obs_history=st["obs_history"].to(store_dt, copy=True),
                base_vel=st["base_vel"].clone())
        steps = []
        metrics = {}
        ep = dict(ep_rew_sum=0.0, ep_len_sum=0.0, ep_count=0.0)
        obs, kept = held(state)
        with env.graphed_steps():
            for _ in range(T):
                if recurrent:
                    a, ca, cc = ppo.act_recurrent(state["obs"], log["carry_a"],
                                                  log["carry_c"], gen)
                else:
                    a = ppo.act(state["obs"], state["obs_history"],
                                state["privileged_obs"], state["base_vel"],
                                gen)
                state, out = env.step(params, state, a["actions"], gen)
                with trace.span("dtc/collect/loop"):
                    # timeout bootstrap (ppo.py:160-163)
                    rew = out["rew"] + gamma * a["values"] * out["time_out"]
                    step = dict(obs=obs, actions=a["actions"],
                                values=a["values"],
                                old_log_prob=a["log_prob"], old_mu=a["mu"],
                                old_sigma=a["sigma"], rewards=rew,
                                dones=out["done"].clone(), **kept)
                    obs, kept = held(state)
                    if not recurrent:
                        step["next_obs"] = obs
                    steps.append(step)
                    # episode bookkeeping (on_policy_runner.py:130-140)
                    crs = log["cur_reward_sum"] + out["rew"]
                    cel = log["cur_episode_length"] + 1.0
                    done_f = out["done"].float()
                    ep["ep_rew_sum"] = ep["ep_rew_sum"] + (crs * done_f).sum()
                    ep["ep_len_sum"] = ep["ep_len_sum"] + (cel * done_f).sum()
                    ep["ep_count"] = ep["ep_count"] + done_f.sum()
                    log = dict(cur_reward_sum=crs * (1.0 - done_f),
                               cur_episode_length=cel * (1.0 - done_f))
                    if recurrent:
                        # the carries restart after a done (ppo.py:170)
                        reset = out["done"][:, None]
                        log["carry_a"], log["carry_c"] = (
                            tree_map(lambda c: torch.where(reset, 0.0, c), x)
                            for x in (ca, cc))
                    for k, v in out["metrics"].items():
                        metrics[k] = (metrics[k] + v if k in metrics
                                      else v.clone())

        with trace.span("dtc/collect/gae"):
            batch = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
            if recurrent:
                last_values = self.net(state["obs"], state["obs"],
                                       log["carry_a"], log["carry_c"])[2]
            else:
                last_values = ppo.value(state["obs"], state["privileged_obs"],
                                        state["base_vel"])
            dones = batch.pop("dones")
            batch["returns"], batch["advantages"] = ppo.compute_gae(
                batch.pop("rewards"), dones, batch["values"], last_values)
            if recurrent:
                batch.update(dones=dones, init_carry_a=init_a,
                             init_carry_c=init_c)
        self.env_state, self.log_state = state, log
        aux = {**{"metric_" + k: v for k, v in metrics.items()}, **ep}
        return batch, aux

    # ------------------------------------------------------------------
    def _clock(self) -> float:
        """Host seconds after the device has finished the queued work."""
        if self.device.type == "cuda":
            with trace.sync("dtc/sync/clock", explicit=True):
                torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def learn(self, num_learning_iterations: int,
              init_at_random_ep_len: bool = False):
        """Training loop (OnPolicyRunner.learn, on_policy_runner.py:86-163).

        Returns one dict per iteration: the update's stats, the rollout's
        metric and episode sums, mean_noise_std, and the synchronized
        seconds of the two phases, collection_time and learning_time;
        while tracing is on (utils/trace.py), under "trace" the
        iteration's spans, syncs and kernel launches.  With a log_dir,
        every LOG_INTERVAL-th iteration is logged."""
        save_interval = self.cfg.runner.save_interval
        T = self.cfg.runner.num_steps_per_env
        N = self.env.num_envs
        n_all = N if self.shard is None else self.shard.num_envs
        start = self.current_learning_iteration
        if init_at_random_ep_len and start == 0:
            # desynchronize the resets from iteration 0
            # (on_policy_runner.py:105-109)
            self.env_state["episode_length"] = pmesh.rows(torch.randint(
                0, self.env.max_episode_length, (n_all,),
                generator=self.generator, device=self.device,
                dtype=torch.int32), self.shard)
        rows = []
        for it in range(start, start + num_learning_iterations):
            trace.begin(it)
            with trace.span("dtc/learn"):
                t0 = self._clock()
                batch, aux = self.collect()
                t1 = self._clock()
                update = (self.ppo.update_recurrent if self.recurrent
                          else self.ppo.update)
                stats = update(batch, self.generator)
                if pmesh.spans(self.shard):
                    # the rollout's sums over every rank's envs, in one
                    # all_reduce (the update's stats are global already)
                    names = sorted(aux)
                    total = pmesh.all_sum(torch.stack([
                        torch.as_tensor(aux[n], device=self.device).float()
                        .reshape(()) for n in names]), self.shard)
                    aux = dict(zip(names, total.unbind()))
                stats = {**stats, **aux, "mean_noise_std": self.net.std.mean()}
                names = sorted(stats)
                # one device -> host transfer of every scalar of the
                # iteration
                with trace.span("dtc/learn/stats"):
                    vec = torch.stack([
                        torch.as_tensor(stats[n], device=self.device)
                        .float().reshape(()) for n in names])
                    with trace.sync("dtc/sync/stats"):
                        vec = vec.cpu()
                t2 = time.perf_counter()
            row = dict(zip(names, vec.tolist()),
                       collection_time=t1 - t0, learning_time=t2 - t1)
            tr = trace.end()
            if tr is not None:
                row["trace"] = tr
            rows.append(row)
            self.tot_timesteps += T * n_all
            if row["ep_count"] > 0:
                self.rewbuffer.append(row["ep_rew_sum"] / row["ep_count"])
                self.lenbuffer.append(row["ep_len_sum"] / row["ep_count"])
            if self._logs and it % LOG_INTERVAL == 0:
                self._log(it, row, t2 - t0)
            if self.log_dir is not None and it % save_interval == 0:
                # periodic saves are light: the reference's save scope
                self.save(os.path.join(self.log_dir, f"model_{it}.pt"),
                          full=False)
            self.current_learning_iteration = it + 1
        if self.log_dir is not None:
            self.save(os.path.join(
                self.log_dir, f"model_{self.current_learning_iteration}.pt"))
        return rows

    # ------------------------------------------------------------------
    @property
    def _logs(self) -> bool:
        """A log_dir and rank 0 (the only rank that logs)."""
        return self.log_dir is not None and (self.shard is None
                                             or self.shard.rank == 0)

    def _log(self, it, stats, dt_iter):
        """TensorBoard scalars matching on_policy_runner.py:187-203, and
        the tracer's: Perf/host_ms/<span> (host ms in each span of the
        iteration), Perf/syncs (its blocking syncs, explicit ones
        included), Perf/launches/<kernel> and
        Perf/graphs/<graph>/{captures, replays, eager}."""
        n_all = (self.env.num_envs if self.shard is None
                 else self.shard.num_envs)
        fps = int(self.cfg.runner.num_steps_per_env * n_all
                  / max(dt_iter, 1e-9))
        scalars = {
            "Loss/value_function": stats["value_loss"],
            "Loss/surrogate": stats["surrogate_loss"],
            "Loss/Reconstruction": stats["recons_loss"],
            "Loss/Vel_estimation": stats["vel_loss"],
            "Loss/KL_div": stats["kld_loss"],
            "Loss/height": stats["height_loss"],
            "Loss/learning_rate": stats["lr"],
            "Policy/mean_noise_std": stats["mean_noise_std"],
            "Perf/total_fps": fps,
            "Perf/iter_time": dt_iter,
            # exact reference scalar names (on_policy_runner.py:196-197)
            "Perf/collection time": stats["collection_time"],
            "Perf/learning_time": stats["learning_time"],
        }
        n_done = max(float(stats.get("metric_n_done", 0.0)), 1.0)
        for k, v in stats.items():
            if k.startswith("metric_rew_") or k.startswith("metric_term_"):
                # per-term episode reward and per-cause termination rate
                scalars["Episode/" + k[7:]] = float(v) / n_done
        if "metric_terrain_level" in stats:
            # iteration mean of the per-step fleet-wide mean terrain level
            scalars["Episode/terrain_level"] = (
                float(stats["metric_terrain_level"])
                / self.cfg.runner.num_steps_per_env)
        tr = stats.get("trace")
        if tr is not None:
            # the iteration's spans, blocking syncs and kernel launches
            # (utils/trace.py)
            for name, agg in tr["spans"].items():
                scalars["Perf/host_ms/" + name] = 1e3 * agg["host_s"]
            scalars["Perf/syncs"] = tr["syncs"] + tr["explicit_syncs"]
            for k, n in tr["launches"].items():
                if n:
                    scalars["Perf/launches/" + k] = n
            for name, calls in tr["graphs"].items():
                for kind, n in calls.items():
                    scalars[f"Perf/graphs/{name}/{kind}"] = n
        if len(self.rewbuffer) > 0:
            scalars["Train/mean_reward"] = float(np.mean(self.rewbuffer))
            scalars["Train/mean_episode_length"] = float(
                np.mean(self.lenbuffer))
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, it)
        print(f"it {it:6d} | fps {fps:9d} | "
              f"rew {scalars.get('Train/mean_reward', float('nan')):8.3f} | "
              f"len {scalars.get('Train/mean_episode_length', float('nan')):7.1f}"
              f" | vloss {scalars['Loss/value_function']:8.4f} | "
              f"surr {scalars['Loss/surrogate']:8.4f} | "
              f"lr {scalars['Loss/learning_rate']:.1e}", flush=True)

    # ------------------------------------------------------------------
    def save(self, path: str, full: bool = True):
        """Checkpoint (on_policy_runner.py:249-255): params, both optimizer
        states, the learning rate, the iteration and the generator state;
        with full=True (the default) also the env state, the per-env
        params (the terrain tables are rebuilt from the seed, not saved)
        and the episode bookkeeping (not the recurrent carries, as in the
        JAX package).  Sharded, every rank calls it (the env state is
        gathered into its global layout) and rank 0 writes."""
        tree = dict(
            params=self.net.state_dict(),
            opt_state=self.ppo.optimizer.state_dict(),
            vae_opt_state=self.ppo.vae_optimizer.state_dict(),
            learning_rate=self.ppo.learning_rate,
            iter=self.current_learning_iteration,
            generator=self.generator.get_state(),
            generator_device=self.device.type)
        if full:
            tree.update(pmesh.gather_tree(dict(
                env_state=self.env_state,
                env_params={k: v for k, v in self.env_params.items()
                            if k != "terrain"},
                log_state=self._episode_log()), self.shard))
        if pdist.is_main():
            ckpt.save(path, tree)
        pdist.barrier()

    def _episode_log(self) -> dict:
        """The log state without the carries: the episode bookkeeping."""
        return {k: v for k, v in self.log_state.items()
                if not k.startswith("carry_")}

    def load(self, path: str, load_optimizer: bool = True):
        """Restore a checkpoint: params, the iteration and the generator,
        and with load_optimizer (the default) both optimizers and the
        learning rate; without it (evaluation, runner/train.py:607-682 of
        the JAX package) both stay this runner's own.  The env state is
        adopted only when its stored shapes match this runner's
        (runner/train.py:650-681 of the JAX package); otherwise it stays
        fresh, like the reference's torch.load path
        (on_policy_runner.py:257-264).  So a checkpoint of another env
        count, or of another task whose episode-sum rows differ (the
        staged x30_rough -> x30_dtc protocol), hands over the policy (and
        its optimizers) and leaves the env fresh.  The recurrent carries
        start from zeros after any load.  Sharded, every rank reads the
        file and keeps its block of the env state."""
        d = ckpt.load(path, self.device)
        if (self.shard is not None and "env_state" in d
                and d["env_state"]["commands"].shape[0]
                == self.shard.num_envs):
            for k in ("env_state", "env_params", "log_state"):
                if k in d:
                    d[k] = pmesh.shard_tree(d[k], self.shard)
        self._fresh_carries()
        self.net.load_state_dict(d["params"])
        if load_optimizer:
            self.ppo.optimizer.load_state_dict(d["opt_state"])
            self.ppo.vae_optimizer.load_state_dict(d["vae_opt_state"])
            self.ppo.learning_rate = d["learning_rate"].to(
                self.device, torch.float32).reshape(())
        self.current_learning_iteration = int(d["iter"])
        if d.get("generator_device") == self.device.type:
            self.generator.set_state(d["generator"].cpu())
        else:
            print(f"checkpoint generator of {d.get('generator_device')}: "
                  f"keeping this runner's {self.device.type} generator")
        if "env_state" not in d:
            print("light checkpoint (no env state): keeping fresh env state")
            return
        params = {k: v for k, v in self.env_params.items() if k != "terrain"}
        if (_same_layout(d["env_state"], self.env_state)
                and _same_layout(d["env_params"], params)):
            self.env_state = d["env_state"]
            self.env_params = {**d["env_params"],
                               "terrain": self.env_params["terrain"]}
            if _same_layout(d.get("log_state"), self._episode_log()):
                self.log_state.update(d["log_state"])
        else:
            ours = {**self.env_state, **params}
            differ = sorted(k for k, v in {**d["env_state"],
                                           **d["env_params"]}.items()
                            if not _same_layout(v, ours.get(k)))
            shown = ", ".join(differ[:3]) + (", ..." if len(differ) > 3
                                             else "")
            print(f"checkpoint env state ({len(differ)} fields of another "
                  f"layout: {shown}) does not match this runner's: keeping "
                  "fresh env state")

    # ------------------------------------------------------------------
    def get_inference_policy(self, teacher: bool = True):
        """act_expert analog (on_policy_runner.py:266-273): a deterministic
        policy.  The decoder's is (obs, obs_history, privileged_obs) ->
        actions, through the teacher's belief path or, with teacher=False,
        the training input layout (act_deterministic); the MLP's has the
        same signature and reads the obs alone; the recurrent one threads
        its carries, (obs, (carry_a, carry_c)) -> (actions, (carry_a,
        carry_c)), from (init_carry(N), init_carry(N))."""
        net = self.net
        if self.ppo.policy_kind == "mlp":
            @torch.no_grad()
            def policy(obs, obs_history, privileged_obs):
                return net(obs, obs)[0]
            return policy
        if self.recurrent:
            @torch.no_grad()
            def policy(obs, carry):
                mean, _, _, ca, cc = net(obs, obs, *carry)
                return mean, (ca, cc)
            return policy
        method = net.act_teacher if teacher else net.act_deterministic

        @torch.no_grad()
        def policy(obs, obs_history, privileged_obs):
            return method(obs, obs_history, privileged_obs)

        return policy
