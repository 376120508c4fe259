"""OnPolicyRunner — the rollout collection phase.

Counterpart of the collection half of the JAX package's runner/train.py
(`collect`, train.py:175-272; rsl_rl on_policy_runner.py:112-146): 24 x
(PPO.act -> LeggedEnv.step) with the timeout bootstrap, bf16 storage of
the privileged obs and the obs history, episode bookkeeping, the last
values and GAE.  `learn`, the update and checkpoints are not ported yet.
"""
from __future__ import annotations

import torch

from ..agent.ppo import PPO
from ..env.config import TrainCfg
from ..env.legged_env import LeggedEnv
from ..models.networks import ActorCriticDecoder
from ..utils import flags


class OnPolicyRunner:
    def __init__(self, env: LeggedEnv, train_cfg: TrainCfg):
        pol = train_cfg.policy
        if pol.policy_class_name != "ActorCriticDecoder":
            raise NotImplementedError(
                f"{pol.policy_class_name} is not ported yet")
        self.env = env
        self.cfg = train_cfg
        self.device = env.device
        seed = train_cfg.runner.seed
        # weights are drawn on the CPU, so a seed gives the same net on
        # every device; the rollout draws from a generator on the device
        init_gen = torch.Generator().manual_seed(seed)
        self.net = ActorCriticDecoder(
            num_obs=env.num_obs, num_privileged_obs=env.num_privileged_obs,
            num_actions=env.num_actions, obs_history_dim=env.num_obs_history,
            terrain_dim=env.num_height_points,
            terrain_latent=pol.terrain_latent, z_dim=pol.cenet_latent,
            actor_hidden=tuple(pol.actor_hidden_dims),
            critic_hidden=tuple(pol.critic_hidden_dims),
            activation=pol.activation, init_noise_std=pol.init_noise_std,
            generator=init_gen).to(self.device)
        self.ppo = PPO(net=self.net, alg=train_cfg.algorithm)
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.env_params, self.env_state = env.init(self.generator)
        N = env.num_envs
        self.log_state = dict(
            cur_reward_sum=torch.zeros(N, device=self.device),
            cur_episode_length=torch.zeros(N, device=self.device))

    @torch.no_grad()
    def collect(self):
        """One rollout of num_steps_per_env steps + GAE.

        Returns (batch, aux): batch holds (T, N, ...) tensors obs,
        privileged_obs, obs_history, base_vel, actions, values,
        old_log_prob, old_mu, old_sigma, next_obs, returns, advantages;
        aux holds the summed step metrics ("metric_*") and the episode
        sums ep_rew_sum / ep_len_sum / ep_count.  Advances the runner's
        env and log state."""
        env, ppo, gen = self.env, self.ppo, self.generator
        T = self.cfg.runner.num_steps_per_env
        gamma = self.cfg.algorithm.gamma
        # priv/hist are consumed only as network inputs (cast to bf16 at
        # the first layer) and as the VAE height target; DTC_STRICT_PARITY
        # restores the reference's float32 storage
        store_dt = torch.float32 if flags.strict_parity() else torch.bfloat16
        params, state, log = self.env_params, self.env_state, self.log_state
        steps = []
        metrics = {}
        ep = dict(ep_rew_sum=0.0, ep_len_sum=0.0, ep_count=0.0)
        for _ in range(T):
            obs, priv = state["obs"], state["privileged_obs"]
            hist, base_vel = state["obs_history"], state["base_vel"]
            a = ppo.act(obs, hist, priv, base_vel, gen)
            state, out = env.step(params, state, a["actions"], gen)
            # timeout bootstrap (ppo.py:160-163)
            rew = out["rew"] + gamma * a["values"] * out["time_out"]
            steps.append(dict(obs=obs, privileged_obs=priv.to(store_dt),
                              obs_history=hist.to(store_dt),
                              base_vel=base_vel, actions=a["actions"],
                              values=a["values"], old_log_prob=a["log_prob"],
                              old_mu=a["mu"], old_sigma=a["sigma"],
                              next_obs=out["obs"], rewards=rew,
                              dones=out["done"]))
            # episode bookkeeping (on_policy_runner.py:130-140)
            crs = log["cur_reward_sum"] + out["rew"]
            cel = log["cur_episode_length"] + 1.0
            done_f = out["done"].float()
            ep["ep_rew_sum"] = ep["ep_rew_sum"] + (crs * done_f).sum()
            ep["ep_len_sum"] = ep["ep_len_sum"] + (cel * done_f).sum()
            ep["ep_count"] = ep["ep_count"] + done_f.sum()
            log = dict(cur_reward_sum=crs * (1.0 - done_f),
                       cur_episode_length=cel * (1.0 - done_f))
            for k, v in out["metrics"].items():
                metrics[k] = metrics[k] + v if k in metrics else v

        batch = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
        last_values = ppo.value(state["obs"], state["privileged_obs"],
                                state["base_vel"])
        batch["returns"], batch["advantages"] = ppo.compute_gae(
            batch.pop("rewards"), batch.pop("dones"), batch["values"],
            last_values)
        self.env_state, self.log_state = state, log
        aux = {**{"metric_" + k: v for k, v in metrics.items()}, **ep}
        return batch, aux
