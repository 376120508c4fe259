"""PPO acting and GAE on torch tensors.

Counterpart of the collection half of the JAX package's agent/ppo.py
(rsl_rl ppo.py:137-155 act, rollout_storage.py:138-152 compute_returns).
The update (the joint VAE + policy minibatch step) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..env.config import AlgorithmCfg


def normal_log_prob(mean, std, x):
    """Sum of independent Normal log-probs over the action axis."""
    var = std * std
    lp = (-0.5 * torch.square(x - mean) / var - torch.log(std)
          - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(lp, dim=-1)


@dataclasses.dataclass
class PPO:
    """PPO over an ActorCriticDecoder (the reference's teacher path)."""
    net: Any
    alg: AlgorithmCfg

    def value(self, obs, privileged_obs, base_vel):
        return self.net.evaluate(obs, privileged_obs, base_vel)

    @torch.no_grad()
    def act(self, obs, obs_history, privileged_obs, base_vel,
            generator: torch.Generator, eps_z=None, eps_a=None):
        """Sample actions + stats (PPO.act, ppo.py:137-155).  eps_z
        (N, z_dim) and eps_a (N, num_actions) are the standard normal draws
        of the latent and the action; drawn from `generator` when None."""
        N = obs.shape[0]
        if eps_z is None:
            eps_z = torch.randn((N, self.net.z_dim), generator=generator,
                                device=obs.device)
        mean, std, _, _ = self.net.act_stats(obs, obs_history, privileged_obs,
                                             eps_z)
        if eps_a is None:
            eps_a = torch.randn(mean.shape, generator=generator,
                                device=obs.device)
        actions = mean + std * eps_a
        return dict(actions=actions,
                    log_prob=normal_log_prob(mean, std, actions),
                    values=self.value(obs, privileged_obs, base_vel),
                    mu=mean, sigma=std)

    def compute_gae(self, rewards, dones, values, last_values):
        """compute_returns (rollout_storage.py:138-152): rewards/dones/values
        (T, N), last_values (N,) -> (returns, normalized advantages)."""
        gamma, lam = self.alg.gamma, self.alg.lam
        T = rewards.shape[0]
        not_terminal = 1.0 - dones.float()
        advs = torch.empty_like(values)
        adv = torch.zeros_like(last_values)
        for t in reversed(range(T)):
            next_val = last_values if t == T - 1 else values[t + 1]
            delta = rewards[t] + not_terminal[t] * gamma * next_val - values[t]
            adv = delta + not_terminal[t] * gamma * lam * adv
            advs[t] = adv
        returns = advs + values
        advantages = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        return returns, advantages
