"""VecEnv / HistoryWrapper-style adapter over LeggedEnv.

Counterpart of the JAX package's env/vec_env.py: the reference's stateful
API surface (rsl_rl/env/vec_env.py:36-59 and
rsl_rl/env/wrappers/history_wrapper.py:6-53) — `step(actions)` returns the
HistoryWrapper dict {obs, privileged_obs, obs_history, base_vel} plus
(rew, done, info).
"""
from __future__ import annotations

import torch

from .legged_env import LeggedEnv


class VecEnv:
    """Stateful vectorized-env facade (VecEnv ABC + HistoryWrapper)."""

    def __init__(self, env: LeggedEnv, seed: int = 0):
        self.env = env
        self.num_envs = env.num_envs
        self.num_obs = env.num_obs
        self.num_privileged_obs = env.num_privileged_obs
        self.num_actions = env.num_actions
        self.num_obs_history = env.num_obs_history
        self.max_episode_length = env.max_episode_length
        self.generator = torch.Generator(env.device).manual_seed(seed)
        self.params, self.state = env.init(self.generator)
        self.extras = {}

    @staticmethod
    def _obs_dict(src):
        return {k: src[k] for k in ("obs", "privileged_obs", "obs_history",
                                    "base_vel")}

    def step(self, actions):
        """(obs_dict, rew, done, info) (history_wrapper.py:18-24)."""
        self.state, out = self.env.step(
            self.params, self.state,
            torch.as_tensor(actions, dtype=torch.float32,
                            device=self.env.device), self.generator)
        self.extras = {"episode": out["metrics"], "time_outs": out["time_out"]}
        return self._obs_dict(out), out["rew"], out["done"], self.extras

    def reset(self):
        """Reset ALL envs (base_task.py:115-121)."""
        self.state, out = self.env.reset(self.params, self.state,
                                         self.generator)
        return self._obs_dict(out)

    def get_observations(self):
        return self._obs_dict(self.state)

    def get_privileged_observations(self):
        return self.state["privileged_obs"]

    def get_reward_buf(self):
        return self.state["rew_buf"]

    @property
    def episode_length_buf(self):
        return self.state["episode_length"]

    @property
    def reset_buf(self):
        return self.state["reset_buf"]
