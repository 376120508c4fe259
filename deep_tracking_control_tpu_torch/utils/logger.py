"""State/reward episode logger (legged_gym/utils/logger.py:5-38 parity).

Dict-of-lists logger for play/eval scripts; numpy only.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


class Logger:
    def __init__(self, dt: float):
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.dt = dt
        self.num_episodes = 0

    def log_state(self, key, value):
        self.state_log[key].append(value)

    def log_states(self, d: dict):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: dict, num_episodes: int):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(np.sum(v)) * num_episodes)
        self.num_episodes += num_episodes

    def reset(self):
        self.state_log.clear()
        self.rew_log.clear()

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            mean = np.sum(np.array(values)) / max(self.num_episodes, 1)
            print(f" - {k}: {mean}")
        print(f"Total number of episodes: {self.num_episodes}")
