"""Headless keyboard teleop — the interactive-viewer replacement.

Counterpart of the JAX package's utils/teleop.py on torch tensors.  The
reference's human-in-the-loop surface is the Isaac Gym viewer with
keyboard command control (base_task.py:63-95 key subscriptions,
:130-190 event handling): W/S = vx +/-0.2, A/D = vy +/-0.2 (A is +y,
robot-left), Q/E = yaw +/-0.2, R = reset the looked-at env, P/N =
prev/next looked-at env, 0-8 = look at env i, ESC = quit.  This module
drives the same bindings against a live policy and renders a terminal
panel instead: telemetry (commanded vs actual velocity, height, feet
contacts, reward) plus a top-down ASCII heightfield crop with
base/feet/optimal-foothold markers.

The curses front-end lives in scripts/teleop.py; this module is the
testable core (scripted key sequences in tests/test_torch_teleop.py).
Telemetry leaves the device every step: the session is interactive.

Deviation from the reference (documented): with heading_command=True the
reference's Q/E edit commands[:, 2], which legged_robot.py:536-539
immediately recomputes from the heading target — the keys are dead in
heading mode.  Here Q/E steer the heading target (commands[:, 3]) by
+/-0.2 rad in heading mode so turning actually works.
"""
from __future__ import annotations

import numpy as np
import torch

QUIT_KEYS = (27, ord("x"))          # ESC (KEY_ESCAPE -> "QUIT")
HEIGHT_RAMP = " .:-=+*#%@"


class TeleopSession:
    """Interactive policy-driving session over a LeggedEnv.

    policy: (obs, obs_history, privileged_obs) -> actions, as returned by
    OnPolicyRunner.get_inference_policy; generator: the torch.Generator
    on the env's device that the steps and resets draw from.
    """

    def __init__(self, env, params, state, policy, generator,
                 lin_vel_scale: float = 2.0):
        self.env = env
        self.params = params
        self.state = state
        self.policy = policy
        self.generator = generator
        self.lin_vel_scale = float(lin_vel_scale)
        self.lookat = 0
        self.heading_mode = bool(env.cfg.commands.heading_command)
        self.cmd = self._commands(self.lookat)
        self.last_out = None
        self.quit = False
        self._height = None

    def _commands(self, i: int) -> np.ndarray:
        return self.state["commands"][i].cpu().numpy().copy()

    # ---- key handling (base_task.py:141-176 semantics) -----------------
    def handle_key(self, ch: int) -> bool:
        """Apply one key event; returns False when the session should end."""
        if ch in QUIT_KEYS:
            self.quit = True
            return False
        c = chr(ch).lower() if 0 <= ch < 256 else ""
        if c == "w":
            self.cmd[0] += 0.2
        elif c == "s":
            self.cmd[0] -= 0.2
        elif c == "a":
            self.cmd[1] += 0.2
        elif c == "d":
            self.cmd[1] -= 0.2
        elif c == "q":
            self.cmd[3 if self.heading_mode else 2] += 0.2
        elif c == "e":
            self.cmd[3 if self.heading_mode else 2] -= 0.2
        elif c == "p":
            self._set_lookat((self.lookat - 1) % self.env.num_envs)
        elif c == "n":
            self._set_lookat((self.lookat + 1) % self.env.num_envs)
        elif c == "r":
            self._reset_lookat()
        elif c.isdigit():
            self._set_lookat(min(int(c), self.env.num_envs - 1))
        return True

    def _set_lookat(self, i: int):
        self.lookat = i
        self.cmd = self._commands(i)

    def _reset_lookat(self):
        """R key: reset_idx([lookat]) (base_task.py:171-173)."""
        mask = torch.zeros((self.env.num_envs,), dtype=torch.bool,
                           device=self.env.device)
        mask[self.lookat] = True
        self.state = self.env._apply_reset(self.params, self.state, mask,
                                           self.generator)
        # the reset resampled this env's command; adopt it (reference
        # behavior: user increments are lost on reset)
        self.cmd = self._commands(self.lookat)

    # ---- stepping -------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One control step: write the command override for the looked-at
        env, act, step, and return a telemetry dict."""
        state = self.state
        commands = state["commands"].clone()
        commands[self.lookat] = torch.as_tensor(self.cmd,
                                                device=commands.device)
        state = {**state, "commands": commands}
        actions = self.policy(state["obs"], state["obs_history"],
                              state["privileged_obs"])
        self.state, out = self.env.step(self.params, state, actions,
                                        self.generator)
        self.last_out = out
        i = self.lookat
        done = bool(out["done"][i])
        if done:  # env respawned: adopt its fresh command
            self.cmd = self._commands(i)
        vel = out["base_vel"][i][:2].cpu().numpy() / self.lin_vel_scale
        return dict(
            lookat=i,
            cmd=self._commands(i),
            vel=vel,
            z=float(self.state["phys"]["pos"][2, i]),
            ep_len=int(self.state["episode_length"][i]),
            rew=float(out["rew"][i]),
            contacts=self.state["last_contacts"][i].cpu().numpy(),
            done=done,
        )

    # ---- ASCII top-down rendering ---------------------------------------
    def ascii_map(self, rows: int = 21, cols: int = 41) -> list:
        """Top-down heightfield crop around the looked-at base.

        Renders what legged_robot_dtc.py:460-520 draws as debug spheres:
        feet ('1'-'4'), optimal footholds ('o'), base ('B'), heights as a
        10-char ramp over the local min/max.
        """
        grid = self.env.grid
        if self._height is None:         # the world does not change
            self._height = grid.height.cpu().numpy()
        hf = self._height
        R, C = hf.shape
        hs = float(grid.horizontal_scale)
        b = float(grid.border_size)
        base = self.state["phys"]["pos"][:, self.lookat].cpu().numpy()

        def to_rc(x, y):
            return ((np.asarray(x) + b) / hs).astype(int), \
                   ((np.asarray(y) + b) / hs).astype(int)

        r0 = int(np.clip((base[0] + b) / hs - rows // 2, 0, max(R - rows, 0)))
        c0 = int(np.clip((base[1] + b) / hs - cols // 2, 0, max(C - cols, 0)))
        patch = hf[r0:r0 + rows, c0:c0 + cols]
        lo, hi = float(patch.min()), float(patch.max())
        span = max(hi - lo, 1e-3)
        idx = ((patch - lo) / span * (len(HEIGHT_RAMP) - 1)).astype(int)
        canvas = [[HEIGHT_RAMP[idx[r, c]] for c in range(patch.shape[1])]
                  for r in range(patch.shape[0])]

        def mark(x, y, ch):
            rr, cc = to_rc(x, y)
            rr, cc = int(rr) - r0, int(cc) - c0
            if 0 <= rr < len(canvas) and 0 <= cc < len(canvas[0]):
                canvas[rr][cc] = ch

        if self.last_out is not None and "debug" in self.last_out:
            d = self.last_out["debug"]
            fp = d["foot_positions"][self.lookat].cpu().numpy()
            for f in range(fp.shape[0]):
                mark(fp[f, 0], fp[f, 1], str(f + 1))
            of = self.state["optimal_footholds_world"][self.lookat]
            of = of.cpu().numpy()
            for f in range(of.shape[0]):
                mark(of[f, 0], of[f, 1], "o")
        mark(base[0], base[1], "B")
        # terminal rows top-to-bottom = world +x upward
        return ["".join(row) for row in canvas[::-1]]
