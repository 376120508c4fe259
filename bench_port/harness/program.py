"""The system under test: the port's OnPolicyRunner for one cell, the
benchmark's ranges around its layers, and what the checked calls leave
at their boundaries for the correctness check.

Only this module imports the port (deep_tracking_control_tpu_torch).  The
ranges of a traced run wrap the runner's `collect`, its env's `step` and
its PPO's `act` and `update` (`act_recurrent` and `update_recurrent` for
the recurrent policy); the capture wraps `collect`, and its optimizers'
`step` in the first call alone, and reads the rest between calls.  Both are taken off again; nothing of the port is edited.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from . import config as hc
from . import weights

# the benchmark's ranges, outermost first (harness/trace.py reads them)
RANGES = ("iteration", "collect", "act", "env.step", "update")


def build(cfg_file: dict, mix: dict, seed: int, device):
    """The cell's OnPolicyRunner (no log dir: nothing is written), with its
    env of mix["num_envs"] envs on `device`, its terrain and draws from
    `seed`, and the benchmark's weights (harness/weights.py)."""
    from deep_tracking_control_tpu_torch.env.config import TaskCfg, TrainCfg
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    task, train = hc.task_and_train(cfg_file, TaskCfg, TrainCfg,
                                    mix["num_envs"], seed)
    env = LeggedEnv(task, terrain_seed=seed, device=device)
    runner = OnPolicyRunner(env, train, log_dir=None)
    weights.load(runner.net, seed, train.policy.init_noise_std)
    return runner


def call(runner, mix: dict, first: bool = False):
    """One call of the window: a learn iteration (phase "train"; the first
    of a run desynchronizes the episode resets, as scripts/train.py does)
    or one collect (phase "rollout").  Returns the iteration's row or
    None."""
    if mix["phase"] == "train":
        return runner.learn(1, init_at_random_ep_len=first)[0]
    if mix["phase"] == "rollout":
        runner.collect()
        return None
    raise ValueError(f"phase {mix['phase']!r}: train or rollout")


def env_steps(runner) -> int:
    """Env-steps of one call."""
    return runner.cfg.runner.num_steps_per_env * runner.env.num_envs


def _wrap(obj, name, around):
    """Set obj.<name> to around(original) on the instance; returns an undo."""
    orig = getattr(obj, name)
    setattr(obj, name, around(orig))
    return lambda: delattr(obj, name) if name in vars(obj) else None


@contextlib.contextmanager
def ranges(runner):
    """record_function ranges around the runner's layers (RANGES but the
    iteration, which the window opens)."""
    def named(label):
        def around(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            return inner
        return around
    undo = [_wrap(runner, "collect", named("collect")),
            _wrap(runner.ppo, "act", named("act")),
            _wrap(runner.ppo, "act_recurrent", named("act")),
            _wrap(runner.env, "step", named("env.step")),
            _wrap(runner.ppo, "update", named("update")),
            _wrap(runner.ppo, "update_recurrent", named("update"))]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def _host(x):
    """A host copy of a nest of dicts, tuples and tensors."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return x


def _params(net) -> dict:
    return {n: p.detach().clone() for n, p in net.named_parameters()}


class Capture:
    """What the program's checked calls leave at boundaries that any
    implementation of a learn iteration keeps, on the host, for the
    reference to judge after the window (harness/check.py):

      terrain      the heightfield (int16) and the tile origins
      state0       the env state after init
      params0      the weights before the first call
      states[i]    the env state as call i's collect starts; states[n]
                   the env state after the last collect
      gen[i]       the runner's generator there
      batch[i]     the batch that collect returns
      gen_update[i] the generator after collect (the update's draws)
      first_step   {optimizer: state_dict()} after each optimizer's first
                   step, the one reading inside a call (an optimizer step
                   run inside a CUDA graph's capture is not read)
      params_end   the weights after the last call
    and of a recurrent policy
      params_at[i] the weights as call i's collect starts
      carries_end  the runner's carries (carry_a, carry_c) after the last
                   collect; call i's rollout-start ones are in batch[i]

    `seconds` is the time spent copying, which set-up does not count.  The
    capture lets go of the runner after its last call.
    """

    def __init__(self, runner, calls: int):
        self.runner = runner
        self.calls = calls
        self.seconds = 0.0
        self.device = runner.device
        self.cuda = self.device.type == "cuda"
        t = self._start()
        env = runner.env
        self.terrain = (None if env.terrain is None else
                        (env.terrain.height_field_raw.copy(),
                         env.terrain.env_origins.copy()))
        self.state0 = _host(runner.env_state)
        self.params0 = _host(_params(runner.net))
        self.states, self.gen, self.batch, self.gen_update = {}, {}, {}, {}
        self.first_step, self.params_end = {}, None
        self.recurrent = runner.recurrent
        self.params_at, self.carries_end = {}, None
        self.it = -1
        self._stop(t)

    def _start(self) -> float:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _stop(self, t: float):
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t

    def nbytes(self) -> int:
        """Bytes held on the host."""
        seen = set()

        def walk(x):
            if isinstance(x, dict):
                return sum(walk(v) for v in x.values())
            if isinstance(x, (tuple, list)):
                return sum(walk(v) for v in x)
            if isinstance(x, torch.Tensor) and id(x) not in seen:
                seen.add(id(x))
                return x.numel() * x.element_size()
            return 0
        return walk([self.state0, self.params0, self.states, self.batch,
                     self.first_step, self.params_end, self.params_at,
                     self.carries_end])

    def call(self, mix: dict, first: bool = False):
        """One checked call of the window's own kind; returns its row."""
        r = self.runner
        undo = [_wrap(r, "collect", self._collect)]
        if self.it < 0 and mix["phase"] == "train":
            undo += [_wrap(getattr(r.ppo, n), "step",
                           functools.partial(self._first_step, n))
                     for n in ("optimizer", "vae_optimizer")]
        try:
            row = call(r, mix, first=first)
        finally:
            for u in reversed(undo):
                u()
        t = self._start()
        if self.it == 0:
            self.first_step = _host(self.first_step)
        if self.it == self.calls - 1:
            self.states[self.calls] = _host(r.env_state)
            self.params_end = _host(_params(r.net))
            if self.recurrent:
                self.carries_end = _host((r.log_state["carry_a"],
                                          r.log_state["carry_c"]))
            self.runner = None
        self._stop(t)
        return row

    def _first_step(self, name, fn):
        opt = getattr(self.runner.ppo, name)

        def inner(*a, **k):
            out = fn(*a, **k)
            if name not in self.first_step and not (
                    self.cuda and torch.cuda.is_current_stream_capturing()):
                self.first_step[name] = opt.state_dict()
            return out
        return inner

    def _collect(self, fn):
        def inner(*a, **k):
            self.it += 1
            t = self._start()
            self.states[self.it] = _host(self.runner.env_state)
            self.gen[self.it] = self.runner.generator.get_state().clone()
            if self.recurrent:
                self.params_at[self.it] = _host(_params(self.runner.net))
            self._stop(t)
            batch, aux = fn(*a, **k)
            t = self._start()
            self.batch[self.it] = _host(batch)
            self.gen_update[self.it] = self.runner.generator.get_state().clone()
            self._stop(t)
            return batch, aux
        return inner
