"""`correct` for the other policies on the CPU at 16 envs: lite3_dtc's
configuration with its policy replaced by the GRU or LSTM
ActorCriticRecurrent or the ActorCritic MLP, judged by the harness's
whole run but its look for a card.  A sound run is correct; the control,
the update's and the env step's faults in the program's place are not,
nor is the program with a fault of its carries, its replay, its update or
its env step planted underneath.

No cell of BENCHMARK.json runs these policies yet, so the limits are the
test's own: lite3_dtc's, which the readings here separate (the sound run
and the witness read 0 on the CPU, where both sides run the same plain
kernels).  Episodes last 25 steps, so that every rollout of 24 has dones
for the carries' resets to act on."""
import copy
import time

import pytest
import torch

from harness import check
from harness import main as hm
from harness import manifest
from test_bench_correct import (SEED, SMALL, _unchanged_env_step,
                                _unchanged_step)
from test_bench_counts import POLICIES

LIMITS = dict(start_gap=0.0, step_rows_off=0.5, rollout_rows_off=10.0,
              act_gap=0.03, grad_gap=0.1, unmoved_leaves=1.0)
EPISODE_S = 0.5
RECURRENT_FAULTS = ("carries_not_reset", "carries_zeroed",
                    "replay_without_resets")
FAULTS = ("update_unchanged", "half_batch", "env_unchanged")


def make_cell(policy: str) -> dict:
    cell = manifest.cell(manifest.load(), "lite3_dtc.train.n32768")
    cfg = copy.deepcopy(cell["config_file"])
    cfg["train"]["policy"].update(POLICIES[policy])
    cfg["task"]["env"]["episode_length_s"] = EPISODE_S
    return dict(cell, config_file=cfg, limits=LIMITS)


def run(cell, stand_ins=()):
    _, nums, others, _ = hm.run_cell(cell, SEED, 0.0, False, "cpu",
                                     time.perf_counter(), SMALL, stand_ins)
    return nums, others


@pytest.fixture(scope="module", params=sorted(POLICIES))
def policy(request):
    return request.param


@pytest.fixture(scope="module")
def sound(policy):
    return run(make_cell(policy), check.NET_MODES + check.STEP_FAULTS)


def test_sound_run_is_correct(sound):
    nums, others = sound
    ok, rows = check.verdict(nums, LIMITS)
    assert ok, rows
    assert set(nums) == set(check.NUMBERS)
    # no row parts where both sides run the same plain kernels
    assert others["detail"]["first_off_field"] == {}


def test_witness_passes(policy, sound):
    """The witness (every product, bf16 or float32, summed in another
    order) reads every network number, the recurrent net's carries among
    them, under the limits."""
    nums, others = sound
    want = {"act_gap", "grad_gap", "unmoved_leaves"}
    if policy != "mlp":
        want.add("rollout_rows_off")
    assert set(others["witness"]) == want
    ok, rows = check.verdict({**nums, **others["witness"]}, LIMITS)
    assert ok, rows


@pytest.mark.parametrize("stand_in", ["control", "half_batch",
                                      "step_unchanged", "step_half"])
def test_stand_in_is_not_correct(sound, stand_in):
    nums, others = sound
    ok, rows = check.verdict({**nums, **others[stand_in]}, LIMITS)
    assert not ok, rows


def test_control_parts_the_carries(policy, sound):
    """The control's float32 products in TF32 part every env's carries
    after a rollout (the cells compute in float32; its float8 touches only
    the bf16 heads); the MLP has none to part."""
    control = sound[1]["control"]
    if policy == "mlp":
        assert "rollout_rows_off" not in control
    else:
        assert control["rollout_rows_off"] > 90.0


def _half_pol_terms(orig):
    """PPO._pol_terms over the first half of the minibatch's rows (of its
    envs, in a replay's (T, envs) terms)."""
    fields = ("actions", "old_log_prob", "advantages", "values", "returns",
              "old_sigma", "old_mu")

    def inner(self, mean, std, value, mb, count=None):
        axis = 1 if mean.dim() == 3 else 0
        h = mean.shape[axis] // 2

        def cut(x):
            return x.narrow(axis, 0, h)
        return orig(self, cut(mean), cut(std), cut(value),
                    {k: cut(mb[k]) for k in fields}, count)
    return inner


def _zeroed_at_start(orig):
    def inner(self):
        self._fresh_carries()
        return orig(self)
    return inner


def _replay_without_resets(orig):
    def inner(cell_apply, init_carry, xs_seq, dones, reset_carry):
        return orig(cell_apply, init_carry, xs_seq, torch.zeros_like(dones),
                    reset_carry)
    return inner


def plant(fault: str, monkeypatch):
    from deep_tracking_control_tpu_torch.agent import ppo
    from deep_tracking_control_tpu_torch.env import legged_env
    from deep_tracking_control_tpu_torch.runner import train
    if fault == "carries_not_reset":
        monkeypatch.setattr(train, "tree_map", lambda fn, *trees: trees[0])
    elif fault == "carries_zeroed":
        monkeypatch.setattr(train.OnPolicyRunner, "collect",
                            _zeroed_at_start(train.OnPolicyRunner.collect))
    elif fault == "replay_without_resets":
        monkeypatch.setattr(ppo, "rnn_replay",
                            _replay_without_resets(ppo.rnn_replay))
    elif fault == "update_unchanged":
        monkeypatch.setattr(ppo.ClippedAdam, "step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(ppo.PPO, "_pol_terms",
                            _half_pol_terms(ppo.PPO._pol_terms))
    else:
        monkeypatch.setattr(legged_env.LeggedEnv, "step",
                            _unchanged_env_step(legged_env.LeggedEnv.step))


@pytest.mark.parametrize("net,fault", [
    (p, f) for p in sorted(POLICIES)
    for f in FAULTS + (() if p == "mlp" else RECURRENT_FAULTS)])
def test_fault_in_program_is_not_correct(net, fault, monkeypatch):
    plant(fault, monkeypatch)
    nums, _ = run(make_cell(net))
    ok, rows = check.verdict(nums, LIMITS)
    assert not ok, rows
    if fault == "replay_without_resets":
        # caught by the update's gradient, the acts being sound
        assert nums["grad_gap"] > LIMITS["grad_gap"]
        assert nums["act_gap"] <= LIMITS["act_gap"]
