"""`correct` on the CPU at 16 envs: the harness's whole run but its look
for a card (the set-up's checked calls, a window of one call, the
reference's judgement against the cell's limits).  A sound run is
correct; the control put in the program's place and each fault the
training cell can have, planted in the program underneath, are not."""
import time

import pytest
import torch

from harness import check
from harness import main as hm
from harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SMALL = dict(num_envs=16)
SEED = 2 ** 31 + 7


def run(cell, stand_ins=()):
    _, nums, others, _ = hm.run_cell(cell, SEED, 0.0, False, "cpu",
                                     time.perf_counter(), SMALL, stand_ins)
    return nums, others


@pytest.fixture(scope="module", params=CELLS)
def cell(request):
    return manifest.cell(manifest.load(), request.param)


@pytest.fixture(scope="module")
def sound(cell):
    return run(cell, ("control", "witness", "half_batch", "step_unchanged",
                      "step_half"))


def test_sound_run_is_correct(cell, sound):
    nums, _ = sound
    ok, rows = check.verdict(nums, cell["limits"])
    assert ok, rows
    assert set(nums) == set(check.NUMBERS)


def test_witness_reads_every_network_number(cell, sound):
    """The witness (a sound rewrite of the networks' products, whose
    readings at the cell's size set the limits' lower ends) is judged in
    the program's place on every number the networks produce."""
    _, others = sound
    assert set(others["witness"]) == {"act_gap", "grad_gap",
                                      "unmoved_leaves"}


@pytest.mark.parametrize("stand_in", ["control", "half_batch",
                                      "step_unchanged", "step_half"])
def test_stand_in_is_not_correct(cell, sound, stand_in):
    """The stand-in's numbers in the program's place (the rest as the
    sound run read them) fail the cell's limits."""
    nums, others = sound
    ok, rows = check.verdict({**nums, **others[stand_in]}, cell["limits"])
    assert not ok, rows


def _unchanged_step(self, grads, lr):
    """ClippedAdam.step that leaves the parameters and moments as they
    were."""


def _half_joint_grads(orig):
    def inner(self, mb, eps_vae, eps_pol):
        h = eps_vae.shape[0] // 2
        return orig(self, {k: v[:h] for k, v in mb.items()}, eps_vae[:h],
                    eps_pol[:h])
    return inner


def _unchanged_env_step(orig):
    def inner(self, params, state, actions, generator, draws=None):
        new, out = orig(self, params, {k: (v.clone() if isinstance(
            v, torch.Tensor) else v) for k, v in state.items()}, actions,
            generator, draws)
        return state, dict(out, obs=state["obs"],
                           privileged_obs=state["privileged_obs"],
                           rew=state["rew_buf"], done=state["reset_buf"])
    return inner


@pytest.mark.parametrize("fault", ["update_unchanged", "half_batch",
                                   "env_unchanged"])
def test_fault_in_program_is_not_correct(cell, fault, monkeypatch):
    from deep_tracking_control_tpu_torch.agent import ppo
    from deep_tracking_control_tpu_torch.env import legged_env
    if fault == "update_unchanged":
        monkeypatch.setattr(ppo.ClippedAdam, "step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(ppo.PPO, "joint_grads",
                            _half_joint_grads(ppo.PPO.joint_grads))
    else:
        monkeypatch.setattr(legged_env.LeggedEnv, "step",
                            _unchanged_env_step(legged_env.LeggedEnv.step))
    nums, _ = run(cell)
    ok, rows = check.verdict(nums, cell["limits"])
    assert not ok, rows
