"""The reference (a frozen copy of the port's plain paths) against the
port on the CPU at 16 envs, where the port runs the same plain versions:
the world, the init, three steps, the act and one update, bit for bit,
from the benchmark's weights loaded into both."""
import json

import numpy as np
import pytest
import torch

from harness import config as hc
from harness import manifest
from harness import weights
from harness.check import Reference, _flat

SEED = 2 ** 31 + 11


def same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["lite3_dtc", "x30_dtc"])
def test_reference_is_the_plain_port(name):
    from deep_tracking_control_tpu_torch.env.config import TaskCfg, TrainCfg
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    cfg = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    mix = dict(num_envs=16)
    task, train = hc.task_and_train(cfg, TaskCfg, TrainCfg, 16, SEED)
    runner = OnPolicyRunner(LeggedEnv(task, terrain_seed=SEED, device="cpu"),
                            train)
    ref = Reference(cfg, mix, SEED, "cpu")
    assert ref.env.terrain.backend == runner.env.terrain.backend == "native"
    assert np.array_equal(ref.env.terrain.height_field_raw,
                          runner.env.terrain.height_field_raw)
    weights.load(runner.net, SEED, train.policy.init_noise_std)
    net = ref.make_net()
    same(dict(net.named_parameters()), dict(runner.net.named_parameters()))
    params, state = ref.init()
    same(state, runner.env_state)
    g_ref = torch.Generator().manual_seed(3)
    g_port = torch.Generator().manual_seed(3)
    ppo = ref.PPO(net=net, alg=ref.train.algorithm)
    pstate = runner.env_state
    for _ in range(3):
        obs = (state["obs"], state["obs_history"], state["privileged_obs"],
               state["base_vel"])
        a_ref = ppo.act(*obs, g_ref)
        a_port = runner.ppo.act(*(pstate["obs"], pstate["obs_history"],
                                  pstate["privileged_obs"],
                                  pstate["base_vel"]), g_port)
        same(a_ref, a_port)
        state, out = ref.env.step(params, state, a_ref["actions"], g_ref)
        pstate, pout = runner.env.step(runner.env_params, pstate,
                                       a_port["actions"], g_port)
        same({k: v for k, v in out.items() if k != "metrics"},
             {k: v for k, v in pout.items() if k != "metrics"})
    runner.env_state = pstate
    batch, _ = runner.collect()
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    s_ref = ppo.update({k: v.clone() for k, v in batch.items()}, g1)
    s_port = runner.ppo.update(batch, g2)
    same(s_ref, s_port)
    same(dict(net.named_parameters()), dict(runner.net.named_parameters()))


@pytest.mark.parametrize("policy", ["gru", "lstm", "mlp"])
def test_reference_policies_are_the_plain_port(policy):
    """The reference's MLP and recurrent nets, built from the
    configuration, against the port's on the CPU: the weights as loaded,
    the acts of a collected batch (the recurrent ones through the
    rollout-start carries) and one update, bit for bit."""
    from deep_tracking_control_tpu_torch.env.config import TaskCfg, TrainCfg
    from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
    from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
    from test_bench_counts import POLICIES, with_policy
    cfg = with_policy("lite3_dtc", **POLICIES[policy])
    task, train = hc.task_and_train(cfg, TaskCfg, TrainCfg, 16, SEED)
    runner = OnPolicyRunner(LeggedEnv(task, terrain_seed=SEED, device="cpu"),
                            train)
    weights.load(runner.net, SEED, train.policy.init_noise_std)
    ref = Reference(cfg, dict(num_envs=16), SEED, "cpu")
    net = ref.make_net()
    same(dict(net.named_parameters()), dict(runner.net.named_parameters()))
    ppo = ref.PPO(net=net, alg=ref.train.algorithm, policy_kind=ref.kind)
    assert ref.kind == runner.ppo.policy_kind
    runner.collect()                   # carries that are not zero
    batch, _ = runner.collect()
    g_ref, g_port = (torch.Generator().manual_seed(3) for _ in range(2))
    if ref.kind == "recurrent":
        carries = (batch["init_carry_a"], batch["init_carry_c"])
        a_ref = ppo.act_recurrent(batch["obs"][0], *carries, g_ref)
        a_port = runner.ppo.act_recurrent(batch["obs"][0], *carries, g_port)
        same(a_ref[0], a_port[0])
        for c_ref, c_port in zip(a_ref[1:], a_port[1:]):
            assert torch.equal(_flat(c_ref), _flat(c_port))
        up_ref, up_port = ppo.update_recurrent, runner.ppo.update_recurrent
    else:
        obs = batch["obs"][0]
        same(ppo.act(obs, None, None, None, g_ref),
             runner.ppo.act(obs, None, None, None, g_port))
        up_ref, up_port = ppo.update, runner.ppo.update
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    same(up_ref(dict(batch), g1), up_port(batch, g2))
    same(dict(net.named_parameters()), dict(runner.net.named_parameters()))
