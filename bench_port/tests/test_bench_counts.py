"""The frozen counts: model FLOPs against a dispatcher count of the
networks' forward and backward, and the kernels' table against a fresh
derivation on the CPU."""
import json
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from counts import flops, kernels
from harness import config as hc
from harness import manifest


class MatmulFlops(TorchDispatchMode):
    """2*M*N*K of every matrix product the dispatcher sees."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm"):
            a, b = args[-2], args[-1]
            self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif name in ("bmm", "baddbmm"):
            a, b = args[-2], args[-1]
            self.flops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        return out


@pytest.mark.parametrize("name", ["lite3_dtc", "x30_dtc"])
def test_model_flops_match_dispatcher(name):
    from deep_tracking_control_tpu_torch.agent.ppo import PPO
    from deep_tracking_control_tpu_torch.env import config as pc
    from deep_tracking_control_tpu_torch.models.networks import (
        ActorCriticDecoder)
    cfg = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    task, train = hc.task_and_train(cfg, pc.TaskCfg, pc.TrainCfg, 16, 1)
    e, pol = task.env, train.policy
    scan = (e.num_privileged_obs - 3) // 2
    net = ActorCriticDecoder(
        num_obs=e.num_observations, num_privileged_obs=e.num_privileged_obs,
        num_actions=e.num_actions,
        obs_history_dim=e.num_observation_history * e.num_observations,
        terrain_dim=scan, terrain_latent=pol.terrain_latent,
        z_dim=pol.cenet_latent, actor_hidden=tuple(pol.actor_hidden_dims),
        critic_hidden=tuple(pol.critic_hidden_dims),
        generator=torch.Generator().manual_seed(0))
    ppo = PPO(net=net, alg=train.algorithm)
    B, g = 8, torch.Generator().manual_seed(1)

    def r(*s):
        return torch.randn(*s, generator=g)
    obs, hist = r(B, e.num_observations), r(B, 5 * e.num_observations)
    priv, vel = r(B, e.num_privileged_obs), r(B, 3)
    per = flops.per_row(cfg)
    with MatmulFlops() as c:
        ppo.act(obs, hist, priv, vel, g)
    assert c.flops == per["act"] * B
    with MatmulFlops() as c:
        ppo.value(obs, priv, vel)
    assert c.flops == per["value"] * B
    mb = dict(obs=obs, obs_history=hist, privileged_obs=priv,
              next_obs=r(B, e.num_observations), base_vel=vel,
              actions=r(B, e.num_actions), values=r(B), returns=r(B),
              advantages=r(B), old_log_prob=r(B), old_mu=r(B, e.num_actions),
              old_sigma=torch.ones(B, e.num_actions))
    with MatmulFlops() as c:
        ppo.joint_grads(mb, r(B, pol.cenet_latent), r(B, pol.cenet_latent))
    assert c.flops == per["step"] * B
    T, N = train.runner.num_steps_per_env, 32768
    assert flops.iteration(cfg, N) == (
        per["act"] * T * N + per["value"] * N
        + per["step"] * T * N * train.algorithm.num_learning_epochs)


# the other policies: lite3_dtc's configuration with its policy replaced
POLICIES = {"gru": dict(policy_class_name="ActorCriticRecurrent",
                        rnn_type="gru", rnn_hidden_size=256),
            "lstm": dict(policy_class_name="ActorCriticRecurrent",
                         rnn_type="lstm", rnn_hidden_size=512),
            "mlp": dict(policy_class_name="ActorCritic")}


def with_policy(name: str, **policy) -> dict:
    cfg = json.loads((manifest.BENCH / "configs" / f"{name}.json").read_text())
    cfg["train"]["policy"].update(policy)
    return cfg


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_model_flops_match_dispatcher_policies(policy):
    """The MLP's act, last value and minibatch step, and the recurrent
    net's act, last value and one replayed minibatch (forward and
    backward over T steps), against the dispatcher's count."""
    from deep_tracking_control_tpu_torch.agent.ppo import PPO
    from deep_tracking_control_tpu_torch.env import config as pc
    from deep_tracking_control_tpu_torch.models.networks import (
        ActorCritic, ActorCriticRecurrent)
    cfg = with_policy("lite3_dtc", **POLICIES[policy])
    task, train = hc.task_and_train(cfg, pc.TaskCfg, pc.TrainCfg, 16, 1)
    e, pol = task.env, train.policy
    heads = dict(actor_hidden=tuple(pol.actor_hidden_dims),
                 critic_hidden=tuple(pol.critic_hidden_dims),
                 generator=torch.Generator().manual_seed(0))
    D, A = e.num_observations, e.num_actions
    if policy == "mlp":
        net = ActorCritic(num_obs=D, num_critic_obs=D, num_actions=A,
                          **heads)
    else:
        net = ActorCriticRecurrent(num_obs=D, num_critic_obs=D,
                                   num_actions=A,
                                   rnn_hidden_size=pol.rnn_hidden_size,
                                   rnn_type=pol.rnn_type, **heads)
    ppo = PPO(net=net, alg=train.algorithm,
              policy_kind="mlp" if policy == "mlp" else "recurrent")
    T, B, g = train.runner.num_steps_per_env, 8, torch.Generator().manual_seed(1)

    def r(*s):
        return torch.randn(*s, generator=g)
    per = flops.per_row(cfg)
    obs = r(B, D)
    old = dict(actions=r(T, B, A), values=r(T, B), returns=r(T, B),
               advantages=r(T, B), old_log_prob=r(T, B),
               old_mu=r(T, B, A), old_sigma=torch.ones(T, B, A))
    if policy == "mlp":
        with MatmulFlops() as c:
            ppo.act(obs, None, None, None, g)
        assert c.flops == per["act"] * B
        with MatmulFlops() as c:
            net.critic(obs)
        assert c.flops == per["value"] * B
        mb = dict({k: v[0] for k, v in old.items()}, obs=obs)
        with MatmulFlops() as c, torch.enable_grad():
            terms = ppo._pol_terms(*net(obs, obs), mb)
            torch.autograd.grad(terms[0], ppo.optimizer.params,
                                allow_unused=True)
        assert c.flops == per["step"] * B
    else:
        def carry():
            return tuple(x + 0.1 * r(*x.shape) for x in
                         net.memory_a.initialize_carry(B)) \
                if pol.rnn_type == "lstm" else r(B, pol.rnn_hidden_size)
        ca, cc = carry(), carry()
        with MatmulFlops() as c:
            ppo.act_recurrent(obs, ca, cc, g)
        assert c.flops == per["act"] * B
        with MatmulFlops() as c:
            net.critic(net.memory_c(obs, cc)[1])
        assert c.flops == per["value"] * B
        dones = torch.zeros(T, B, dtype=torch.bool)
        dones[5, :3] = dones[17, 2:6] = True
        batch = dict(old, obs=r(T, B, D), dones=dones, init_carry_a=ca,
                     init_carry_c=cc)
        with MatmulFlops() as c:
            ppo.recurrent_grads(batch, torch.arange(B))
        assert c.flops == B * (T * per["step"] + (T - 1) * per["carry"])
    alg, N = train.algorithm, 32768
    nmb, epochs = alg.num_mini_batches, alg.num_learning_epochs
    if policy == "mlp":
        update = per["step"] * T * N * epochs
    else:
        update = epochs * nmb * (N // nmb) * (T * per["step"]
                                              + (T - 1) * per["carry"])
    assert flops.iteration(cfg, N) == (per["act"] * T * N
                                       + per["value"] * N + update)


def test_kernel_table_rederived():
    """counts/derive.py --check: the port's plain versions at 16, 32 and 48
    envs give the frozen table (~40 s)."""
    out = subprocess.run([sys.executable, str(manifest.BENCH / "counts" /
                                              "derive.py"), "--check"],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr


def test_bounds():
    t = kernels.table()["lite3_dtc"]
    # K1 at 4096 envs: the 0.0050 ms bytes bound of the port's kernel table
    one = kernels.launch(t["K1"], 4096)
    assert kernels.bound_s(**one) * 1e3 == pytest.approx(0.00496, abs=5e-5)
    assert set(t) <= set(kernels.KERNELS)


def test_kernel_counts_of_another_policy():
    """A configuration that changes only the policy takes the counts of
    the table's configuration with its task; another task has none."""
    t = kernels.table()
    for policy in POLICIES:
        cfg = with_policy("lite3_dtc", **POLICIES[policy])
        assert kernels.for_config("lite3_" + policy, cfg) == t["lite3_dtc"]
    assert kernels.for_config("x30_dtc", with_policy("x30_dtc")) == \
        t["x30_dtc"]
    cfg = with_policy("lite3_dtc")
    cfg["task"]["env"]["episode_length_s"] = 10.0
    assert kernels.for_config("lite3_short", cfg) is None
