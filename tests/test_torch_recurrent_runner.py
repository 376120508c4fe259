"""The torch port's OnPolicyRunner with the ActorCritic and the GRU and
LSTM ActorCriticRecurrent, on the CPU (the counterpart of
tests/test_recurrent_runner.py).

An 8-env lite3_dtc on a small terrain (decimation 2, 4 steps an
iteration) with tiny nets (heads (32,), rnn_hidden_size 32), picked by
`PolicyCfg.policy_class_name`.  The nets and both updates are held to the
JAX package in tests/test_torch_policies.py; here the loop around them:
learn(2), the carries (threaded through the iterations, zero after a load
and not checkpointed), an exact resume from a checkpoint, the inference
policies, the refusals (an unknown class; the export of a net without
act_teacher), and the recurrent teleop and MLP play_single set-ups from
checkpoints.
"""
import dataclasses
import math
import os

import pytest
import torch

from deep_tracking_control_tpu_torch.agent.ppo import STAT_NAMES
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.runner import checkpoint as ckpt
from deep_tracking_control_tpu_torch.runner import export
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.scripts import common, play_single, teleop
from deep_tracking_control_tpu_torch.tasks import registry

N, T, H = 8, 4, 32
# policy -> (policy_class_name, rnn_type)
POLICIES = {"mlp": ("ActorCritic", "gru"),
            "gru": ("ActorCriticRecurrent", "gru"),
            "lstm": ("ActorCriticRecurrent", "lstm")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(task, train, policy="gru", num_envs=N):
    """The small sizes with `policy`'s class."""
    cls, rnn = POLICIES[policy]
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=num_envs),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=2, num_cols=2,
                                    border_size=4.0))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, policy_class_name=cls,
                                   rnn_type=rnn, rnn_hidden_size=H,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        runner=dataclasses.replace(train.runner, num_steps_per_env=T,
                                   save_interval=1))
    return task, train


def _runner(policy, log_dir=None):
    task, train = tiny(*registry.get_cfgs("lite3_dtc"), policy=policy)
    return OnPolicyRunner(LeggedEnv(task, device="cpu"), train,
                          log_dir=log_dir)


def _carries(runner):
    return [c for k in ("carry_a", "carry_c")
            for c in (runner.log_state[k] if isinstance(runner.log_state[k],
                                                        tuple)
                      else (runner.log_state[k],))]


@pytest.fixture(scope="module", params=sorted(POLICIES))
def trained(request, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp(request.param))
    runner = _runner(request.param, log_dir)
    before = {k: v.clone() for k, v in runner.net.state_dict().items()}
    rows = runner.learn(2)
    return request.param, runner, before, rows, log_dir


def test_learn_two_iterations(trained):
    """learn(2): finite stats, the VAE stats zero, params moved (the
    memories too), the carries live, and checkpoints without carries."""
    policy, runner, before, rows, log_dir = trained
    assert runner.ppo.policy_kind == ("mlp" if policy == "mlp"
                                      else "recurrent")
    assert len(rows) == 2 and runner.current_learning_iteration == 2
    for row in rows:
        for k in STAT_NAMES + ("mean_noise_std", "ep_count"):
            assert math.isfinite(row[k]), k
        assert all(row[k] == 0.0 for k in ("recons_loss", "vel_loss",
                                           "kld_loss", "height_loss"))
    after = runner.net.state_dict()
    moved = {k.split(".")[0] for k in before
             if not torch.equal(before[k], after[k])}
    want = {"actor", "critic", "std"} | (
        set() if policy == "mlp" else {"memory_a", "memory_c"})
    assert moved == want, moved
    assert sorted(os.listdir(log_dir)) == ["model_0.pt", "model_1.pt",
                                           "model_2.pt"]
    saved = ckpt.load(os.path.join(log_dir, "model_2.pt"), "cpu")
    assert set(saved["log_state"]) == {"cur_reward_sum",
                                       "cur_episode_length"}
    if policy != "mlp":
        carries = _carries(runner)
        assert len(carries) == (2 if policy == "gru" else 4)
        assert all(c.shape == (N, H) and c.abs().sum() > 0 for c in carries)


def test_inference_policies(trained):
    """The MLP policy reads the obs alone (every eval script's signature);
    the recurrent one advances its carry: the same obs twice gives two
    actions."""
    policy, runner, *_ = trained
    s = runner.env_state
    fn = runner.get_inference_policy()
    if policy == "mlp":
        a = fn(s["obs"], s["obs_history"], s["privileged_obs"])
        assert torch.equal(a, runner.net(s["obs"], s["obs"])[0])
        assert a.shape == (N, 12) and not a.requires_grad
        return
    carry = (runner.init_carry(N), runner.init_carry(N))
    a1, carry = fn(s["obs"], carry)
    a2, carry = fn(s["obs"], carry)
    assert a1.shape == (N, 12) and torch.isfinite(a1).all()
    assert float((a1 - a2).abs().max()) > 0
    leaves = carry[0] if policy == "lstm" else (carry[0],)
    assert all(c.shape == (N, H) for c in leaves)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_save_load_resumes(tmp_path, policy):
    """save -> load -> one iteration gives what one more iteration gives
    without the round trip, once the carries (not checkpointed) restart
    from zero on both sides: a loaded runner's carries are zero."""
    path = str(tmp_path / "model_1.pt")
    a = _runner(policy)
    a.learn(1)
    a.save(path)
    b = _runner(policy)
    if policy != "mlp":
        b.learn(1)                      # live carries, which load zeroes
    b.load(path)
    assert b.current_learning_iteration == 1
    if policy != "mlp":
        assert all(not c.any() for c in _carries(b))
        a._fresh_carries()
    a.learn(1)
    b.learn(1)
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert torch.equal(a.ppo.learning_rate, b.ppo.learning_rate)
    assert torch.equal(a.ppo.optimizer.mu, b.ppo.optimizer.mu)
    assert int(a.ppo.optimizer.count) == int(b.ppo.optimizer.count) == 40
    assert int(b.ppo.vae_optimizer.count) == 0


def test_refusals(tmp_path):
    """An unknown policy class is a ValueError, as in the JAX runner; the
    export (act_teacher only, as in the JAX package) refuses the other
    nets with a ValueError that names the class."""
    task, train = tiny(*registry.get_cfgs("lite3_dtc"))
    train = dataclasses.replace(train, policy=dataclasses.replace(
        train.policy, policy_class_name="ActorCriticTransformer"))
    with pytest.raises(ValueError, match="ActorCriticTransformer"):
        OnPolicyRunner(LeggedEnv(task, device="cpu"), train)
    runner = _runner("mlp")
    with pytest.raises(ValueError, match="ActorCritic does not"):
        export.export_policy(runner.net, 53, 265, 1389, str(tmp_path))


def test_teleop_and_play_single_from_checkpoints(tmp_path):
    """A GRU checkpoint through teleop's set-up at 4 envs (the carry
    threaded behind the session's policy: keys sent, steps taken) and an
    MLP checkpoint through play_single's for 3 steps."""
    for policy in ("gru", "mlp"):
        task, train = tiny(*registry.get_cfgs("lite3_dtc"), policy=policy)
        root = tmp_path / policy
        run = root / train.runner.experiment_name / "run"
        run.mkdir(parents=True)
        runner = _runner(policy)
        runner.save(str(run / "model_0.pt"))
        args = ["--device", "cpu", "--log_root", str(root)]

        def transform(task, train, policy=policy):
            return tiny(task, train, policy=policy, num_envs=4)
        if policy == "gru":
            sess = teleop.build(teleop.parse_args(args),
                                transform=transform)
            assert sess.env.num_envs == 4
            for k in "wwaq":
                assert sess.handle_key(ord(k))
                tel = sess.step()
            assert all(math.isfinite(v) for v in tel["vel"])
        else:
            logger = play_single.play_single(common.parse_args(args),
                                             steps=3, transform=transform)
            assert len(logger.state_log["base_z"]) == 3
