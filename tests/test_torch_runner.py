"""The torch port's training loop, checkpoints and entry point, on the CPU.

A 16-env lite3_dtc on a small terrain (decimation 2, 8 steps an iteration)
with a tiny ActorCriticDecoder (terrain_latent 32, hidden (32,)), so an
iteration of collect + the 5 x 4 minibatch update takes a few seconds.
The update's numbers are held against the JAX package in
tests/test_torch_update.py; here the loop around it is checked: stats,
the learning-rate band, save -> load -> resume, the checkpoint helpers,
the strict-parity override, a learn iteration under each route switch and
`python -m ...scripts.train --device cpu`.
"""
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from deep_tracking_control_tpu_torch.agent.ppo import STAT_NAMES
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv
from deep_tracking_control_tpu_torch.runner import checkpoint as ckpt
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.scripts import train as train_script
from deep_tracking_control_tpu_torch.tasks import registry

N, T = 16, 8
# the adaptive rule's band, in the float32 of the learning rate
LR_LO, LR_HI = float(np.float32(1e-5)), float(np.float32(1e-2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are tiny, and the suite runs in
    parallel workers that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _cfgs(num_envs=N):
    task, train = registry.get_cfgs("lite3_dtc")
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=num_envs),
        control=dataclasses.replace(task.control, decimation=2),
        terrain=dataclasses.replace(task.terrain, num_rows=3, num_cols=2,
                                    border_size=4.0))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(train.policy, terrain_latent=32,
                                   actor_hidden_dims=(32,),
                                   critic_hidden_dims=(32,)),
        runner=dataclasses.replace(train.runner, num_steps_per_env=T,
                                   save_interval=1))
    return task, train


def _runner(num_envs=N, log_dir=None):
    task, train = _cfgs(num_envs)
    return OnPolicyRunner(LeggedEnv(task, device="cpu"), train,
                          log_dir=log_dir)


def _params(runner):
    return {k: v.clone() for k, v in runner.net.state_dict().items()}


def test_learn_two_iterations(tmp_path, capsys):
    runner = _runner(log_dir=str(tmp_path))
    before = _params(runner)
    rows = runner.learn(2, init_at_random_ep_len=True)
    assert len(rows) == 2 and runner.current_learning_iteration == 2
    for row in rows:
        for k in STAT_NAMES + ("mean_noise_std", "ep_count",
                               "collection_time", "learning_time"):
            assert math.isfinite(row[k]), k
        assert LR_LO <= row["lr"] <= LR_HI
        assert row["collection_time"] > 0 and row["learning_time"] > 0
    lr = float(runner.ppo.learning_rate)
    assert LR_LO <= lr <= LR_HI
    after = runner.net.state_dict()
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert any(k.startswith("actor_body.") for k in moved)
    assert any(k.startswith("vae.") for k in moved)
    # light saves each save_interval, a full one at the end
    names = sorted(os.listdir(tmp_path))
    assert names == ["model_0.pt", "model_1.pt", "model_2.pt"], names
    assert "env_state" not in ckpt.load(str(tmp_path / "model_1.pt"), "cpu")
    assert "env_state" in ckpt.load(str(tmp_path / "model_2.pt"), "cpu")
    assert runner.tot_timesteps == 2 * T * N
    # one log line every LOG_INTERVAL iterations: iteration 0 only
    logged = [l for l in capsys.readouterr().out.splitlines()
              if l.startswith("it ")]
    assert len(logged) == 1 and logged[0].split("|")[0].split() == ["it", "0"]


def test_save_load_resumes_exactly(tmp_path):
    """save -> load -> one iteration gives what one more iteration gives
    without the round trip: params, optimizer moments, learning rate and
    the generator's state all come back."""
    path = str(tmp_path / "model_1.pt")
    a = _runner()
    a.learn(1)
    a.save(path)
    a.learn(1)
    b = _runner()
    b.load(path)
    assert b.current_learning_iteration == 1
    b.learn(1)
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert torch.equal(a.ppo.learning_rate, b.ppo.learning_rate)
    for oa, ob in ((a.ppo.optimizer, b.ppo.optimizer),
                   (a.ppo.vae_optimizer, b.ppo.vae_optimizer)):
        assert torch.equal(oa.mu, ob.mu) and torch.equal(oa.nu, ob.nu)
        assert int(oa.count) == int(ob.count) == 40
    for k, v in a.env_state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b.env_state[k]), k


def test_load_keeps_fresh_env_state_on_other_shapes(tmp_path):
    """A checkpoint of 16 envs loads into an 8-env runner: params and
    optimizers are adopted, the env state is not."""
    path = str(tmp_path / "model_1.pt")
    a = _runner()
    a.learn(1)
    a.save(path)
    b = _runner(num_envs=8)
    fresh = b.env_state["commands"].clone()
    b.load(path)
    assert b.env_state["commands"].shape[0] == 8
    assert torch.equal(b.env_state["commands"], fresh)
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert torch.equal(a.ppo.optimizer.mu, b.ppo.optimizer.mu)


def test_inference_policies():
    runner = _runner()
    s = runner.env_state
    args = (s["obs"], s["obs_history"], s["privileged_obs"])
    teacher = runner.get_inference_policy()(*args)
    det = runner.get_inference_policy(teacher=False)(*args)
    assert teacher.shape == det.shape == (N, runner.env.num_actions)
    assert torch.isfinite(teacher).all() and torch.isfinite(det).all()
    assert torch.equal(det, runner.net.act_deterministic(*args))
    assert not teacher.requires_grad


def test_get_load_path(tmp_path):
    for run, its in (("Jan01_00-00-00_a", (0, 50, 100)),
                     ("Jan02_00-00-00_b", (0, 7, 250, 30)),
                     ("Jan03_00-00-00_empty", ())):
        os.makedirs(tmp_path / run)
        for it in its:
            (tmp_path / run / f"model_{it}.pt").write_bytes(b"")
    (tmp_path / "Jan02_00-00-00_b" / "model_9.pt.tmp").write_bytes(b"")
    root = str(tmp_path)
    assert ckpt.get_load_path(root) == str(
        tmp_path / "Jan02_00-00-00_b" / "model_250.pt")
    assert ckpt.get_load_path(root, "Jan01_00-00-00_a") == str(
        tmp_path / "Jan01_00-00-00_a" / "model_100.pt")
    assert ckpt.get_load_path(root, "Jan01_00-00-00_a", 50) == str(
        tmp_path / "Jan01_00-00-00_a" / "model_50.pt")
    with pytest.raises(FileNotFoundError):
        ckpt.get_load_path(str(tmp_path / "Jan03_00-00-00_empty"))


def test_strict_parity_selects_the_reference_update(monkeypatch):
    monkeypatch.setenv("DTC_STRICT_PARITY", "1")
    runner = _runner()
    alg = runner.cfg.algorithm
    assert (alg.fused_joint_step, alg.minibatch_perm_granule,
            alg.shuffle_strata) == (False, 1, 1)
    batch, _ = runner.collect()
    assert batch["privileged_obs"].dtype == torch.float32


@pytest.mark.parametrize("switch", ["DTC_FUSED_WINDOW", "DTC_PALLAS_SAMPLER",
                                    "DTC_PALLAS_PHYSICS", "DTC_PALLAS_PLANNER",
                                    "DTC_STRICT_PARITY"])
def test_learn_on_each_route(monkeypatch, switch):
    """collect + update under each route switch (routes: tests/
    test_torch_routes.py): finite stats, the params move."""
    monkeypatch.setenv(switch, "1" if switch == "DTC_STRICT_PARITY" else "0")
    runner = _runner()
    before = [p.detach().clone() for p in runner.net.parameters()]
    (row,) = runner.learn(1)
    assert all(math.isfinite(v) for k, v in row.items() if k != "trace"), row
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, runner.net.parameters()))


def test_train_script_on_the_cpu(tmp_path, monkeypatch):
    """The entry point with --device cpu: a run directory with the reward
    scales, a light save at iteration 0 and the final full save."""
    task, train = _cfgs()
    monkeypatch.setattr(train_script, "get_cfgs",
                        lambda name: (task, train) if name == "lite3_dtc"
                        else registry.get_cfgs(name))
    runner = train_script.main(["--task", "lite3_dtc", "--device", "cpu",
                                "--max_iterations", "1", "--run_name", "t",
                                "--log_root", str(tmp_path)])
    assert runner.device.type == "cpu"
    (run,) = os.listdir(tmp_path / "lite3_dtc")
    assert run.endswith("_t")
    files = sorted(os.listdir(tmp_path / "lite3_dtc" / run))
    assert "reward_scale.ini" in files
    assert {"model_0.pt", "model_1.pt"} <= set(files), files
    assert ckpt.get_load_path(str(tmp_path / "lite3_dtc")).endswith(
        "model_1.pt")
