"""The port's deployment path against the JAX package, on the CPU: the
eval scripts' worlds, the `debug_viz` route and the eval rollouts, the
plane route of play_plane, `load(load_optimizer=False)`, the export round
trip (each script end to end: tests/test_torch_teleop.py).

Small sizes: 4 envs (play_plane: its one env), decimation 2, a narrow
ActorCriticDecoder (terrain latent 32, one hidden layer of 32) whose
weights come from the JAX package's flax net through
`convert.params_from_flax`.  The rollouts run the scripts' own functions
(play.rollout, eval_stones.rollout, play_single.rollout) on the port's
env, with the JAX step's draws injected as tests/test_torch_env.py does;
each port step is recorded, and the JAX env (its kernel path in interpret
mode where it has one) steps from the same state with the actions the
port's policy chose.  Budgets: the physics state at the JAX package's
single-step tolerance (atol 2e-5, rtol 1e-5), the outputs, the `debug`
dict and the tracking errors at 1e-4; done and fall flags equal.  The
port's actions agree with the JAX act_teacher on the JAX state to bf16
precision (2% of the largest action: the MLPs compute in bf16 and the
two frameworks order a matmul's sums differently,
tests/test_torch_networks.py); the exported program equals
`get_inference_policy(teacher=True)` exactly.
"""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu.terrain.generator import Terrain as JTerrain
from deep_tracking_control_tpu_torch.convert import (env_from_jax,
                                                     params_from_flax)
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.models.networks import (
    ActorCriticDecoder as TNet)
from deep_tracking_control_tpu_torch.runner import checkpoint as ckpt
from deep_tracking_control_tpu_torch.runner.export import (export_policy,
                                                           load_policy)
from deep_tracking_control_tpu_torch.runner.train import OnPolicyRunner
from deep_tracking_control_tpu_torch.scripts import (analyze_terminations,
                                                     eval_stones, play,
                                                     play_plane, play_single)
from deep_tracking_control_tpu_torch.tasks import registry as treg
from deep_tracking_control_tpu_torch.terrain.generator import (
    Terrain as TTerrain)
from tests.test_torch_env import OBS, PHYS, _clone, _np

N = 4
STEPS = 3
BF16_REL = 0.02
NET = dict(terrain_latent=32, actor_hidden=(32,), critic_hidden=(32,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the tensors are tiny; parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(task, train, num_envs=N):
    """The small sizes: `num_envs` envs, decimation 2, the narrow net."""
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=num_envs),
        control=dataclasses.replace(task.control, decimation=2))
    train = dataclasses.replace(
        train,
        policy=dataclasses.replace(
            train.policy, terrain_latent=NET["terrain_latent"],
            actor_hidden_dims=NET["actor_hidden"],
            critic_hidden_dims=NET["critic_hidden"]),
        runner=dataclasses.replace(train.runner, num_steps_per_env=4,
                                   save_interval=1))
    return task, train


def jax_draws(jenv, key):
    """The draws of JAX's step on these routes from its key chain (the
    action-lag indices and the privileged height-scan noise; legged_env.py
    :388, 444, 537, 1172, 1180), as tests/test_torch_env.py `_jax_draws`,
    for any env count."""
    k_lag, k_post = jax.random.split(key)
    lag = jax.random.randint(k_lag, (jenv.cfg.control.decimation,), 1, 5)
    k_obs = jax.random.split(k_post, 8)[4]
    k_h = jax.random.split(k_obs)[0]
    noise = jax.random.uniform(k_h, (jenv.num_envs, jenv.num_height_points),
                               minval=-1.0, maxval=1.0)
    return dict(lag=torch.from_numpy(np.asarray(lag).astype(np.int64)),
                height_noise=torch.from_numpy(np.array(noise)))


@pytest.fixture(scope="module")
def nets():
    """The narrow flax net (later layers scaled to a trained-looking gain)
    and the port's net with its weights."""
    jm = jnet.ActorCriticDecoder(**NET)
    rng = np.random.default_rng(0)
    x = [jnp.asarray(rng.normal(size=(N, d)).astype(np.float32))
         for d in (53, 265, 1389, 3)]
    key = jax.random.PRNGKey(3)
    params = jax.jit(jm.init)(key, *x, key)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 50.0 if "Dense_0" not in jax.tree_util.keystr(p)
        and "kernel" in jax.tree_util.keystr(p) else v, params)
    tm = TNet(**NET)
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)),
                       strict=True)
    return jm, params, tm


def _close_bf16(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max() + 1e-6, (name, err)


def recording(env):
    """Record every step of `env` (state and outputs, cloned: the step
    adds to the episode sums in place) into the returned list."""
    steps, real = [], env.step

    def step(*args, **kwargs):
        state, out = real(*args, **kwargs)
        steps.append((_clone(state), _clone(out)))
        return state, out
    env.step = step
    return steps


def acting(tm):
    """The port's teacher policy on `tm`, recording its actions."""
    actions = []

    @torch.no_grad()
    def policy(obs, obs_history, privileged_obs):
        a = tm.act_teacher(obs, obs_history, privileged_obs)
        actions.append(a.clone())
        return a
    return policy, actions


def port_and_jax(configure, nets, num_envs, steps, rollout):
    """A script's config (`configure`) at the small sizes in both
    packages, one JAX init converted to the port, then `rollout(env,
    params, state, policy, gen, steps, draws)` on the port, recorded, and
    the JAX env stepped with the port's actions from the same state and
    keys."""
    jm, jparams, tm = nets
    task, _ = configure(*tiny(*jreg.get_cfgs("lite3_dtc"), num_envs))
    jenv = JEnv(task)
    params, state0 = jenv.init(jax.random.PRNGKey(0))
    jenv._pallas_interpret = True
    jenv._pallas_physics = jenv.patch_src is not None
    jstep = jax.jit(jenv.step)
    keys = [jax.random.PRNGKey(100 + t) for t in range(steps)]

    ttask, _ = configure(*tiny(*treg.get_cfgs("lite3_dtc"), num_envs))
    tenv = TEnv(ttask, device="cpu")
    plane = jenv.patch_src is None
    tparams, tstate = env_from_jax(
        _np(params), _np(state0),
        None if plane else np.asarray(jenv.grid.height), tenv,
        None if plane else np.asarray(jenv.terrain_origins))
    draws = [jax_draws(jenv, k) for k in keys]
    policy, actions = acting(tm)
    tsteps = recording(tenv)
    result = rollout(tenv, tparams, _clone(tstate), policy,
                     torch.Generator().manual_seed(0), steps, draws)
    jstate, jsteps, jacts = state0, [], []
    for t in range(steps):
        jacts.append(np.asarray(jm.apply(
            jparams, jstate["obs"], jstate["obs_history"],
            jstate["privileged_obs"], method=jm.act_teacher)))
        jstate, jout = jstep(params, jstate, jnp.asarray(actions[t].numpy()),
                             keys[t])
        jsteps.append((_np(jstate), _np(jout)))
    return dict(jenv=jenv, tenv=tenv, tparams=tparams, tstate0=tstate,
                draws=draws, policy=policy, tsteps=tsteps, jsteps=jsteps,
                actions=actions, jacts=jacts, result=result)


def check_step(run, t, debug):
    (ts, to), (js, jo) = run["tsteps"][t], run["jsteps"][t]
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(ts["phys"][k].numpy(), js["phys"][k],
                                   **PHYS, err_msg=k)
    np.testing.assert_allclose(ts["anchors"].numpy(), js["anchors"], **PHYS)
    for k in ("obs", "privileged_obs", "obs_history", "base_vel", "rew"):
        np.testing.assert_allclose(to[k].numpy(), jo[k], **OBS, err_msg=k)
    for k in ("measured_heights", "foothold_obs", "optimal_footholds_world",
              "commands"):
        np.testing.assert_allclose(ts[k].numpy(), js[k], **OBS, err_msg=k)
    np.testing.assert_array_equal(to["done"].numpy(), jo["done"])
    assert not jo["done"].any(), "the compared steps must not reset"
    assert ("debug" in to) == ("debug" in jo) == debug
    if debug:
        assert set(to["debug"]) == set(jo["debug"]) == {
            "heights_world", "foothold_score", "pred_footholds",
            "foot_positions"}
        for k, v in jo["debug"].items():
            np.testing.assert_allclose(to["debug"][k].numpy(), v, **OBS,
                                       err_msg=k)
    _close_bf16(run["actions"][t].numpy(), run["jacts"][t], f"actions {t}")


# ---- the worlds --------------------------------------------------------

def test_eval_stones_world_matches_jax():
    """eval_stones' config at difficulty 0.45 equals the JAX script's
    override (scripts/eval_stones.py:44-67 there), and its world
    (terrain seed = seed + 7, the Python generator on both sides in
    selected mode) is the JAX package's bit for bit."""
    jtask, jtrain = jreg.get_cfgs("lite3_dtc")
    stone = 1.0 * (1.05 - 0.45)
    want = dataclasses.replace(
        jtask,
        env=dataclasses.replace(jtask.env, num_envs=64, play_command=False),
        terrain=dataclasses.replace(
            jtask.terrain, num_rows=3, num_cols=3, curriculum=False,
            border_size=8.0, selected=True,
            selected_terrain_type="stepping_stones_terrain",
            selected_terrain_kwargs=(
                ("stone_size", stone), ("stone_distance", 0.06),
                ("max_height", 0.0), ("platform_size", 1.0),
                ("depth", -2.0))),
        noise=dataclasses.replace(jtask.noise, add_noise=False),
        domain_rand=dataclasses.replace(jtask.domain_rand, push_robots=False,
                                        randomize_friction=False))
    task, train = eval_stones.configure(*treg.get_cfgs("lite3_dtc"),
                                        difficulty=0.45)
    assert dataclasses.asdict(task) == dataclasses.asdict(want)
    seed = train.runner.seed + 7
    jt, tt = JTerrain(want.terrain, seed=seed), TTerrain(task.terrain,
                                                         seed=seed)
    assert (jt.backend, tt.backend) == ("python", "python")
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    # 2 m pits between the stones
    assert tt.heights_meters().min() <= -2.0 + 1e-6


# ---- play's debug_viz route and the eval rollout -------------------------

@pytest.fixture(scope="module")
def play_run(nets):
    def rollout(env, params, state, policy, gen, steps, draws):
        return play.rollout(env, params, state, policy, gen, steps,
                            draws=draws, record_steps=steps)
    return port_and_jax(play.configure, nets, N, STEPS, rollout)


@pytest.mark.parametrize("t", range(STEPS))
def test_play_debug_route_matches_jax(play_run, t):
    """play's config (debug_viz on: the plain planner, which returns the
    score tensor) against the JAX env's same route, step by step."""
    assert play_run["tenv"].cfg.env.debug_viz
    check_step(play_run, t, debug=True)


def test_play_frames_are_env_0s(play_run):
    _, frames = play_run["result"]
    assert len(frames) == STEPS
    for f, (ts, to) in zip(frames, play_run["tsteps"]):
        np.testing.assert_array_equal(f["base_pos"],
                                      ts["phys"]["pos"][:, 0].numpy())
        np.testing.assert_array_equal(f["pred_footholds"],
                                      to["debug"]["pred_footholds"][0].numpy())


def test_eval_stones_rollout_matches_jax_formula(play_run, nets):
    """eval_stones.rollout from the same state with the same draws: its
    per-step xy tracking error and fall flags against the JAX script's
    formula (eval_stones.py:91-95 there) on the JAX steps."""
    r = play_run
    policy, _ = acting(nets[2])
    _, errs, falls, dones = eval_stones.rollout(
        r["tenv"], r["tparams"], _clone(r["tstate0"]), policy,
        torch.Generator().manual_seed(0), STEPS, r["draws"])
    assert errs.shape == falls.shape == dones.shape == (STEPS, N)
    scale = r["jenv"].cfg.normalization.obs_scales.lin_vel
    for t, (js, jo) in enumerate(r["jsteps"]):
        want = np.linalg.norm(js["commands"][:, :2]
                              - jo["base_vel"][:, :2] / scale, axis=1)
        np.testing.assert_allclose(errs[t].numpy(), want, **OBS)
        np.testing.assert_array_equal(falls[t].numpy(),
                                      jo["done"] & ~jo["time_out"])
        np.testing.assert_array_equal(dones[t].numpy(), jo["done"])
    rep = eval_stones.report(errs, falls, dones)
    assert rep["envs"] == N and rep["steps"] == STEPS
    assert rep["tracking_err_xy_mean_mps"] == pytest.approx(
        float(errs.mean()), rel=1e-6)


def test_analyze_rollout_tallies(play_run, nets):
    """analyze_terminations.rollout on the same steps: the levels stay
    frozen and the tallies count the JAX steps' endings (none)."""
    r = play_run
    policy, _ = acting(nets[2])
    state, stats = analyze_terminations.rollout(
        r["tenv"], r["tparams"], _clone(r["tstate0"]), policy,
        torch.Generator().manual_seed(0), STEPS, r["draws"])
    assert torch.equal(state["terrain_levels"], r["tstate0"]["terrain_levels"])
    assert float(stats["ep_len_sum"]) == STEPS * N
    assert float(stats["n_done"]) == 0.0
    rows = r["tenv"].cfg.terrain.num_rows
    assert stats["done_by_level"].shape == (rows,)
    for c in analyze_terminations.CAUSES:
        want = sum(float(jo["metrics"][c]) for _, jo in r["jsteps"])
        assert float(stats[c]) == want, c


# ---- play_plane's route --------------------------------------------------

@pytest.fixture(scope="module")
def plane_run(nets):
    def configure(task, train):
        return play_single.configure(*play_plane.to_plane(task, train))

    def rollout(env, params, state, policy, gen, steps, draws):
        return play_single.rollout(env, params, state, policy, gen, steps,
                                   draws=draws)
    return port_and_jax(configure, nets, 1, 2, rollout)


@pytest.mark.parametrize("t", range(2))
def test_play_plane_route_matches_jax(plane_run, t):
    """lite3_dtc on a plane: no tables, so the plain decimation loop over
    sim_step and the plain planner on a zero height scan, in both
    packages; two steps of play_single.rollout."""
    tenv = plane_run["tenv"]
    assert tenv.patch_src is None and not tenv._kernel_physics
    assert tenv.cfg.use_dtc_planner and tenv.cfg.terrain.measure_heights
    check_step(plane_run, t, debug=False)
    ts, _ = plane_run["tsteps"][t]
    assert not ts["measured_heights"].any()


def test_play_single_log(plane_run):
    _, log = plane_run["result"]
    assert log.shape == (2, 3)
    for (ts, to), (cmd_x, vel_x, z) in zip(plane_run["tsteps"], log):
        assert cmd_x == float(ts["commands"][0, 0])
        assert vel_x == float(to["base_vel"][0, 0] / 2.0)
        assert z == float(ts["phys"]["pos"][2, 0])


# ---- load without the optimizers, export -----------------------------------

def _runner(num_envs=N):
    task, train = tiny(*treg.get_cfgs("lite3_dtc"), num_envs)
    task = dataclasses.replace(task, terrain=dataclasses.replace(
        task.terrain, num_rows=2, num_cols=2, border_size=4.0))
    return OnPolicyRunner(TEnv(task, device="cpu"), train)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "model_1.pt")
    a = _runner()
    a.learn(1)
    a.save(path)
    return a, path


@pytest.mark.parametrize("num_envs", [N, 2 * N])
def test_load_without_optimizer(trained, num_envs):
    """load(load_optimizer=False) adopts the params, the iteration and the
    generator; Adam's moments and count and the learning rate stay the
    runner's fresh ones.  The env state is adopted on equal layouts only:
    an 8-env runner keeps its own."""
    a, path = trained
    b = _runner(num_envs)
    fresh_lr = b.ppo.learning_rate.clone()
    fresh_state = _clone(b.env_state)
    b.load(path, load_optimizer=False)
    for k, v in a.net.state_dict().items():
        assert torch.equal(v, b.net.state_dict()[k]), k
    assert b.current_learning_iteration == 1
    assert torch.equal(b.generator.get_state(),
                       ckpt.load(path, "cpu")["generator"])
    assert torch.equal(b.ppo.learning_rate, fresh_lr)
    for opt in (b.ppo.optimizer, b.ppo.vae_optimizer):
        assert int(opt.count) == 0
        assert not opt.mu.any() and not opt.nu.any()
    assert int(a.ppo.optimizer.count) > 0 and a.ppo.optimizer.mu.any()
    same = num_envs == N
    for k, v in fresh_state.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(b.env_state[k],
                               a.env_state[k] if same else v), k


def test_export_round_trip(tmp_path, nets):
    """The exported act_teacher at batch 1 equals get_inference_policy(
    teacher=True) exactly on the CPU, and the JAX act_teacher on the
    converted params to bf16 precision."""
    jm, jparams, tm = nets
    runner = _runner()
    runner.net.load_state_dict(tm.state_dict())
    env = runner.env
    out = export_policy(runner.net, env.num_obs, env.num_obs_history,
                        env.num_privileged_obs, str(tmp_path))
    assert out == str(tmp_path / "policy.pt2") and os.path.getsize(out) > 0
    fn = load_policy(str(tmp_path))
    policy = runner.get_inference_policy(teacher=True)
    s = runner.env_state
    for i in range(N):
        x = (s["obs"][i:i + 1], s["obs_history"][i:i + 1],
             s["privileged_obs"][i:i + 1])
        got = fn(*x)
        assert got.shape == (1, env.num_actions)
        assert torch.equal(got, policy(*x)), i
        want = jm.apply(jparams, *(jnp.asarray(v.numpy()) for v in x),
                        method=jm.act_teacher)
        _close_bf16(got.numpy(), want, f"env {i}")
    with pytest.raises(Exception):        # a fixed deployment batch
        fn(s["obs"], s["obs_history"], s["privileged_obs"])
