"""Each route through the torch port's env step against the JAX package's
same route.

The switches DTC_FUSED_WINDOW=0, DTC_PALLAS_SAMPLER=0, DTC_PALLAS_PHYSICS=0,
DTC_PALLAS_PLANNER=0 and DTC_STRICT_PARITY=1 choose a route through
`LeggedEnv.step` in both packages, read at the same points.  For each, two
policy steps of the tiny lite3_dtc of tests/test_torch_env.py (4 envs,
decimation 2, 2x2 terrain, obs noise and pushes off) run in both packages
under the same environment: the JAX env with its Pallas kernels in
interpret mode where its route has them (on the physics-off and strict
routes it has none: JAX's own CPU path), the port with its kernels' plain
versions.  Budgets of test_torch_env.py: physics atol 2e-5 / rtol 1e-5
(1e-4 after the second step), obs and rewards 1e-4, done flags equal.

The strict-parity route also starts from a state where the bases are
lowered 0.14 m, so that thigh and shank points press into the terrain:
there the port's strict route must match JAX's strict route, and the
port's default route (the decimation kernel, whose body points see only
the previous step's planes) must differ from it by more than the budget.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.legged_env import LeggedEnv as JEnv
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu_torch.convert import env_from_jax
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.physics import sim as psim
from deep_tracking_control_tpu_torch.tasks import registry as treg
from tests.test_torch_env import N, OBS, PHYS, _clone, _jax_draws, _np, _quiet

SWITCHES = ("DTC_FUSED_WINDOW", "DTC_PALLAS_SAMPLER", "DTC_PALLAS_PHYSICS",
            "DTC_PALLAS_PLANNER", "DTC_STRICT_PARITY")
ROUTES = {"fused window off": {"DTC_FUSED_WINDOW": "0"},
          "sampler off": {"DTC_PALLAS_SAMPLER": "0"},
          "physics off": {"DTC_PALLAS_PHYSICS": "0"},
          "planner off": {"DTC_PALLAS_PLANNER": "0"},
          "strict parity": {"DTC_STRICT_PARITY": "1"}}
LOWER = 0.14           # the body-contact start: bases lowered this far (m)
LEG_BODIES = [2, 3, 6, 7, 10, 11, 14, 15]     # lite3's thighs and shanks


def _run(route, lower=0.0, port_route=None):
    """Two steps of both packages under `route` (the port under
    `port_route` if given), from the init state with the bases lowered by
    `lower`."""
    def env(r):
        for k in SWITCHES:
            mp.delenv(k, raising=False)
        for k, v in r.items():
            mp.setenv(k, v)

    with pytest.MonkeyPatch.context() as mp:
        env(route)
        jenv = JEnv(_quiet(jreg))
        params, state0 = jenv.init(jax.random.PRNGKey(0))
        jenv._pallas_interpret = True       # CPU: the kernels in interpret mode
        if lower:
            phys = dict(state0["phys"])
            phys["pos"] = phys["pos"].at[2].add(-lower)
            state0 = {**state0, "phys": phys}
        jstep = jax.jit(jenv.step)
        rng = np.random.default_rng(0)
        actions = (0.3 * rng.normal(size=(2, N, 12))).astype(np.float32)
        keys = [jax.random.PRNGKey(100), jax.random.PRNGKey(101)]
        jstate, jouts, jstates = state0, [], []
        for t in range(2):
            jstate, jout = jstep(params, jstate, jnp.asarray(actions[t]),
                                 keys[t])
            jouts.append(_np(jout))
            jstates.append(_np(jstate))

        env(route if port_route is None else port_route)
        tenv = TEnv(_quiet(treg), device="cpu")
        tparams, tstate = env_from_jax(_np(params), _np(state0),
                                       np.asarray(jenv.grid.height), tenv,
                                       np.asarray(jenv.terrain_origins))
        leg_force = [0.0]
        plain_sim_step = psim.sim_step

        def recorded(*args, **kwargs):
            out = plain_sim_step(*args, **kwargs)
            if len(touts) == 0:
                cf = torch.linalg.vector_norm(out[2]["contact_forces"], dim=1)
                leg_force[0] = max(leg_force[0], float(cf[LEG_BODIES].max()))
            return out
        mp.setattr(psim, "sim_step", recorded)
        touts, tstates = [], []
        for t in range(2):
            tstate, tout = tenv.step(tparams, tstate,
                                     torch.from_numpy(actions[t]),
                                     torch.Generator().manual_seed(t),
                                     draws=_jax_draws(jenv, keys[t]))
            # snapshots: the port's step updates the episode sums in place
            touts.append(_clone(tout))
            tstates.append(_clone(tstate))
    return dict(jouts=jouts, jstates=jstates, touts=touts, tstates=tstates,
                leg_force=leg_force[0])


@pytest.fixture(scope="module", params=list(ROUTES))
def route_run(request):
    return _run(ROUTES[request.param])


@pytest.mark.parametrize("t", [0, 1])
def test_route_physics_state(route_run, t):
    js, ts = route_run["jstates"][t], route_run["tstates"][t]
    tol = PHYS if t == 0 else dict(atol=1e-4, rtol=1e-4)
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(ts["phys"][k].numpy(), js["phys"][k],
                                   **tol, err_msg=k)
    np.testing.assert_allclose(ts["anchors"].numpy(), js["anchors"], **tol)


@pytest.mark.parametrize("t", [0, 1])
def test_route_terrain_queries_and_plan(route_run, t):
    js, ts = route_run["jstates"][t], route_run["tstates"][t]
    np.testing.assert_allclose(ts["measured_heights"].numpy(),
                               js["measured_heights"], atol=1e-5)
    np.testing.assert_allclose(ts["measured_foot_clearance"].numpy(),
                               js["measured_foot_clearance"], **OBS)
    np.testing.assert_allclose(ts["planes"].numpy(), js["planes"], **OBS)
    np.testing.assert_allclose(ts["foothold_obs"].numpy(), js["foothold_obs"],
                               atol=1e-6)
    np.testing.assert_allclose(ts["optimal_footholds_world"].numpy(),
                               js["optimal_footholds_world"], **OBS)


@pytest.mark.parametrize("t", [0, 1])
@pytest.mark.parametrize("field", ["obs", "privileged_obs", "rew"])
def test_route_outputs(route_run, t, field):
    jo, to = route_run["jouts"][t], route_run["touts"][t]
    np.testing.assert_allclose(to[field].numpy(), jo[field], **OBS,
                               err_msg=field)


@pytest.mark.parametrize("t", [0, 1])
def test_route_done_and_sums(route_run, t):
    jo, to = route_run["jouts"][t], route_run["touts"][t]
    np.testing.assert_array_equal(to["done"].numpy(), jo["done"])
    assert not jo["done"].any(), "the compared steps must not reset"
    js, ts = route_run["jstates"][t], route_run["tstates"][t]
    np.testing.assert_allclose(ts["episode_sums"].numpy(), js["episode_sums"],
                               **OBS)


@pytest.fixture(scope="module")
def contact_runs():
    """The strict route from the body-contact start in both packages, and
    the port's default route from the same start."""
    strict = ROUTES["strict parity"]
    return _run(strict, LOWER), _run(strict, LOWER, port_route={})


def test_strict_route_matches_jax_with_body_contact(contact_runs):
    run, _ = contact_runs
    js, ts = run["jstates"][0], run["tstates"][0]
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(ts["phys"][k].numpy(), js["phys"][k],
                                   **PHYS, err_msg=k)
    np.testing.assert_allclose(ts["anchors"].numpy(), js["anchors"], **PHYS)
    for t in range(2):
        jo, to = run["jouts"][t], run["touts"][t]
        np.testing.assert_array_equal(to["done"].numpy(), jo["done"])
        assert not jo["done"].any(), "the compared steps must not reset"
        for field in ("obs", "privileged_obs", "rew"):
            np.testing.assert_allclose(to[field].numpy(), jo[field], **OBS,
                                       err_msg=field)
    # a thigh or shank carried more than 1 N in some sim step of the first
    # policy step (the port's sim_step, recorded; it matches JAX's above)
    assert run["leg_force"] > 1.0, run["leg_force"]


def test_default_route_departs_from_strict_with_body_contact(contact_runs):
    """The fault that strict parity repairs: the kernel's body points feel
    no terrain in the first step after a reset (their planes are the
    reset's 'no contact'), where the reference route samples it."""
    strict, default = contact_runs
    js, ts = strict["jstates"][0], default["tstates"][0]
    worst = max(float(np.max(np.abs(ts["phys"][k].numpy() - js["phys"][k])
                             - (PHYS["atol"] + PHYS["rtol"]
                                * np.abs(js["phys"][k]))))
                for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"))
    assert worst > 0.0, "the default route stayed within the strict budget"
