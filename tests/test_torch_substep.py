"""The physics decimation step (K1) of the torch port against the JAX
package.

The plain version of the port's decimation kernel must reproduce
physics/pallas_substep.py `decimation_step` (its fused-window variant, run
in interpret mode) at the JAX package's single-step budget, atol 2e-5 /
rtol 1e-5 (tests/test_pallas_substep.py:71-87).  Inputs are made with
numpy from a seed: 4 robots standing on a 2x2-tile terrain, decimation 2,
with body-point planes high enough that some body points touch; once for
the Lite3 at 0.05 m a cell and once for the X30 (other links, masses and
PD gains) at 0.1 m a cell.  The X30's step is not resolved to that budget
by float32 arithmetic on every element (its joint velocities part from a
float64 run of the same step by more than it, in the JAX kernel and in
the port alike), so its case holds the arithmetic in float64: the JAX
kernel's own source run in double precision against the port's plain
version in double precision at the budget, element by element; and the
float32 rounding of the port's plain version against the JAX kernel's,
each from its own float64 run (the rule chip_smoke.py holds the card's
kernel to: beyond the budget at no more than twice as many elements plus
one in a thousand).  The
leg-batched FK/ABA and the inertias are compared on their own as well.

The window variant (K1w: the same step reading a materialized (N, 40, 128)
contact window) must equal the fused variant bit for bit, fed the window
copy or a view of the patch copy, and match the JAX package's window
variant (`_substep_kernel`, interpret mode) at the same budget.  The plain
physics step of the reference route, `sim_step`, must match the JAX
package's sim.sim_step for one decimation over extracted patches at that
budget, from a standing state and from one where thigh and shank points
touch the terrain.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import check_float_build

from deep_tracking_control_tpu.env.config import TerrainCfg
from deep_tracking_control_tpu.physics import engine as jengine
from deep_tracking_control_tpu.physics import pallas_substep as jsub
from deep_tracking_control_tpu.physics import quadruped as jquad
from deep_tracking_control_tpu.physics import sim as jsim
from deep_tracking_control_tpu.robot import quadrupeds
from deep_tracking_control_tpu.tasks.registry import get_cfgs
from deep_tracking_control_tpu.terrain import patch as jpatch
from deep_tracking_control_tpu.terrain.generator import Terrain
from deep_tracking_control_tpu.terrain.grid import TerrainGrid
from deep_tracking_control_tpu_torch.env import config as tconfig
from deep_tracking_control_tpu_torch.ops import cuda_patch
from deep_tracking_control_tpu_torch.physics import cuda_substep as tsub
from deep_tracking_control_tpu_torch.physics import engine as tengine
from deep_tracking_control_tpu_torch.physics import quadruped as tquad
from deep_tracking_control_tpu_torch.physics import sim as tsim
from deep_tracking_control_tpu_torch.robot import quadrupeds as tquadrupeds
from deep_tracking_control_tpu_torch.terrain import patch as tpatch

N, DECIM = 4, 2
TIGHT = dict(atol=2e-5, rtol=1e-5)


# robot -> (task, base height range over the terrain, the body planes'
# lift): the X30 stands some 0.21 m taller than the Lite3
ROBOTS = {"lite3": ("lite3_dtc", (0.27, 0.33), 0.0),
          "x30": ("x30_dtc", (0.48, 0.54), 0.21)}


def _build_case(robot):
    """The robot's task constants, a 2x2-tile terrain at the task's
    horizontal scale (0.05 m for the Lite3, 0.1 m for the X30), seeded
    inputs, and the JAX package's fused kernel on them in interpret mode."""
    task_name, (z_lo, z_hi), lift = ROBOTS[robot]
    task, _ = get_cfgs(task_name)
    model = quadrupeds.get_robot(robot)
    geom = jsim.default_contact_geometry(model)
    rng = np.random.default_rng(42)
    tcfg = TerrainCfg(num_rows=2, num_cols=2, border_size=4.0,
                      horizontal_scale=task.terrain.horizontal_scale)
    terr = Terrain(tcfg, seed=3, backend="python")
    grid = TerrainGrid(height=jnp.asarray(terr.heights_meters()),
                       horizontal_scale=tcfg.horizontal_scale,
                       border_size=tcfg.border_size, is_plane=False)
    m3, m10 = jpatch.pooled_tables(grid)
    src = jpatch.make_source(grid, jnp.stack([grid.height, m3, m10]))

    f32 = np.float32
    origins = terr.env_origins.reshape(-1, 3)[rng.integers(0, 4, N)]
    pos = (origins + np.c_[rng.uniform(-0.3, 0.3, (N, 2)),
                           rng.uniform(z_lo, z_hi, (N, 1))]).T.astype(f32)
    default_q = np.array([a for _, a in task.init_state.default_joint_angles],
                         dtype=f32)

    def gains(table):
        # the env's rule: a joint takes the gain of each key in its name
        out = np.zeros(12, dtype=f32)
        for i, name in enumerate(model.joint_names):
            for key, val in table:
                if key in name:
                    out[i] = val
        return out
    q = (default_q[:, None] + rng.normal(0, 0.05, (12, N))).astype(f32)
    tilt = rng.normal(0, 0.05, (3, N))
    quat = np.concatenate([tilt, np.ones((1, N))]).astype(f32)
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    phys = dict(pos=pos, quat=quat,
                lin_vel=rng.normal(0, 0.2, (3, N)).astype(f32),
                ang_vel=rng.normal(0, 0.2, (3, N)).astype(f32),
                q=q, qd=rng.normal(0, 0.5, (12, N)).astype(f32))
    P = len(geom.dyn_idx)
    nb = P - len(model.foot_body_index)
    inertias, _ = jengine.make_inertias(
        model, payload=jnp.asarray(rng.uniform(-1, 1, N), jnp.float32),
        num_envs=N)
    starts, origin = jpatch.patch_starts(src, jnp.asarray(pos[:2].T))
    hs = tcfg.horizontal_scale
    worigin = (origin + hs * jnp.array([jsub.WIN_R0, jsub.WIN_C0],
                                       jnp.float32)).T
    planes = np.stack([
        origins[:, 2][None] + lift + rng.uniform(-0.05, 0.3, (nb, N)),
        rng.uniform(-0.3, 0.3, (nb, N)), rng.uniform(-0.3, 0.3, (nb, N)),
        np.broadcast_to(pos[0], (nb, N)), np.broadcast_to(pos[1], (nb, N))],
        axis=1).astype(f32)
    planes[:, 0, 0] = -1e4                       # env 0: no body contact
    arrays = dict(
        inertias=np.asarray(inertias), phys=phys,
        anchors=(pos[None, :2] + rng.normal(0, 0.1, (P, 2, N))).astype(f32),
        goals=(default_q[None, :, None]
               + rng.normal(0, 0.1, (DECIM, 12, N))).astype(f32),
        kp_eff=(gains(task.control.stiffness)[:, None]
                * rng.uniform(0.95, 1.05, (12, N))).astype(f32),
        kd_eff=(gains(task.control.damping)[:, None]
                * rng.uniform(0.95, 1.05, (12, N))).astype(f32),
        strengths=rng.uniform(0.9, 1.1, (12, N)).astype(f32),
        offsets=rng.normal(0, 0.01, (12, N)).astype(f32),
        friction=rng.uniform(0.5, 1.25, N).astype(f32),
        restitution=rng.uniform(0.0, 1.0, N).astype(f32),
        win_origin=np.asarray(worigin), planes=planes,
        blocks=np.asarray(src.blocks), starts=np.asarray(starts),
        window=np.asarray(jpatch.extract_window(src, starts)))
    thigh = np.array([model.body_dyn_index[i] for i, n in
                      enumerate(model.body_names) if "THIGH" in n], np.int32)
    common = (DECIM, thigh)

    def jax_args():
        a = {k: (v if k == "phys" else jnp.asarray(v)) for k, v in arrays.items()}
        a["phys"] = {k: jnp.asarray(v) for k, v in phys.items()}
        return a

    def run(a, window=None):
        fused = window is None
        return jsub.decimation_step(
            model, geom, task.sim, *common, a["inertias"], a["phys"],
            a["anchors"], a["goals"], a["kp_eff"], a["kd_eff"],
            a["strengths"], a["offsets"], a["friction"], a["restitution"],
            window, a["win_origin"], a["planes"], hs, interpret=True,
            blocks=a["blocks"] if fused else None,
            starts=a["starts"] if fused else None)
    want = run(jax_args())
    return model, geom, task, arrays, common, hs, want, run, jax_args


@pytest.fixture(scope="module")
def case():
    return _build_case("lite3")


@pytest.fixture(scope="module")
def x30_case():
    return _build_case("x30")


@pytest.fixture(scope="module")
def window_want(case):
    """The JAX package's window variant on the case, in interpret mode (its
    window (40, 128, N), as legged_env.py:462-468 transposes it)."""
    *_, run, jax_args = case
    a = jax_args()
    return run(a, jnp.transpose(a["window"], (1, 2, 0)))


def _port_step(case, fn, terrain=None, wide=False):
    """The port's step on the case: the fused variant's blocks and starts,
    or `terrain` = dict(window=...) for the window variant.  wide: every
    float32 input in float64 (and float64 the default dtype)."""
    model, geom, task, arrays, common, hs, *_ = case
    tmodel = tquadrupeds.get_robot(task.asset.robot)
    tgeom = tsim.default_contact_geometry(tmodel)
    sim = tconfig.SimParams(**dataclasses.asdict(task.sim))
    t = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()
         if k != "phys"}
    phys = {k: torch.from_numpy(v.copy()) for k, v in arrays["phys"].items()}
    if wide:
        t = {k: v.double() if v.dtype == torch.float32 else v
             for k, v in t.items()}
        phys = {k: v.double() for k, v in phys.items()}
        old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            return _port_step_args(fn, tmodel, tgeom, sim, common, t, phys,
                                   hs, terrain)
        finally:
            torch.set_default_dtype(old)
    return _port_step_args(fn, tmodel, tgeom, sim, common, t, phys, hs,
                           terrain)


def _port_step_args(fn, tmodel, tgeom, sim, common, t, phys, hs, terrain):
    if terrain is None:
        terrain = dict(blocks=t["blocks"], starts=t["starts"])
    return fn(tmodel, tgeom, sim, *common, t["inertias"], phys, t["anchors"],
              t["goals"], t["kp_eff"], t["kd_eff"], t["strengths"],
              t["offsets"], t["friction"], t["restitution"], t["win_origin"],
              t["planes"], hs, **terrain)


def _assert_step_matches(got, want):
    phys, anchors, info = got
    want_phys, want_anchors, want_info = want
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(phys[k].numpy(), np.asarray(want_phys[k]),
                                   **TIGHT, err_msg=k)
    np.testing.assert_allclose(anchors.numpy(), np.asarray(want_anchors),
                               **TIGHT)
    for k in ("foot_pos", "foot_vel", "thigh_pos", "torques", "body_pts"):
        np.testing.assert_allclose(info[k].numpy(), np.asarray(want_info[k]),
                                   **TIGHT, err_msg=k)
    # contact forces are stiff springs (12 kN/m) on these positions
    np.testing.assert_allclose(info["contact_forces"].numpy(),
                               np.asarray(want_info["contact_forces"]),
                               atol=1e-3, rtol=1e-5)


def _flat(step):
    """{name: array} of a step's (phys, anchors, info)."""
    phys, anchors, info = step
    out = {**phys, "anchors": anchors, **info}
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


# output -> atol: contact forces are stiff springs (12 kN/m)
STEP_ATOL = {k: TIGHT["atol"] for k in (
    "pos", "quat", "lin_vel", "ang_vel", "q", "qd", "anchors", "foot_pos",
    "foot_vel", "thigh_pos", "torques", "body_pts")}
STEP_ATOL["contact_forces"] = 1e-3


class _Float64Numpy:
    """jax.numpy with float32 read as float64: the JAX kernel's source run
    in double precision (its dtypes and output buffers named float32)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_step_float64(case, monkeypatch):
    """The JAX package's kernel on the case, interpret mode, in float64."""
    *_, arrays, common, hs, want, run, jax_args = case
    with jax.enable_x64(True):
        monkeypatch.setattr(jsub, "jnp", _Float64Numpy())
        a = {k: jnp.asarray(np.asarray(v), jnp.float64)
             if np.asarray(v).dtype == np.float32 else jnp.asarray(v)
             for k, v in arrays.items() if k != "phys"}
        a["phys"] = {k: jnp.asarray(v, jnp.float64)
                     for k, v in arrays["phys"].items()}
        out = _flat(run(a))
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("robot", ["lite3", "x30"])
def test_plain_decimation_step_matches_pallas_kernel(request, robot):
    case = request.getfixturevalue("case" if robot == "lite3" else "x30_case")
    want_phys, want_anchors, want_info = case[6]
    if robot == "x30":
        want = _flat(case[6])
        got = _flat(_port_step(case, tsub.decimation_step))
        wide = _flat(_port_step(case, tsub.decimation_step, wide=True))
        jax64 = _jax_step_float64(case, request.getfixturevalue("monkeypatch"))
        unresolved = 0
        for k, atol in STEP_ATOL.items():
            # the same arithmetic in double precision, element by element
            np.testing.assert_allclose(wide[k].numpy(), jax64[k].numpy(),
                                       atol=atol, rtol=TIGHT["rtol"],
                                       err_msg=f"{k} (float64)")
            _, off_port, _ = check_float_build(
                k, got[k], wide[k], want[k], jax64[k], atol, TIGHT["rtol"])
            unresolved += off_port
        # the case reaches the elements float32 does not resolve
        assert unresolved > 0
    else:
        phys, anchors, info = _port_step(case, tsub.decimation_step)
        for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
            np.testing.assert_allclose(phys[k].numpy(),
                                       np.asarray(want_phys[k]), **TIGHT,
                                       err_msg=k)
        np.testing.assert_allclose(anchors.numpy(), np.asarray(want_anchors),
                                   **TIGHT)
        for k in ("foot_pos", "foot_vel", "thigh_pos", "torques",
                  "body_pts"):
            np.testing.assert_allclose(info[k].numpy(),
                                       np.asarray(want_info[k]), **TIGHT,
                                       err_msg=k)
        # contact forces are stiff springs (12 kN/m) on these positions
        np.testing.assert_allclose(info["contact_forces"].numpy(),
                                   np.asarray(want_info["contact_forces"]),
                                   atol=1e-3, rtol=1e-5)
    # the case exercises contact: feet and some body points carry load
    cf = np.asarray(want_info["contact_forces"])
    assert np.abs(cf[[4, 8, 12, 16]]).max() > 1.0
    assert np.abs(cf[0]).max() > 1.0


def test_fk_aba_and_inertias_match_jax(case):
    model, geom, task, arrays, common, hs, *_ = case
    tmodel = tquadrupeds.get_robot("lite3")
    sim = tconfig.SimParams(**dataclasses.asdict(task.sim))
    jl, tl = jquad.quad_layout(model), tquad.quad_layout(tmodel)
    for f in dataclasses.fields(jl):
        np.testing.assert_array_equal(getattr(tl, f.name), getattr(jl, f.name))
    rng = np.random.default_rng(9)
    payload = rng.uniform(-1, 1, N).astype(np.float32)
    scale = rng.uniform(0.95, 1.05, N).astype(np.float32)
    ji, jm = jengine.make_inertias(model, payload=jnp.asarray(payload),
                                   link_mass_scale=jnp.asarray(scale), num_envs=N)
    ti, tm = tengine.make_inertias(tmodel, payload=torch.from_numpy(payload),
                                   link_mass_scale=torch.from_numpy(scale),
                                   num_envs=N, device="cpu")
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)

    phys = arrays["phys"]
    jstate = {k: jnp.asarray(v) for k, v in phys.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in phys.items()}
    jk = jquad.fk(model, jl, jstate)
    tk = tquad.fk(tmodel, tl, tstate)
    for k in ("R", "x", "v"):
        np.testing.assert_allclose(tk[k].numpy(), np.asarray(jk[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    f_ext = rng.normal(0, 20.0, (model.nb, 6, N)).astype(np.float32)
    tau = rng.normal(0, 5.0, (12, N)).astype(np.float32)
    jq, ja = jquad.aba(model, jl, ji, jk, jstate["qd"], jnp.asarray(tau),
                       jnp.asarray(f_ext), task.sim)
    tq, ta = tquad.aba(tmodel, tl, ti, tk, tstate["qd"], torch.from_numpy(tau),
                       torch.from_numpy(f_ext), sim)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)


def _window_terrains(case):
    """The window variant's inputs: the window copy, and rows 16..56 of the
    patch copy's table 0 (a strided view)."""
    arrays = case[3]
    blocks = torch.from_numpy(np.array(arrays["blocks"]))
    starts = torch.from_numpy(np.array(arrays["starts"]))
    return {"window copy": cuda_patch.extract_windows_plain(blocks, starts),
            "patch view": cuda_patch.extract_patches_plain(
                blocks, starts)[0][:, 16:56]}


@pytest.mark.parametrize("source", ["window copy", "patch view"])
def test_window_variant_equals_fused_bitwise(case, source):
    window = _window_terrains(case)[source]
    fused = _port_step(case, tsub.decimation_step_plain)
    got = _port_step(case, tsub.decimation_step, dict(window=window))
    for a, b in zip(_torch_leaves(got), _torch_leaves(fused)):
        np.testing.assert_array_equal(a, b)


def _torch_leaves(step):
    phys, anchors, info = step
    return ([phys[k].numpy() for k in sorted(phys)] + [anchors.numpy()]
            + [info[k].numpy() for k in sorted(info)])


def test_window_variant_matches_pallas_kernel(case, window_want):
    window = _window_terrains(case)["window copy"]
    _assert_step_matches(
        _port_step(case, tsub.decimation_step_plain, dict(window=window)),
        window_want)
    # the JAX package's two variants agree bit for bit as well
    for a, b in zip(_jax_leaves(window_want), _jax_leaves(case[6])):
        np.testing.assert_array_equal(a, b)


def _jax_leaves(step):
    phys, anchors, info = step
    return ([np.asarray(phys[k]) for k in sorted(phys)] + [np.asarray(anchors)]
            + [np.asarray(info[k]) for k in sorted(info)])


@pytest.fixture(scope="module", params=["standing", "body contact"])
def sim_case(request, case):
    """One decimation of sim_step in both packages from the case's state,
    every point sampling the raw patch through terrain_fn.  "body contact"
    lowers each base 0.2 m and rolls it, so that thigh and shank points
    touch the terrain."""
    model, geom, task, arrays, common, hs, *_ = case
    phys = {k: v.copy() for k, v in arrays["phys"].items()}
    if request.param == "body contact":
        phys["pos"][2] -= 0.2
        roll = np.float32(0.35)
        q = np.zeros_like(phys["quat"])
        q[0], q[3] = np.sin(roll / 2), np.cos(roll / 2)
        phys["quat"] = q
    rng = np.random.default_rng(7)
    taus = rng.normal(0, 5.0, (DECIM, 12, N)).astype(np.float32)
    blocks, starts = arrays["blocks"], arrays["starts"]
    jsrc = jpatch.PatchSource(blocks=jnp.asarray(blocks), blocks16=None,
                              n_blocks=blocks.shape[1],
                              n_rows=blocks.shape[2] - 80,
                              horizontal_scale=hs, border_size=4.0)
    jpatches = jpatch.extract(jsrc, jnp.asarray(starts))
    worigin = arrays["win_origin"]
    origin = (worigin.T - hs * np.float32([jsub.WIN_R0, jsub.WIN_C0])).astype(
        np.float32)

    def jterrain(x, y):
        h, dx, dy, hm = jpatch.sample_bilinear_slope(
            jpatches[0], jnp.asarray(origin), hs, x.T, y.T)
        return h.T, dx.T, dy.T, hm.T
    jstate = {k: jnp.asarray(v) for k, v in phys.items()}
    janchors = jnp.asarray(arrays["anchors"])
    for tau in taus:
        jstate, janchors, jinfo = jsim.sim_step(
            model, geom, task.sim, jnp.asarray(arrays["inertias"]), jstate,
            janchors, jnp.asarray(tau), jterrain,
            jnp.asarray(arrays["friction"]), jnp.asarray(arrays["restitution"]))

    tmodel = tquadrupeds.get_robot("lite3")
    tgeom = tsim.default_contact_geometry(tmodel)
    sim = tconfig.SimParams(**dataclasses.asdict(task.sim))
    tpatches = cuda_patch.extract_patches_plain(
        torch.from_numpy(np.array(blocks)), torch.from_numpy(np.array(starts)))
    torigin = torch.from_numpy(origin)

    def tterrain(x, y):
        h, dx, dy, hm = tpatch.sample_bilinear_slope(tpatches[0], torigin, hs,
                                                     x.T, y.T)
        return h.T, dx.T, dy.T, hm.T
    tstate = {k: torch.from_numpy(v.copy()) for k, v in phys.items()}
    t = {k: torch.from_numpy(np.array(arrays[k])) for k in
         ("anchors", "inertias", "friction", "restitution")}
    tanchors = t["anchors"]
    for tau in taus:
        tstate, tanchors, tinfo = tsim.sim_step(
            tmodel, tgeom, sim, t["inertias"], tstate, tanchors,
            torch.from_numpy(tau), tterrain, t["friction"], t["restitution"])
    return request.param, (jstate, janchors, jinfo), (tstate, tanchors, tinfo)


def test_sim_step_matches_jax(sim_case):
    name, (jstate, janchors, jinfo), (tstate, tanchors, tinfo) = sim_case
    for k in ("pos", "quat", "lin_vel", "ang_vel", "q", "qd"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   **TIGHT, err_msg=k)
    np.testing.assert_allclose(tanchors.numpy(), np.asarray(janchors), **TIGHT)
    for k in ("foot_pos", "foot_vel"):
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                   **TIGHT, err_msg=k)
    for k in ("R", "x", "v"):
        np.testing.assert_allclose(tinfo["kin"][k].numpy(),
                                   np.asarray(jinfo["kin"][k]), **TIGHT,
                                   err_msg=k)
    cf = np.asarray(jinfo["contact_forces"])
    np.testing.assert_allclose(tinfo["contact_forces"].numpy(), cf,
                               atol=1e-3, rtol=1e-5)
    # the feet carry load; with the base lowered, thigh/shank bodies too
    assert np.abs(cf[[4, 8, 12, 16]]).max() > 1.0
    legs = np.abs(cf[[2, 3, 6, 7, 10, 11, 14, 15]]).max()
    assert (legs > 1.0) == (name == "body contact"), legs


@pytest.mark.parametrize("robot", ["lite3", "x30"])
def test_point_owners_follow_the_legs(robot):
    """The decimation kernel's owner table: a point on a leg goes to that
    leg's lane with its body's depth in the chain (the JAX package's
    contact geometry says which body), the torso's points go to the lanes
    in turn, the feet are leg points; a foot on the torso is refused."""
    jgeom = jsim.default_contact_geometry(quadrupeds.get_robot(robot))
    model = tquadrupeds.get_robot(robot)
    geom = tsim.default_contact_geometry(model)
    layout = tquad.quad_layout(model)
    owner = tsub.point_owners(layout, geom)
    torso = 0
    for p, b in enumerate(np.asarray(jgeom.dyn_idx)):
        leg, depth = owner[p] % tsub.LANES, owner[p] // tsub.LANES - 1
        if b == 0:
            assert (leg, depth) == (torso % tsub.LANES, -1), p
            torso += 1
        else:
            assert layout.body_idx[depth, leg] == b, p
    assert torso == 8 and (owner[:4] >= tsub.LANES).all()
    consts = tsub.pack_constants(model, geom, tengine.SimParams(),
                                 [2, 5, 8, 11], 0.1)
    P = len(geom.dyn_idx)
    assert consts.shape == (tsub.C_PTS + 8 * P,)
    np.testing.assert_array_equal(consts[tsub.C_PTS + 7 * P:], owner)
    bad = dataclasses.replace(geom, dyn_idx=np.r_[0, geom.dyn_idx[1:]])
    with pytest.raises(ValueError):
        tsub.point_owners(layout, bad)


def test_launch_shape_covers_the_card():
    """Four lanes an env, 32 envs a block: at the published 4096 envs 128
    blocks, one for each of 128 of the H100's 132 SMs."""
    assert tsub.launch_shape(4096) == (128, 128, 32)
    assert tsub.launch_shape(37) == (2, 128, 32)
    assert tsub.launch_shape(1) == (1, 128, 32)
