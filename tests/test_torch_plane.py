"""The port's plane task and grid queries against the JAX package.

lite3_fast steps a plane: no blocked tables, so in both packages the
physics is the plain decimation loop over `sim_step` with the flat grid's
`height_and_slope` as the terrain function (the JAX package's XLA path),
zero height scans, no planner (45-dim obs), the non-DTC termination, and
origins on the env_spacing grid with no reset offset.  Two policy steps
from one state at the recipe and budgets of tests/test_torch_tasks.py;
the port's init and a masked reset against the JAX env's, fed its draws.

The grid queries of terrain/grid.py (`height_and_slope`, `height_min3`,
`height_max10`) against the JAX package's on seeded points over a
heightfield (inside it, across its edges and outside it) and over a flat
grid: the nearest samples exact, the bilinear height 1e-6 and the slopes
1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.config import TerrainCfg as JTerrainCfg
from deep_tracking_control_tpu.terrain import grid as jgrid
from deep_tracking_control_tpu.terrain.generator import Terrain
from deep_tracking_control_tpu_torch.env.legged_env import LeggedEnv as TEnv
from deep_tracking_control_tpu_torch.tasks import registry as treg
from deep_tracking_control_tpu_torch.terrain import grid as tgrid
from tests.test_torch_tasks import (check_done_and_metrics,
                                    check_init_and_reset, check_physics,
                                    check_terrain_and_plan, init_and_reset,
                                    tiny, two_steps)
from tests.xdist_once import once


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the tensors are tiny; parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane_steps():
    """two_steps of lite3_fast without its env objects (so that it
    pickles): the JAX grid's facts that test_plane_world reads instead."""
    r = two_steps("lite3_fast")
    g = r.pop("jenv").grid
    r.pop("tenv")
    return dict(r, jgrid=(g.is_plane, tuple(g.height.shape), g.border_size))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two steps (once a test session: tests/xdist_once.py; the
    outputs are checked in tests/test_torch_plane_outputs.py) and the
    port's env of the task."""
    return dict(once(tmp_path_factory, "torch_plane_steps", _plane_steps),
                tenv=TEnv(tiny(treg, "lite3_fast")[0], device="cpu"))


@pytest.mark.parametrize("t", [0, 1])
def test_plane_physics_state(run, t):
    check_physics(run, t)


@pytest.mark.parametrize("t", [0, 1])
def test_plane_terrain_queries(run, t):
    check_terrain_and_plan(run, t)
    ts = run["tstates"][t]
    assert not ts["measured_heights"].any() and not ts["foothold_obs"].any()
    # the foot clearance is the foot height, with no terrain under it
    assert not run["tenv"].cfg.terrain.measure_foot_clearance


@pytest.mark.parametrize("t", [0, 1])
def test_plane_done_and_metrics(run, t):
    check_done_and_metrics(run, t)


def test_plane_world(run):
    """No tables and no tile origins; levels and types 0; N origins on the
    env_spacing grid (2 x 2 at 1 m); the flat grid 2 x border_size wide."""
    tenv = run["tenv"]
    assert tenv.patch_src is None and tenv.terrain_origins is None
    assert not tenv._kernel_physics
    js = run["jstates"][0]
    np.testing.assert_array_equal(js["env_origins"],
                                  [[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]])
    ts = run["tstates"][0]
    assert not ts["terrain_levels"].any() and not ts["terrain_types"].any()
    assert run["jgrid"] == (True, tuple(tenv.grid.height.shape),
                            tenv.grid.border_size)
    assert tenv.grid.is_plane


def test_plane_init_and_reset():
    """The port's own init and a masked reset on the plane against the
    JAX env's, fed its draws: origins on the env_spacing grid, levels and
    types 0 and untouched by the (disabled) curriculum, each reset base on
    its origin at the initial height (no xy offset)."""
    r = init_and_reset("lite3_fast")
    check_init_and_reset(r)
    assert r["tenv"].terrain is None
    for stage in ("init", "reset"):
        got = r["t" + stage]
        assert not got["terrain_levels"].any()
        assert not got["terrain_types"].any()
        pos = got["phys"]["pos"].T.numpy()
        keep = slice(None) if stage == "init" else r["done"]
        np.testing.assert_array_equal(pos[keep, :2],
                                      got["env_origins"][keep, :2].numpy())
    # 7 envs: floor(sqrt(7)) = 2 columns, 4 rows, the last cut short
    np.testing.assert_array_equal(
        r["tinit"]["env_origins"][:, :2].numpy(),
        [[0, 0], [0, 1], [1, 0], [1, 1], [2, 0], [2, 1], [3, 0]])


@pytest.fixture(scope="module")
def grids():
    """A 2x2-tile heightfield at 0.05 m and a 4 m flat grid, in both
    packages."""
    tcfg = JTerrainCfg(num_rows=2, num_cols=2, border_size=4.0)
    height = Terrain(tcfg, seed=3, backend="python").heights_meters()
    hs, border = tcfg.horizontal_scale, tcfg.border_size
    return {
        "heightfield": (
            jgrid.TerrainGrid(jnp.asarray(height), hs, border, False),
            tgrid.TerrainGrid(torch.from_numpy(np.array(height)), hs, border,
                              False)),
        "plane": (jgrid.flat_grid(4.0, hs),
                  tgrid.flat_grid(4.0, hs, device="cpu")),
    }


@pytest.mark.parametrize("kind", ["heightfield", "plane"])
def test_grid_queries_match_jax(grids, kind):
    jg, tg = grids[kind]
    assert tuple(tg.height.shape) == tuple(jg.height.shape)
    assert tg.border_size == jg.border_size and tg.is_plane == jg.is_plane
    extent = jg.height.shape[0] * jg.horizontal_scale
    rng = np.random.default_rng(11)
    # inside, across the edges and outside the grid
    lo, hi = -jg.border_size - 1.0, extent - jg.border_size + 1.0
    x = rng.uniform(lo, hi, (64, 5)).astype(np.float32)
    y = rng.uniform(lo, hi, (64, 5)).astype(np.float32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = jgrid.height_and_slope(jg, jx, jy)
    got = tgrid.height_and_slope(tg, tx, ty)
    for name, g, w, tol in zip(("h", "dhdx", "dhdy", "h_max"), got, want,
                               (1e-6, 1e-5, 1e-5, 0.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=0, err_msg=name)
    for fn in ("height_min3", "height_max10"):
        np.testing.assert_array_equal(
            getattr(tgrid, fn)(tg, tx, ty).numpy(),
            np.asarray(getattr(jgrid, fn)(jg, jx, jy)), err_msg=fn)
    if kind == "heightfield":
        # the heightfield case reads real relief: the queries vary
        assert np.ptp(got[0].numpy()) > 0.05
        assert (np.abs(got[1].numpy()) > 0).any()
