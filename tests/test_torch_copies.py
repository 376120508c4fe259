"""The torch port's copies of the framework-free modules, and its hygiene.

robot/model.py, robot/quadrupeds.py, terrain/generator.py, the native
terrain generator (native/terrain_gen.cpp and its ctypes binding),
env/config.py, tasks/registry.py, utils/cli.py, the switch reader of
utils/flags.py and the numpy-only utils (logger, debug_viz, render_anim,
viewer3d) are copied into the port (which must not import the JAX
package); each copy must stay equal to its original, and viewer3d's numpy
FK to the port's physics FK.  The port itself imports neither jax, flax,
optax, orbax nor triton, and its modules are all imported here, the
training ones included (agent/ppo.py, ops/cuda_gather.py, runner/,
scripts/).
"""
import dataclasses
import inspect
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from deep_tracking_control_tpu import native as jnative
from deep_tracking_control_tpu.env import config as jconfig
from deep_tracking_control_tpu.physics import engine as jengine
from deep_tracking_control_tpu.physics import sim as jsim
from deep_tracking_control_tpu.robot import quadrupeds as jrobots
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu.terrain import generator as jgen
from deep_tracking_control_tpu.utils import cli as jcli
from deep_tracking_control_tpu.utils import flags as jflags
from deep_tracking_control_tpu_torch import native as tnative
from deep_tracking_control_tpu_torch.env import config as tconfig
from deep_tracking_control_tpu_torch.physics import sim as tsim
from deep_tracking_control_tpu_torch.robot import quadrupeds as trobots
from deep_tracking_control_tpu_torch.tasks import registry as treg
from deep_tracking_control_tpu_torch.terrain import generator as tgen
from deep_tracking_control_tpu_torch.utils import cli as tcli
from deep_tracking_control_tpu_torch.utils import flags as tflags
from deep_tracking_control_tpu_torch.utils import viewer3d as tviewer3d

PORT = pathlib.Path(__file__).resolve().parents[1] / "deep_tracking_control_tpu_torch"


@pytest.mark.parametrize("task", jreg.task_names())
def test_task_configs_equal(task):
    assert treg.task_names() == jreg.task_names()
    jt, jtr = jreg.get_cfgs(task)
    tt, ttr = treg.get_cfgs(task)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert dataclasses.asdict(ttr) == dataclasses.asdict(jtr)


def test_sim_params_and_defaults_equal():
    assert (dataclasses.asdict(tconfig.SimParams())
            == dataclasses.asdict(jengine.SimParams()))
    assert (dataclasses.asdict(tconfig.TaskCfg())
            == dataclasses.asdict(jconfig.TaskCfg()))
    assert (dataclasses.asdict(tconfig.TrainCfg())
            == dataclasses.asdict(jconfig.TrainCfg()))


@pytest.mark.parametrize("robot", ["lite3", "x30"])
def test_robot_tables_equal(robot):
    jm, tm = jrobots.get_robot(robot), trobots.get_robot(robot)
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert b == a, f.name
    jg, tg = jsim.default_contact_geometry(jm), tsim.default_contact_geometry(tm)
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(getattr(tg, f.name), getattr(jg, f.name))


@pytest.mark.parametrize("seed", [3, 11])
def test_python_terrain_equal(seed):
    cfg = tconfig.TerrainCfg(num_rows=3, num_cols=3, border_size=4.0)
    jcfg = jconfig.TerrainCfg(num_rows=3, num_cols=3, border_size=4.0)
    jt = jgen.Terrain(jcfg, seed=seed, backend="python")
    tt = tgen.Terrain(cfg, seed=seed, backend="python")
    assert tt.backend == "python"
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    np.testing.assert_array_equal(tt.heights_meters(), jt.heights_meters())
    assert tgen.column_families(cfg) == jgen.column_families(jcfg)


def _jax_native_ready(timeout=60.0):
    """The JAX package builds its library next to its source at first use,
    and another test process may be writing it right now: wait until it
    loads."""
    t0 = time.monotonic()
    while not jnative.available():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.5)
    return True


def test_native_sources_equal():
    jdir = pathlib.Path(jnative.__file__).parent
    assert ((PORT / "native" / "terrain_gen.cpp").read_bytes()
            == (jdir / "terrain_gen.cpp").read_bytes())
    assert (inspect.getsource(tnative.generate_terrain)
            == inspect.getsource(jnative.generate_terrain))
    assert tnative.CXX_FLAGS == ["-O2", "-shared", "-fPIC"]
    # the port builds its own library into its _build/, never the JAX one
    assert tnative.library_path().parent == PORT / "_build"


@pytest.mark.parametrize("case", [("small", 3), ("small", 11),
                                  ("lite3_dtc", 1)])
def test_native_terrain_equal(case):
    """The port's `Terrain` with its default backend builds the JAX
    package's native world bit for bit: two seeds of a small world, and
    lite3_dtc's own terrain at terrain_seed=1."""
    name, seed = case
    if name == "small":
        cfg = tconfig.TerrainCfg(num_rows=3, num_cols=4, border_size=4.0)
        jcfg = jconfig.TerrainCfg(num_rows=3, num_cols=4, border_size=4.0)
    else:
        cfg = treg.get_cfgs(name)[0].terrain
        jcfg = jreg.get_cfgs(name)[0].terrain
    assert _jax_native_ready()
    jt = jgen.Terrain(jcfg, seed=seed)
    tt = tgen.Terrain(cfg, seed=seed)
    assert (tt.backend, jt.backend) == ("native", "native")
    np.testing.assert_array_equal(tt.height_field_raw, jt.height_field_raw)
    np.testing.assert_array_equal(tt.env_origins, jt.env_origins)
    # another seed is another world
    other = tgen.Terrain(cfg, seed=seed + 1)
    assert not np.array_equal(other.height_field_raw, tt.height_field_raw)


def test_terrain_backend_choice():
    """"auto" picks the native generator, selected mode the Python one on
    both sides, and "native" in selected mode raises on both."""
    assert _jax_native_ready()
    kw = dict(num_rows=2, num_cols=2, border_size=4.0)
    stairs = (("step_width", 0.31), ("step_height", 0.05))
    selected = []
    for gen, config in ((jgen, jconfig), (tgen, tconfig)):
        assert gen.Terrain(config.TerrainCfg(**kw), seed=2).backend == "native"
        sel = config.TerrainCfg(selected=True, selected_terrain_kwargs=stairs,
                                **kw)
        selected.append(gen.Terrain(sel, seed=2))
        assert selected[-1].backend == "python"
        with pytest.raises(RuntimeError):
            gen.Terrain(sel, seed=2, backend="native")
    np.testing.assert_array_equal(selected[1].height_field_raw,
                                  selected[0].height_field_raw)
    assert selected[1].height_field_raw.any()


@pytest.mark.parametrize("argv", [[], ["--task", "lite3_dtc", "--num_envs", "16",
                                       "--seed", "3", "--max_iterations", "2",
                                       "--resume", "--load_run", "r1",
                                       "--checkpoint", "50", "--run_name", "x",
                                       "--experiment_name", "e"]])
def test_cli_equal(argv):
    for fn in ("get_args", "update_cfg_from_args"):
        assert (inspect.getsource(getattr(tcli, fn))
                == inspect.getsource(getattr(jcli, fn))), fn
    ja, ta = jcli.get_args(argv), tcli.get_args(argv)
    assert vars(ta) == vars(ja)
    jt = jcli.update_cfg_from_args(*jreg.get_cfgs(ja.task), ja)
    tt = tcli.update_cfg_from_args(*treg.get_cfgs(ta.task), ta)
    assert [dataclasses.asdict(c) for c in tt] == [dataclasses.asdict(c)
                                                   for c in jt]


def test_port_imports_no_jax_or_triton():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deep_tracking_control_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'triton',\n"
        "              'deep_tracking_control_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PORT.parent, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|triton"
                     r"|deep_tracking_control_tpu\b(?!_torch))|pallas.*import"
                     r"|import.*pallas", re.M)
    for path in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py"]:
        m = bad.search(path.read_text())
        assert m is None, f"{path.name}: {m.group(0)!r}"


@pytest.mark.parametrize("strict", ["0", "1", None])
@pytest.mark.parametrize("value", [None, "0", "1", "yes"])
def test_kernel_flag_equal(monkeypatch, strict, value):
    for name, v in (("DTC_STRICT_PARITY", strict), ("DTC_FUSED_WINDOW", value)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    assert tflags.strict_parity() == jflags.strict_parity()
    for default in ("0", "1"):
        assert (tflags.kernel_flag("DTC_FUSED_WINDOW", default)
                == jflags.kernel_flag("DTC_FUSED_WINDOW", default))
    assert (inspect.getsource(tflags.kernel_flag)
            == inspect.getsource(jflags.kernel_flag))


IMPORT = re.compile(r"\s*(import|from)\s+\S+(\s+import\b|\s*$|\s+as\b)")


def _without_imports(text):
    return [line for line in text.splitlines() if not IMPORT.match(line)]


@pytest.mark.parametrize("name", ["logger", "debug_viz", "render_anim",
                                  "viewer3d"])
def test_utils_copies_equal(name):
    """The numpy-only utils are the JAX package's, line for line apart
    from their imports."""
    jdir = pathlib.Path(jcli.__file__).parent
    want = (jdir / f"{name}.py").read_text()
    got = (PORT / "utils" / f"{name}.py").read_text()
    assert _without_imports(got) == _without_imports(want)


@pytest.mark.parametrize("robot", ["lite3", "three_leg"])
def test_viewer3d_fk_matches_generic_fk(robot, tmp_path):
    """viewer3d's numpy FK, a mirror of the JAX engine's generic fk, equals
    the port's generic engine.fk (body origins, orientations and the
    welded feet) on Lite3 and on a three-legged robot (Lite3's URDF
    without its HR_ leg, chip_smoke.three_leg_urdf), as
    tests/test_viewer3d.py holds it to the JAX engine's."""
    import torch
    from chip_smoke import three_leg_urdf
    from deep_tracking_control_tpu_torch.physics import engine
    from deep_tracking_control_tpu_torch.robot.model import load_urdf
    model = (load_urdf(three_leg_urdf(str(tmp_path / "three_leg.urdf")))
             if robot == "three_leg" else trobots.get_robot(robot))
    rng = np.random.default_rng(3)
    for _ in range(3):
        pos = np.array([1.0, 2.0, 0.4]) + rng.normal(scale=0.1, size=3)
        q4 = rng.normal(size=4)
        q4 /= np.linalg.norm(q4)
        q = rng.uniform(model.pos_limit[:, 0], model.pos_limit[:, 1])
        x_np, R_np = tviewer3d.fk_positions(model, pos, q4, q)
        feet_np = tviewer3d.foot_positions_from_fk(model, x_np, R_np)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.float32))[:, None]
        state = engine.make_state(col(pos), col(q4), torch.zeros(3, 1),
                                  torch.zeros(3, 1), col(q),
                                  torch.zeros(model.nq, 1))
        kin = engine.fk(model, state)
        np.testing.assert_allclose(x_np, kin["x"][..., 0].numpy(), atol=2e-5)
        np.testing.assert_allclose(R_np, kin["R"][..., 0].numpy(), atol=2e-5)
        fpos, _ = engine.body_point_state(kin, model.foot_dyn_index,
                                          model.foot_offset)
        assert fpos.shape[0] == len(model.foot_body_index)
        np.testing.assert_allclose(feet_np, fpos[..., 0].numpy(), atol=2e-5)


@pytest.mark.parametrize("robot", ["lite3", "x30"])
def test_viewer3d_fk_matches_port_fk(robot):
    """viewer3d's numpy FK (body origins and orientations, and the welded
    feet) equals the port's physics FK (physics/quadruped.py `fk`, the
    feet through engine.body_point_state), as tests/test_viewer3d.py holds
    it to the JAX engine's."""
    import torch
    from deep_tracking_control_tpu_torch.physics import engine, quadruped
    model = trobots.get_robot(robot)
    layout = quadruped.quad_layout(model)
    rng = np.random.default_rng(3)
    for _ in range(3):
        pos = np.array([1.0, 2.0, 0.4]) + rng.normal(scale=0.1, size=3)
        q4 = rng.normal(size=4)
        q4 /= np.linalg.norm(q4)
        q = rng.uniform(model.pos_limit[:, 0], model.pos_limit[:, 1])
        x_np, R_np = tviewer3d.fk_positions(model, pos, q4, q)
        feet_np = tviewer3d.foot_positions_from_fk(model, x_np, R_np)

        def col(a):
            return torch.as_tensor(np.asarray(a, np.float32))[:, None]
        state = engine.make_state(col(pos), col(q4), torch.zeros(3, 1),
                                  torch.zeros(3, 1), col(q),
                                  torch.zeros(model.nq, 1))
        kin = quadruped.fk(model, layout, state)
        np.testing.assert_allclose(x_np, kin["x"][..., 0].numpy(), atol=2e-5)
        np.testing.assert_allclose(R_np, kin["R"][..., 0].numpy(), atol=2e-5)
        fpos, _ = engine.body_point_state(kin, model.foot_dyn_index,
                                          model.foot_offset)
        np.testing.assert_allclose(feet_np, fpos[..., 0].numpy(), atol=2e-5)
