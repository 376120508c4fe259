"""How far float32 resolves one physics step of a task, on the CPU.

Runs `num_envs` envs of the port's env for three steps (random actions,
seed 0), records the physics kernel's inputs of the last step, and runs
that step four ways: the JAX package's Pallas kernel in interpret mode in
float32 and, its source read with float64 for float32, in float64; the
port's plain version in float32 and in float64.  For each output it
prints, against the budget chip_smoke.py holds the card's kernel to (atol
1e-4, rtol 1e-4; contact forces atol 1e-2):

- float64: the largest departure of the two float64 runs from each other,
  in budgets;
- beyond: elements where the two float32 versions part by more than it;
- single-run rule: elements failing "within the budget of the plain
  version or, where the plain version departs from its float64 run by
  more than it, no farther from that run than the plain version plus one
  budget";
- off: elements where each float32 version departs from its own float64
  run by more than the budget, and whether chip_smoke.check_float_build
  passes the JAX kernel on them;
- quantiles of the plain float32 version's departure from its float64
  run, in budgets.

The JAX kernel stands where the card's kernel stands in chip_smoke.py: a
second float32 version of the same arithmetic.

    JAX_PLATFORMS=cpu python -m tests.k1_float32_resolution x30_rough 256
"""
import argparse
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from chip_smoke import check_float_build, plain_float64
from deep_tracking_control_tpu.physics import pallas_substep as jsub
from deep_tracking_control_tpu.physics import sim as jsim
from deep_tracking_control_tpu.robot import quadrupeds as jquadrupeds
from deep_tracking_control_tpu.tasks import registry as jreg
from deep_tracking_control_tpu_torch.env import legged_env
from deep_tracking_control_tpu_torch.physics import cuda_substep
from deep_tracking_control_tpu_torch.tasks import registry as treg


def recorded_step(name, num_envs):
    task, _ = treg.get_cfgs(name)
    task = dataclasses.replace(
        task, env=dataclasses.replace(task.env, num_envs=num_envs))
    env = legged_env.LeggedEnv(task, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params, state = env.init(gen)
    calls = {}
    kernel = cuda_substep.decimation_step

    def record(*args, **kwargs):
        calls["step"] = (args, kwargs)
        return kernel(*args, **kwargs)
    cuda_substep.decimation_step = record
    try:
        for _ in range(3):
            actions = 0.3 * torch.randn((num_envs, env.num_actions),
                                        generator=gen)
            state, _ = env.step(params, state, actions, gen)
    finally:
        cuda_substep.decimation_step = kernel
    args, kwargs = calls["step"]
    return args, {k: v for k, v in kwargs.items() if k != "consts"}


class _Float64Numpy:
    """jax.numpy with float32 read as float64 (the kernel's dtypes)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def jax_step(name, args, wide=False):
    """The JAX package's kernel (interpret mode) on the port's inputs; in
    float64 where `wide` (the terrain blocks stay float32 values)."""
    task, _ = jreg.get_cfgs(name)
    model = jquadrupeds.get_robot(task.asset.robot)
    geom = jsim.default_contact_geometry(model)
    dtype = jnp.float64 if wide else jnp.float32

    def j(x):
        if isinstance(x, dict):
            return {k: j(v) for k, v in x.items()}
        if not isinstance(x, torch.Tensor):
            return x
        a = x.numpy()
        return jnp.asarray(a, dtype) if a.dtype == np.float32 else a

    def run():
        a = [j(x) for x in args]
        return jsub.decimation_step(
            model, geom, task.sim, args[3], np.asarray(args[4]), *a[5:15],
            None, a[15], a[16], args[17], interpret=True, blocks=a[18],
            starts=jnp.asarray(a[19]))
    if not wide:
        return run()
    kernel_numpy = jsub.jnp
    with jax.enable_x64(True):
        jsub.jnp = _Float64Numpy()
        try:
            return jax.tree.map(np.asarray, run())
        finally:
            jsub.jnp = kernel_numpy


def flat(out):
    phys, anchors, info = out
    d = {**phys, "anchors": anchors, **info}
    return {k: torch.as_tensor(np.array(v)).double() for k, v in d.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("task")
    ap.add_argument("num_envs", type=int)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    args, kw = recorded_step(a.task, a.num_envs)
    plain = cuda_substep.decimation_step_plain
    mine, mine64 = flat(plain(*args, **kw)), flat(plain_float64(plain, args,
                                                                kw))
    other, other64 = flat(jax_step(a.task, args)), flat(jax_step(a.task, args,
                                                                 wide=True))
    print(f"{a.task}, {a.num_envs} envs: the JAX kernel (interpret) against "
          f"the port's plain version, each in float32 and in float64")
    for k in other:
        atol = 1e-2 if k == "contact_forces" else 1e-4
        got, want, d = other[k], mine[k], mine64[k]
        budget = atol + 1e-4 * d.abs()
        wide = float(((other64[k] - d).abs() / budget).max())
        near = (got - want).abs() <= atol + 1e-4 * want.abs()
        e_got, e_one = (got - d).abs(), (want - d).abs()
        one = near | ((e_one > budget) & (e_got <= e_one + budget))
        try:
            _, off_got, off_want = check_float_build(
                k, got, other64[k], want, d, atol, 1e-4)
            verdict = "passes"
        except AssertionError:
            off_got = int(((got - other64[k]).abs() > atol
                           + 1e-4 * other64[k].abs()).sum())
            off_want = int((e_one > budget).sum())
            verdict = "FAILS"
        q = np.quantile((e_one / budget).numpy(), [0.5, 0.9, 0.99, 1.0])
        print(f"{k:15s} {got.numel():6d} elements: float64 {wide:.4f}; "
              f"beyond {int((~near).sum())}, single-run rule fails "
              f"{int((~one).sum())}; off JAX {off_got} port {off_want} "
              f"(check_float_build {verdict}); plain float32 from float64 "
              f"in budgets: median {q[0]:.3f}, p90 {q[1]:.3f}, p99 "
              f"{q[2]:.3f}, max {q[3]:.3f}")


if __name__ == "__main__":
    main()
