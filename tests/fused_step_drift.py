"""How far the fused first update lands from the sequential one, against
the update's size, in the port and in the JAX package, on one batch.

    JAX_PLATFORMS=cpu python -m tests.fused_step_drift [NUM_ENVS]

One lite3_dtc collect of the port at NUM_ENVS envs (default 8; the A/B
scripts' configs, the registry's net widths), acting with weights drawn
by flax (key 0) and carried over by params_from_flax.  From those
weights and that batch, each package's sequential and fused update at
the schedule of the JAX package's
tests/test_ppo.py::test_fused_joint_step_close_to_sequential (2 epochs x
2 minibatches) and at the registry's (5 x 4), both packages on the
same draws: the JAX update's shuffle and latent noise, made from its key
as agent/ppo.py makes them and handed to the port.  Prints, per package
and schedule, |p_fused - p_seq| / |p_seq - p0| (L2 over all params; that
test holds it under 0.5 at its tiny net) and how far each package's
sequential update lands from the other's.  CPU only: a few minutes, the
JAX updates jitted at the registry's widths.
"""
import dataclasses
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.agent import ppo as jppo
from deep_tracking_control_tpu.models import networks as jnet
from deep_tracking_control_tpu_torch.agent.ppo import PPO, shuffle_layout
from deep_tracking_control_tpu_torch.convert import params_from_flax
from deep_tracking_control_tpu_torch.scripts import ab_common, ab_fused_step

SCHEDULES = ((2, 2), (5, 4))
KEY = 5


def jax_draws(alg, T, N, z_dim, key):
    """The JAX update's draws from `key` (agent/ppo.py): the group
    permutation(s) from k_perm; per minibatch step, k_vae and k_pol from
    split(k_upd, steps)[i], each a (minibatch rows, z_dim) normal."""
    S, rows_s, _, G = shuffle_layout(alg, T, N)
    k_perm, k_upd = jax.random.split(key)
    if S == 1:
        perm = jax.random.permutation(k_perm, T * N // G)[None]
    else:
        perm = jax.vmap(lambda k: jax.random.permutation(k, rows_s // G))(
            jax.random.split(k_perm, S))
    steps = alg.num_learning_epochs * alg.num_mini_batches
    mb = T * N // alg.num_mini_batches
    eps = np.stack([
        np.stack([np.asarray(jax.random.normal(k, (mb, z_dim), jnp.float32))
                  for k in jax.random.split(ks)])
        for ks in jax.random.split(k_upd, steps)])
    return (torch.from_numpy(np.asarray(perm).astype(np.int64)),
            torch.from_numpy(eps))


def main(num_envs=8):
    task_cfg, train_cfg = ab_fused_step.variant_cfgs(True, num_envs)
    runner = ab_common.variant_runner(task_cfg, train_cfg, "cpu", None, None)
    pol = train_cfg.policy
    jm = jnet.ActorCriticDecoder(
        actor_hidden=tuple(pol.actor_hidden_dims),
        critic_hidden=tuple(pol.critic_hidden_dims),
        terrain_latent=pol.terrain_latent, z_dim=pol.cenet_latent,
        init_noise_std=pol.init_noise_std, activation=pol.activation,
        outlier_filter=pol.outlier_filter)
    env = runner.env
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, env.num_obs)),
        jnp.zeros((1, env.num_obs_history)),
        jnp.zeros((1, env.num_privileged_obs)), jnp.zeros((1, 3)),
        jax.random.PRNGKey(1))
    p0 = params_from_flax(jax.tree.map(np.asarray, params))
    runner.net.load_state_dict(p0)
    batch, _ = runner.collect()
    jbatch = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16
                             if v.dtype == torch.bfloat16 else jnp.float32)
              for k, v in batch.items()}

    def flat(tree):
        return torch.cat([tree[n].reshape(-1).float() for n in sorted(p0)])

    for epochs, minibatches in SCHEDULES:
        alg = dataclasses.replace(train_cfg.algorithm,
                                  num_learning_epochs=epochs,
                                  num_mini_batches=minibatches)
        port, ref = {}, {}
        T, N = batch["obs"].shape[:2]
        for fused in ab_fused_step.VARIANTS:
            a = dataclasses.replace(alg, fused_joint_step=fused)
            perm, eps = jax_draws(a, T, N, pol.cenet_latent,
                                  jax.random.PRNGKey(KEY))
            runner.net.load_state_dict(p0)
            PPO(net=runner.net, alg=a).update(batch, perm=perm, eps=eps)
            port[fused] = flat(runner.net.state_dict())
            main_opt, vae_opt = jppo.make_optimizers(a)
            out = jax.jit(jppo.PPO(net=jm, alg=a).update)(
                params, main_opt.init(params), vae_opt.init(params),
                jnp.asarray(a.learning_rate), jbatch, jax.random.PRNGKey(KEY))
            ref[fused] = flat(params_from_flax(jax.tree.map(np.asarray,
                                                            out[0])))
        for name, p in (("port", port), ("JAX", ref)):
            update = float((p[False] - flat(p0)).norm())
            drift = float((p[True] - p[False]).norm())
            print(f"{name} {epochs} epochs x {minibatches} minibatches at "
                  f"{num_envs} envs: update {update:.4f}, fused-sequential "
                  f"drift {drift:.4f}, ratio {drift / update:.3f}",
                  flush=True)
        print(f"sequential update, port against JAX: "
              f"{float((port[False] - ref[False]).norm()):.4f}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main(*map(int, sys.argv[1:]))
