"""Carry weights and env state across from the JAX package.

Both functions take plain numpy trees (``jax.tree.map(np.asarray, tree)``
on the JAX side), so this module needs no JAX.

  params_from_flax(tree)   flax ActorCriticDecoder, ActorCritic or
                           ActorCriticRecurrent params -> the state_dict
                           of the same class in models.networks
  opt_state_from_optax(..) the optax states of the JAX update's two
                           optimizers and its learning rate -> the state of
                           this package's PPO optimizers
  env_from_jax(...)        LeggedEnv (params, state) of the JAX package ->
                           the (params, state) of this package's LeggedEnv,
                           terrain included, so both step the same world
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .parallel import mesh as pmesh
from .terrain.grid import TerrainGrid


def params_from_flax(tree) -> dict:
    """flax params (nested dicts of numpy arrays, with or without the
    top-level "params" key) -> the state_dict of the same net here.  A flax
    Dense kernel is (in, out); a torch weight is (out, in), so kernels are
    transposed.  Submodules named Dense_i become layers.i, and a Memory's
    GRUCell_0 / OptimizedLSTMCell_0 its cell."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
            return
        names = [re.sub(r"^(GRUCell|OptimizedLSTMCell)_0$", "cell",
                        re.sub(r"^Dense_(\d+)$", r"layers.\1", p))
                 for p in path]
        arr = np.asarray(node, dtype=np.float32)
        if names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        out[".".join(names)] = torch.from_numpy(np.array(arr, order="C"))
    walk(tree, [])
    return out


def _adam_state(state):
    """The ScaleByAdamState (count, mu, nu) inside an optax chain state."""
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _adam_state(sub)
            if found is not None:
                return found
    inner = getattr(state, "inner_state", None)
    return None if inner is None else _adam_state(inner)


def opt_state_from_optax(opt_state, vae_opt_state, lr) -> dict:
    """The JAX update's optimizer states -> this package's.

    opt_state / vae_opt_state: the (clip, adam) chain states of
    agent/ppo.py make_optimizers with numpy leaves
    (``jax.tree.map(np.asarray, state)``); lr: the runner's learning rate.
    Returns dict(opt_state, vae_opt_state, learning_rate) for
    PPO.optimizer / PPO.vae_optimizer `load_state_dict` and
    PPO.learning_rate: the Adam moments per parameter under the leaf
    mapping of params_from_flax (the VAE optimizer keeps only the vae
    subtree: its moments elsewhere are zero, mask_non_vae; for the MLP and
    recurrent nets, which have none, it keeps no moments, and
    vae_opt_state may be None: update_recurrent has no VAE state)."""
    out = {}
    for name, state, keep in (("opt_state", opt_state, lambda n: True),
                              ("vae_opt_state", vae_opt_state,
                               lambda n: n.startswith("vae."))):
        if state is None and name == "vae_opt_state":
            out[name] = dict(count=torch.tensor(0, dtype=torch.int32),
                             mu={}, nu={})
            continue
        adam = _adam_state(state)
        if adam is None:
            raise ValueError(f"{name}: no Adam state (count, mu, nu) found")
        out[name] = dict(
            count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32),
            **{m: {k: v for k, v in params_from_flax(getattr(adam, m)).items()
                   if keep(k)} for m in ("mu", "nu")})
    out["learning_rate"] = torch.tensor(float(np.asarray(lr)),
                                        dtype=torch.float32)
    return out


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    arr = np.asarray(node)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def env_from_jax(env_params, env_state, grid_height, env,
                 terrain_origins=None, shard=None):
    """The JAX package's env (params, state) -> this package's.

    env_params / env_state: numpy trees of the JAX LeggedEnv.init/step
    results; grid_height: the JAX env's heightfield (grid.height, meters);
    env: this package's LeggedEnv, for the terrain geometry and device;
    terrain_origins: the JAX env's (rows, cols, 3) tile origins (the resets
    respawn there; default: env's own).  A plane world has no tables and
    no tile origins (both None in params; the env steps its own flat grid),
    so grid_height and terrain_origins may be None there.  With `shard`
    (a parallel/mesh.py EnvShard) the JAX trees are global and the result
    is the shard's block of them (pmesh.shard_tree).  Returns
    (params, state)."""
    dev = env.device
    params = {k: _to_torch(v, dev) for k, v in env_params.items()}
    state = pmesh.shard_tree(_to_torch(env_state, dev), shard)
    params = pmesh.shard_tree(params, shard)
    if env.terrain is None:
        params.update(terrain=None, terrain_origins=None)
        return params, state
    cfg = env.cfg.terrain
    grid = TerrainGrid(height=_to_torch(grid_height, dev),
                       horizontal_scale=cfg.horizontal_scale,
                       border_size=cfg.border_size)
    params["terrain"] = env.make_patch_source(grid)
    params["terrain_origins"] = (env.terrain_origins if terrain_origins is None
                                 else _to_torch(terrain_origins, dev))
    return params, state
