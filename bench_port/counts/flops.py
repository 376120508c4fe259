"""Model FLOPs of a PPO iteration of the ActorCriticDecoder, counted from
the configuration's widths, whatever implements them.

A dense layer of fan-in i and fan-out o costs 2*i*o FLOPs a row forward;
backward, 2*i*o for its weight's gradient and 2*i*o more for its input's
gradient where that input depends on parameters (not for the first layer
of a network fed with observations).  Elementwise work, the activations,
the losses and the optimizer are not counted: the peak they are compared
with (989 TFLOP/s, the H100's dense bf16 rate) is the tensor cores'.

The decoder's networks (models/networks.py of the port, after
actor_critic_decoder.py of the reference; the hidden widths of the VAE
are the architecture's, not configuration fields):
  cenet_encoder   hist -> 128 -> 64;  latent_mu 64 -> 3 + z;
  latent_var      64 -> z
  cenet_decoder   (z + 3 + L) -> 64 -> 128 -> obs
  terrain_encoder scan -> 512 -> 512 -> L
  terrain_decoder L -> 512 -> 512 -> scan
  actor           (obs + z + 3 + L) -> actor_hidden -> actions
  critic          (obs + 3 + 3 + scan) -> critic_hidden -> 1
with hist the history width, scan the height scan, L the terrain latent,
z the CE-net latent.  An iteration acts once a collected row (the act
forward: CE-net stats, terrain encoder, actor, critic), takes the last
values once an env (critic), and visits every row once an epoch in the
fused minibatch step: one forward of all eight networks, the VAE loss's
gradient over the VAE networks and the policy loss's gradient over the
CE-net encoder heads, the terrain encoder, the actor and the critic.
"""
from __future__ import annotations

VAE_HIDDEN = dict(cenet_encoder=(128,), cenet_decoder=(64, 128),
                  terrain_encoder=(512, 512), terrain_decoder=(512, 512))


def _chain(fan_in, hidden, out):
    dims = [fan_in, *hidden, out]
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def networks(cfg: dict) -> dict:
    """name -> [(fan_in, fan_out)] of the decoder's dense layers, from a
    configuration file's task and train fields."""
    env, pol = cfg["task"]["env"], cfg["train"]["policy"]
    if pol["policy_class_name"] != "ActorCriticDecoder":
        raise ValueError("model FLOPs are counted for the ActorCriticDecoder")
    obs, acts = env["num_observations"], env["num_actions"]
    hist = env["num_observation_history"] * obs
    scan = (env["num_privileged_obs"] - 3) // 2
    lat, z = pol["terrain_latent"], pol["cenet_latent"]
    h = VAE_HIDDEN
    return dict(
        cenet_encoder=_chain(hist, h["cenet_encoder"], 64),
        latent_mu=[(64, 3 + z)], latent_var=[(64, z)],
        cenet_decoder=_chain(z + 3 + lat, h["cenet_decoder"], obs),
        terrain_encoder=_chain(scan, h["terrain_encoder"], lat),
        terrain_decoder=_chain(lat, h["terrain_decoder"], scan),
        actor=_chain(obs + z + 3 + lat, pol["actor_hidden_dims"], acts),
        critic=_chain(obs + 3 + 3 + scan, pol["critic_hidden_dims"], 1))


# networks whose first layer reads observations only (no input gradient)
_FED_BY_DATA = ("cenet_encoder", "terrain_encoder", "critic")
ACT = ("cenet_encoder", "latent_mu", "latent_var", "terrain_encoder",
       "actor", "critic")
VAE_LOSS = ("cenet_encoder", "latent_mu", "latent_var", "terrain_encoder",
            "cenet_decoder", "terrain_decoder")
POLICY_LOSS = ("cenet_encoder", "latent_mu", "latent_var", "terrain_encoder",
               "actor", "critic")


def forward(nets: dict, names) -> int:
    return sum(2 * i * o for n in names for i, o in nets[n])


def backward(nets: dict, names) -> int:
    total = 0
    for n in names:
        for k, (i, o) in enumerate(nets[n]):
            total += 2 * i * o
            if not (k == 0 and n in _FED_BY_DATA):
                total += 2 * i * o
    return total


def per_row(cfg: dict) -> dict:
    """FLOPs a row: act (the collection's forward), value (the critic) and
    step (one fused minibatch step: forward and both gradients)."""
    nets = networks(cfg)
    return dict(act=forward(nets, ACT), value=forward(nets, ("critic",)),
                step=forward(nets, VAE_LOSS + ("actor", "critic"))
                + backward(nets, VAE_LOSS) + backward(nets, POLICY_LOSS))


def iteration(cfg: dict, num_envs: int, update: bool = True) -> int:
    """Model FLOPs of one learn iteration over num_envs envs (without the
    update: one collect)."""
    run, alg = cfg["train"]["runner"], cfg["train"]["algorithm"]
    rows = run["num_steps_per_env"] * num_envs
    r = per_row(cfg)
    total = r["act"] * rows + r["value"] * num_envs
    if update:
        total += r["step"] * rows * alg["num_learning_epochs"]
    return total
