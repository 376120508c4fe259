"""Model FLOPs of a PPO iteration of the configuration's policy (the
ActorCriticDecoder, the ActorCritic MLP or the GRU/LSTM
ActorCriticRecurrent), counted from its widths, whatever implements them.

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

The MLP: actor and critic obs -> hidden -> actions (1); it acts (both),
takes the last values (critic) and steps over every row an epoch (both,
forward and backward).  The recurrent net: one memory a head, each a
cell of 3 gates (GRU) or 4 (LSTM), a gate an input layer obs -> H and a
hidden layer H -> H, in front of the actor and critic H -> hidden; it
acts (both memories and heads) and takes the last values (the critic's
memory and head); each epoch replays the cells over the T steps for the
N // nmb envs of each of its nmb minibatches, forward and backward.  The
input layers read the obs (no input gradient); the hidden layers' input,
the carry, has one at every step but the first, whose carry is the
rollout's start, not a parameter's function.
"""
from __future__ import annotations

# the port's policy kinds by the configuration's policy_class_name
# (runner/train.py OnPolicyRunner)
KINDS = {"ActorCriticDecoder": "decoder", "ActorCritic": "mlp",
         "ActorCriticRecurrent": "recurrent"}
GATES = {"gru": 3, "lstm": 4}

VAE_HIDDEN = dict(cenet_encoder=(128,), cenet_decoder=(64, 128),
                  terrain_encoder=(512, 512), terrain_decoder=(512, 512))


def _chain(fan_in, hidden, out):
    dims = [fan_in, *hidden, out]
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def kind(cfg: dict) -> str:
    name = cfg["train"]["policy"]["policy_class_name"]
    if name not in KINDS:
        raise ValueError(f"no model FLOPs for {name!r}: one of "
                         f"{sorted(KINDS)}")
    return KINDS[name]


def networks(cfg: dict) -> dict:
    """name -> [(fan_in, fan_out)] of the policy's dense layers, from a
    configuration file's task and train fields (a recurrent memory as two
    networks, its gates' input layers `<memory>.in` and hidden layers
    `<memory>.hidden`)."""
    env, pol = cfg["task"]["env"], cfg["train"]["policy"]
    obs, acts = env["num_observations"], env["num_actions"]
    k = kind(cfg)
    if k != "decoder":
        fan_in = obs if k == "mlp" else pol["rnn_hidden_size"]
        nets = dict(actor=_chain(fan_in, pol["actor_hidden_dims"], acts),
                    critic=_chain(fan_in, pol["critic_hidden_dims"], 1))
        if k == "recurrent":
            H, g = pol["rnn_hidden_size"], GATES[pol["rnn_type"]]
            for m in MEMORIES:
                nets[m + ".in"] = [(obs, H)] * g
                nets[m + ".hidden"] = [(H, H)] * g
        return nets
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


MEMORIES = ("memory_a", "memory_c")
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


def backward(nets: dict, names, fed=_FED_BY_DATA) -> int:
    """The weights' gradients of the networks `names`, and their inputs'
    but for the first layer of a network in `fed`."""
    total = 0
    for n in names:
        for k, (i, o) in enumerate(nets[n]):
            total += 2 * i * o
            if not (k == 0 and n in fed):
                total += 2 * i * o
    return total


def per_row(cfg: dict) -> dict:
    """FLOPs a row: act (the collection's forward), value (the last
    values' forward) and step (one minibatch step of the update: forward
    and gradients; for the recurrent net one replayed step, with `carry`,
    the hidden layers' input gradients, at every step but the first)."""
    nets = networks(cfg)
    k = kind(cfg)
    heads = ("actor", "critic")
    if k == "decoder":
        return dict(act=forward(nets, ACT),
                    value=forward(nets, ("critic",)),
                    step=forward(nets, VAE_LOSS + ("actor", "critic"))
                    + backward(nets, VAE_LOSS)
                    + backward(nets, POLICY_LOSS))
    if k == "mlp":
        return dict(act=forward(nets, heads),
                    value=forward(nets, ("critic",)),
                    step=forward(nets, heads)
                    + backward(nets, heads, fed=heads))
    cells = tuple(m + p for m in MEMORIES for p in (".in", ".hidden"))
    hidden = tuple(m + ".hidden" for m in MEMORIES)
    # a replayed step: the forward, the cells' weight gradients (each as
    # many FLOPs as its forward) and the heads' weight and input gradients
    # (their input, the memories' output, depends on parameters)
    return dict(act=forward(nets, cells + heads),
                value=forward(nets, ("memory_c.in", "memory_c.hidden",
                                     "critic")),
                step=2 * forward(nets, cells) + forward(nets, heads)
                + backward(nets, heads, fed=()),
                carry=forward(nets, hidden))


def iteration(cfg: dict, num_envs: int, update: bool = True) -> int:
    """Model FLOPs of one learn iteration over num_envs envs (without the
    update: one collect)."""
    run, alg = cfg["train"]["runner"], cfg["train"]["algorithm"]
    T = run["num_steps_per_env"]
    rows = T * num_envs
    r = per_row(cfg)
    total = r["act"] * rows + r["value"] * num_envs
    if not update:
        return total
    epochs, nmb = alg["num_learning_epochs"], alg["num_mini_batches"]
    if kind(cfg) == "recurrent":
        envs = epochs * nmb * (num_envs // nmb)
        return total + envs * (T * r["step"] + (T - 1) * r["carry"])
    return total + r["step"] * rows * epochs
