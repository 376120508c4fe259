"""Actor-critic networks as torch nn.Modules: the ActorCriticDecoder, the
plain ActorCritic and the GRU/LSTM ActorCriticRecurrent.

Counterpart of the JAX package's models/networks.py (parity with
rsl_rl/modules/actor_critic_decoder.py, the live teacher path, and
actor_critic.py:38 / actor_critic_recurrent.py:40).

Architecture (dims from AC_Args, actor_critic_decoder.py:36-88,118-119):
  Vae:
    cenet_encoder  265 -> 128 -> 64            (ReLU)
    latent_mu      64 -> 19  (3 vel + 16 z mean)
    latent_var     64 -> 16  (log-variance)
    cenet_decoder  (16+3+512) -> 64 -> 128 -> 53
    terrain_encoder 693 -> 512 -> 512 -> 512
    terrain_decoder 512 -> 512 -> 512 -> 693
    memory_mlp     (265+512) -> 256 -> 128 -> 512
  actor_body  (53+16+3+512) -> 512 -> 256 -> 128 -> 12   (ELU)
  critic_body (53+3+3+693)=752 -> 512 -> 256 -> 128 -> 1 (ELU)
  learned global std (12,), init 1.0 (:364)
ActorCritic: actor and critic MLPs on the obs.  ActorCriticRecurrent: a
GRU or LSTM Memory per head (flax's GRUCell / OptimizedLSTMCell, float32)
in front of the actor and critic MLPs.

The MLPs keep float32 parameters and compute in bfloat16 with a float32
output, rounding where the JAX package rounds: inputs cast to bf16 before
the concat, the matmul rounded to bf16, then the bias added in bf16.  The
recurrent cells compute in float32, as flax does (dtype None).  Submodule
names follow flax's, so convert.params_from_flax maps the weights.

In a run sharded over torch.distributed ranks (parallel/mesh.py) the
decoder's `shard` is the rank's EnvShard: the CE-net's outlier filter
reads its mean, std and median over every rank's rows (the global batch,
as the JAX program reads them), and the VAE losses are each rank's share
of the global means.  Without a shard (None) nothing changes.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh as pmesh

BF16 = torch.bfloat16

_ACTIVATIONS = {"elu": F.elu, "relu": F.relu, "selu": F.selu, "crelu": F.relu,
                "lrelu": F.leaky_relu, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid}


# The control's precision (bench_port/harness/check.py): None computes as
# the port does, in bf16 products; a float8 dtype rounds both operands of
# every bf16 product to it first, each scaled by its largest magnitude.
LOWER = None
# The control's float32 products: True rounds both operands of every
# float32 product (the recurrent cells, the CE-net's latent heads) to TF32,
# the 10-bit mantissa the card's tensor cores read with allow_tf32 on.
TF32 = False
# The witness (the check's sound reading): True computes every product,
# bf16 or float32, with its inner width zero-padded to a multiple of 8 and
# the bias added in the product's epilogue (one rounding, torch.addmm), as
# a sound rewrite of the networks would: the same sums in another order.
WITNESS = False


def _witness_linear(x, w, b):
    k = x.shape[-1]
    pad = (-k) % 8
    x2 = F.pad(x, (0, pad)).reshape(-1, k + pad)
    w2 = F.pad(w, (0, pad))
    y = (torch.addmm(b, x2, w2.t()) if b is not None else x2 @ w2.t())
    return y.reshape(x.shape[:-1] + (w.shape[0],))


def _tf32(t):
    """t (float32) with its mantissa rounded to TF32's 10 bits, to nearest
    and ties away from zero, as the conversion to TF32 rounds; the
    gradient passes through the rounding unchanged."""
    if not TF32:
        return t
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return t + (r - t.detach())


def _lower(t):
    if LOWER is None:
        return t
    s = t.abs().amax().float().clamp(min=1e-30) / torch.finfo(LOWER).max
    return ((t.float() / s).to(LOWER).float() * s).to(t.dtype)


class Dense(nn.Module):
    """y = x W^T + b with the weight (out, in); `init` is "lecun" (flax's
    default Dense init: truncated normal, variance 1/fan_in) or
    "orthogonal" (gain 0.01 as layer_init :268-272; 1 for the recurrent
    cells' hidden layers).  Biases start at 0; use_bias=False has none."""

    def __init__(self, fan_in: int, fan_out: int, init: str = "lecun",
                 generator: torch.Generator | None = None, gain: float = 0.01,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.zeros(fan_out)) if use_bias else None
        with torch.no_grad():
            if init == "orthogonal":
                nn.init.orthogonal_(self.weight, gain=gain, generator=generator)
            else:
                # stddev of the [-2, 2]-truncated unit normal (flax)
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)

    def forward(self, x):
        if x.dtype == BF16:
            if WITNESS:
                return _witness_linear(x, self.weight.to(BF16),
                                       None if self.bias is None
                                       else self.bias.to(BF16))
            y = F.linear(_lower(x), _lower(self.weight.to(BF16)))
            return y if self.bias is None else y + self.bias.to(BF16)
        if WITNESS:
            return _witness_linear(x, self.weight, self.bias)
        return F.linear(_tf32(x), _tf32(self.weight), self.bias)


class MLP(nn.Module):
    """Stack with the reference init: first layer default, the rest
    orthogonal(0.01); bfloat16 compute, float32 output."""

    def __init__(self, fan_in: int, hidden: Sequence[int], out: int,
                 act: str = "relu", final_act: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [fan_in] + list(hidden) + [out]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], "lecun" if i == 0 else "orthogonal",
                  generator) for i in range(len(dims) - 1))
        self.act = _ACTIVATIONS[act]
        self.final_act = final_act

    def forward(self, x):
        x = x.to(BF16)
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.final_act:
                x = self.act(x)
        return x.float()


def bf16_concat(*parts):
    """Concatenate MLP inputs in bfloat16: every MLP casts its input to
    bf16 first, so the cast before the concat feeds identical values."""
    return torch.cat([p.to(BF16) for p in parts], dim=-1)


class _MaskedMedian(torch.autograd.Function):
    """Forward: the rank read from a device-side sort.  Backward: the
    JAX package's rule (networks.py:137-140) — the median is reconnected
    through a max over the valid elements equal to it, and the gradient
    of a max splits equally among ties."""

    @staticmethod
    def forward(ctx, x, valid):
        flat = x.reshape(-1)
        v = valid.reshape(-1)
        keyed = torch.where(v, flat, torch.full_like(flat, float("inf")))
        srt = torch.sort(keyed).values
        k = torch.clamp((v.sum() + 1) // 2 - 1, min=0)
        med = srt.gather(0, k.reshape(1))[0]
        ctx.save_for_backward(x, valid, med)
        return med

    @staticmethod
    def backward(ctx, grad):
        x, valid, med = ctx.saved_tensors
        sel = (valid & (x == med)).to(x.dtype)
        return grad * sel / torch.clamp(sel.sum(), min=1.0), None


def masked_median(x, valid):
    """Median of x[valid] — the lower middle element for even counts, as
    torch.median and the JAX package's masked_median (networks.py:83-140)
    return it — without a host round trip: invalid entries sort last, and
    the rank is read on the device.  Its gradient is split equally among
    the valid elements equal to the median, as in the JAX package."""
    return _MaskedMedian.apply(x, valid)


class Vae(nn.Module):
    """CE-net + terrain autoencoder + belief memory MLP (Vae, :91-303)."""

    def __init__(self, num_obs=53, obs_history_dim=265, terrain_dim=693,
                 terrain_latent=512, z_dim=16, outlier_filter="median",
                 generator=None, shard=None):
        super().__init__()
        if outlier_filter not in ("median", "mean"):
            raise ValueError(f"outlier_filter {outlier_filter!r}")
        g = generator
        self.z_dim = z_dim
        self.outlier_filter = outlier_filter
        self.shard = shard
        self.cenet_encoder = MLP(obs_history_dim, (128,), 64, "relu", generator=g)
        self.latent_mu = Dense(64, 3 + z_dim, "orthogonal", g)
        self.latent_var = Dense(64, z_dim, "orthogonal", g)
        self.cenet_decoder = MLP(z_dim + 3 + terrain_latent, (64, 128), num_obs,
                                 "relu", generator=g)
        self.terrain_encoder = MLP(terrain_dim, (512, 512), terrain_latent,
                                   "relu", generator=g)
        self.terrain_decoder = MLP(terrain_latent, (512, 512), terrain_dim,
                                   "relu", generator=g)
        self.memory_mlp = MLP(obs_history_dim + terrain_latent, (256, 128),
                              terrain_latent, "relu", generator=g)

    def cenet_stats(self, obs_history):
        """(mu, logvar) with the latent_var outlier filter (:286-302):
        entries beyond 2 sigma (over the whole batch) take the median of
        the others ("median", the reference) or their mean ("mean").
        Sharded, the batch is every rank's rows: each rank computes the
        statistics of the gathered logvar (its gradient flows back through
        the gather, ties at the median split over all ranks' rows)."""
        e = self.cenet_encoder(obs_history)
        mu = self.latent_mu(e)
        logvar = self.latent_var(e)
        whole = pmesh.all_gather_rows(logvar, self.shard)
        m = whole.mean()
        s = whole.std(correction=0)
        outliers = torch.abs(whole - m) > 2.0 * s
        valid = ~outliers
        if self.outlier_filter == "median":
            center = masked_median(whole, valid)
        else:
            center = (torch.where(valid, whole, 0.0).sum()
                      / torch.clamp(valid.sum(), min=1))
        if whole is not logvar:                     # this rank's rows
            n = logvar.shape[0]
            outliers = outliers.narrow(0, self.shard.rank * n, n)
        return mu, torch.where(outliers, center, logvar)

    def reparam(self, mu, logvar, eps):
        """z = mu[3:] + eps * exp(logvar / 2) (:274-284) for standard normal
        eps of logvar's shape."""
        return mu[..., 3:] + eps * torch.exp(0.5 * logvar)

    def cenet_forward(self, obs_history, eps):
        mu, logvar = self.cenet_stats(obs_history)
        return mu, logvar, self.reparam(mu, logvar, eps)

    def encode_terrain(self, heights):
        return self.terrain_encoder(heights)

    def decode_terrain(self, l_t):
        return self.terrain_decoder(l_t)

    def decode_cenet(self, z, vel, l_t):
        return self.cenet_decoder(bf16_concat(z, vel, l_t))

    def belief(self, obs_history, l_t):
        """Teacher-inference belief (act_teacher, :516-518)."""
        b_t1 = self.memory_mlp(bf16_concat(obs_history, l_t))
        return b_t1 + l_t * b_t1


class ActorCriticDecoder(nn.Module):
    """The DTC teacher actor-critic (ActorCriticDecoder, :305-563)."""

    def __init__(self, num_obs=53, num_privileged_obs=1389, num_actions=12,
                 obs_history_dim=265, terrain_dim=693, terrain_latent=512,
                 z_dim=16, actor_hidden=(512, 256, 128),
                 critic_hidden=(512, 256, 128), activation="elu",
                 init_noise_std=1.0, outlier_filter="median",
                 generator: torch.Generator | None = None, shard=None):
        super().__init__()
        g = generator
        self.terrain_dim = terrain_dim
        self.z_dim = z_dim
        self.vae = Vae(num_obs, obs_history_dim, terrain_dim, terrain_latent,
                       z_dim, outlier_filter, generator=g, shard=shard)
        self.actor_body = MLP(num_obs + z_dim + 3 + terrain_latent,
                              actor_hidden, num_actions, activation,
                              generator=g)
        critic_in = num_obs + 3 + 3 + (num_privileged_obs - terrain_dim - 3)
        self.critic_body = MLP(critic_in, critic_hidden, 1, activation,
                               generator=g)
        self.std = nn.Parameter(init_noise_std * torch.ones(num_actions))

    def act_stats(self, obs, obs_history, privileged_obs, eps_z):
        """Training-path distribution stats (update_distribution, :409-437):
        (mean, std, (mu, logvar, z), l_t) with l_t fed raw to the actor."""
        mu, logvar, z = self.vae.cenet_forward(obs_history, eps_z)
        l_t = self.vae.encode_terrain(privileged_obs[..., :self.terrain_dim])
        mean = self.actor_body(bf16_concat(obs, z, mu[..., :3], l_t))  # :431
        return mean, self.std.expand_as(mean), (mu, logvar, z), l_t

    def act_teacher(self, obs, obs_history, privileged_obs):
        """Deterministic teacher policy (:504-538): latent means and the
        belief b_t in the last input slot (the reference's layout)."""
        e = self.vae.cenet_encoder(obs_history)
        latent = self.vae.latent_mu(e)
        l_t = self.vae.encode_terrain(privileged_obs[..., :self.terrain_dim])
        b_t = self.vae.belief(obs_history, l_t)
        return self.actor_body(bf16_concat(obs, latent[..., 3:],
                                           latent[..., :3], b_t))

    def act_deterministic(self, obs, obs_history, privileged_obs):
        """Deterministic actor on the training input layout: latent means
        and raw l_t."""
        e = self.vae.cenet_encoder(obs_history)
        latent = self.vae.latent_mu(e)
        l_t = self.vae.encode_terrain(privileged_obs[..., :self.terrain_dim])
        return self.actor_body(bf16_concat(obs, latent[..., 3:],
                                           latent[..., :3], l_t))

    def evaluate(self, obs, privileged_obs, base_vel):
        """Critic (:540-551): [obs, base_vel, force(3), clean heights]."""
        td = self.terrain_dim
        x = bf16_concat(obs, base_vel, privileged_obs[..., td:td + 3],
                        privileged_obs[..., td + 3:])
        return self.critic_body(x)[..., 0]

    def _vae_terms(self, mu, logvar, z, l_t, privileged_obs, next_obs,
                   base_vel):
        """(recons, vel, kld, height) losses of the VAE head (ppo.py:197-247)
        from one encoder pass (sharded: this rank's shares of the global
        means, pmesh.mean)."""
        td = self.terrain_dim
        sh = self.vae.shard
        recons = self.vae.decode_cenet(z, mu[..., :3], l_t)
        recons_loss = pmesh.mean(torch.mean(torch.square(recons - next_obs),
                                            dim=-1), sh)
        height_recon = self.vae.decode_terrain(l_t)
        height_loss = pmesh.mean(torch.square(height_recon
                                              - privileged_obs[..., td + 3:]),
                                 sh)
        vel_loss = pmesh.mean(torch.square(mu[..., :3] - base_vel), sh)
        kld = pmesh.mean(-0.5 * torch.sum(
            1 + logvar - torch.square(mu[..., 3:]) - torch.exp(logvar), dim=-1),
            sh)
        return recons_loss, vel_loss, kld, height_loss

    def vae_losses(self, obs_history, privileged_obs, next_obs, base_vel,
                   eps):
        """VAE training pieces (ppo.py:197-247): (recons, vel, kld, height)
        for the standard normal draw eps (N, z_dim) of the latent."""
        mu, logvar, z = self.vae.cenet_forward(obs_history, eps)
        l_t = self.vae.encode_terrain(privileged_obs[..., :self.terrain_dim])
        return self._vae_terms(mu, logvar, z, l_t, privileged_obs, next_obs,
                               base_vel)

    def belief_loss(self, obs_history, privileged_obs):
        """Belief-distillation loss (AlgorithmCfg.belief_loss_coef): l_t is
        detached as input and target, so only memory_mlp learns."""
        l_t = self.vae.encode_terrain(
            privileged_obs[..., :self.terrain_dim]).detach()
        b_t = self.vae.belief(obs_history, l_t)
        return pmesh.mean(torch.square(b_t - l_t), self.vae.shard)

    def joint_forward(self, obs, obs_history, privileged_obs, next_obs,
                      base_vel, eps_vae, eps_pol):
        """One encoder pass for the fused VAE+policy minibatch step
        (AlgorithmCfg.fused_joint_step): the VAE and policy heads read the
        same (mu, logvar, l_t) and draw their own latents from eps_vae and
        eps_pol.  Returns ((recons, vel, kld, height), mean, std, value)."""
        mu, logvar = self.vae.cenet_stats(obs_history)
        l_t = self.vae.encode_terrain(privileged_obs[..., :self.terrain_dim])
        parts = self._vae_terms(mu, logvar, self.vae.reparam(mu, logvar, eps_vae),
                                l_t, privileged_obs, next_obs, base_vel)
        z_p = self.vae.reparam(mu, logvar, eps_pol)
        mean = self.actor_body(bf16_concat(obs, z_p, mu[..., :3], l_t))
        value = self.evaluate(obs, privileged_obs, base_vel)
        return parts, mean, self.std.expand_as(mean), value


class ActorCritic(nn.Module):
    """Baseline MLP actor-critic (actor_critic.py:38-155)."""

    def __init__(self, num_obs=53, num_critic_obs=53, num_actions=12,
                 actor_hidden=(512, 256, 128), critic_hidden=(512, 256, 128),
                 activation="elu", init_noise_std=1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.actor = MLP(num_obs, actor_hidden, num_actions, activation,
                         generator=generator)
        self.critic = MLP(num_critic_obs, critic_hidden, 1, activation,
                          generator=generator)
        self.std = nn.Parameter(init_noise_std * torch.ones(num_actions))

    def forward(self, obs, critic_obs):
        """(mean, std, value)."""
        mean = self.actor(obs)
        return mean, self.std.expand_as(mean), self.critic(critic_obs)[..., 0]


class GRUCell(nn.Module):
    """flax.linen.GRUCell in float32: r = sigmoid(ir(x) + hr(h)),
    z = sigmoid(iz(x) + hz(h)), n = tanh(in(x) + r * hn(h)),
    h' = (1 - z) n + z h.  The input layers ir/iz/in (lecun-normal) and hn
    have biases, hr and hz none; the hidden layers start orthogonal."""

    def __init__(self, fan_in: int, hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        for g in "rzn":
            self.add_module("i" + g, Dense(fan_in, hidden, "lecun", generator))
            self.add_module("h" + g, Dense(hidden, hidden, "orthogonal",
                                           generator, gain=1.0,
                                           use_bias=g == "n"))

    def forward(self, h, x):
        """(carry, output) = (h', h') for the carry h (N, H) and input x."""
        m = self._modules
        r = torch.sigmoid(m["ir"](x) + m["hr"](h))
        z = torch.sigmoid(m["iz"](x) + m["hz"](h))
        n = torch.tanh(m["in"](x) + r * m["hn"](h))
        h = (1.0 - z) * n + z * h
        return h, h


class LSTMCell(nn.Module):
    """flax.linen.OptimizedLSTMCell in float32 on the carry (c, h): gates
    i, f, o = sigmoid(h·(x) + i·(x)), g = tanh(...), c' = f c + i g,
    h' = o tanh(c').  The input layers ii/if/ig/io (lecun-normal) have no
    bias, the hidden layers hi/hf/hg/ho (orthogonal) have one; no
    forget-gate offset."""

    def __init__(self, fan_in: int, hidden: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        for g in "ifgo":
            self.add_module("i" + g, Dense(fan_in, hidden, "lecun", generator,
                                           use_bias=False))
            self.add_module("h" + g, Dense(hidden, hidden, "orthogonal",
                                           generator, gain=1.0))

    def forward(self, carry, x):
        """((c', h'), h') for the carry (c, h), each (N, H), and input x."""
        c, h = carry
        m = self._modules
        i = torch.sigmoid(m["hi"](h) + m["ii"](x))
        f = torch.sigmoid(m["hf"](h) + m["if"](x))
        g = torch.tanh(m["hg"](h) + m["ig"](x))
        o = torch.sigmoid(m["ho"](h) + m["io"](x))
        c = f * c + i * g
        h = o * torch.tanh(c)
        return (c, h), h


class Memory(nn.Module):
    """GRU/LSTM memory (Memory, actor_critic_decoder.py:584-614): one cell,
    rnn_type "gru" or "lstm"."""

    def __init__(self, fan_in: int, hidden_size: int = 256,
                 rnn_type: str = "gru",
                 generator: torch.Generator | None = None):
        super().__init__()
        cells = {"gru": GRUCell, "lstm": LSTMCell}
        if rnn_type not in cells:
            raise ValueError(f"rnn_type {rnn_type!r}: 'gru' or 'lstm'")
        self.rnn_type = rnn_type
        self.hidden_size = hidden_size
        self.cell = cells[rnn_type](fan_in, hidden_size, generator)

    def forward(self, x, carry):
        """(carry, output) after one step on the input x."""
        return self.cell(carry, x)

    def initialize_carry(self, batch: int, device=None):
        """The zero carry of `batch` rows: (N, H) for a GRU, (c, h) for an
        LSTM (flax's cell defaults)."""
        z = torch.zeros((batch, self.hidden_size), device=device)
        return z if self.rnn_type == "gru" else (z, z.clone())


class ActorCriticRecurrent(nn.Module):
    """RNN actor-critic (actor_critic_recurrent.py:40-115): obs -> memory ->
    MLP head, for the actor and the critic each; the carries of both
    memories are threaded through by the caller."""

    def __init__(self, num_obs=53, num_critic_obs=53, num_actions=12,
                 rnn_hidden_size=256, rnn_type="gru",
                 actor_hidden=(512, 256, 128), critic_hidden=(512, 256, 128),
                 activation="elu", init_noise_std=1.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.memory_a = Memory(num_obs, rnn_hidden_size, rnn_type, g)
        self.memory_c = Memory(num_critic_obs, rnn_hidden_size, rnn_type, g)
        self.actor = MLP(rnn_hidden_size, actor_hidden, num_actions,
                         activation, generator=g)
        self.critic = MLP(rnn_hidden_size, critic_hidden, 1, activation,
                          generator=g)
        self.std = nn.Parameter(init_noise_std * torch.ones(num_actions))

    def forward(self, obs, critic_obs, carry_a, carry_c):
        """(mean, std, value, carry_a, carry_c) after one step."""
        carry_a, ha = self.memory_a(obs, carry_a)
        carry_c, hc = self.memory_c(critic_obs, carry_c)
        mean = self.actor(ha)
        value = self.critic(hc)[..., 0]
        return mean, self.std.expand_as(mean), value, carry_a, carry_c
