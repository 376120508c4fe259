"""PPO on torch tensors: acting, GAE, the joint VAE + policy update and
the recurrent update.

Counterpart of the JAX package's agent/ppo.py (rsl_rl ppo.py:137-155 act,
rollout_storage.py:138-152 compute_returns, ppo.py:174-357 update) for
its three policy kinds:
  "decoder"   ActorCriticDecoder: the 5-epoch x 4-minibatch update over
              the flattened (T*N) batch, with ONE grouped permutation per
              update applied by the gather kernel (ops/cuda_gather.py) and
              reused by every epoch, the fused (Jacobi) or the sequential
              VAE+policy step;
  "mlp"       ActorCritic: actor(obs), critic(obs); the same shuffle and
              minibatches, no VAE step (its four stats are zeros);
  "recurrent" ActorCriticRecurrent: act_recurrent threads the GRU/LSTM
              carries through the rollout; update_recurrent minibatches
              over envs and replays the cells over the T steps from the
              rollout-start carry, resetting it at every done (BPTT).
Each has the adaptive-KL learning rate and the Adam optimizers in optax's
exact form.

Random draws (the group or env permutations, the standard normal draws of
the actions and of the reparameterized latents) are arguments; they come
from a torch.Generator when not given, so tests can feed the JAX
package's draws.

Data-parallel over torch.distributed ranks (`shard`, a parallel/mesh.py
EnvShard of W ranks; the runner passes the env's): every rank holds
its block of envs and the same params.  Each rank draws every draw at
its global shape (the permutations of all S strata, the latents of the
whole minibatch, the env permutation) and keeps its part: whole strata
under the stratified shuffle (W must divide S), its rows of each
minibatch, its envs of each recurrent minibatch.  The advantage
normalization reads the global mean and std; each loss term is the
rank's share of the global mean, its gradients are summed over the ranks
before the clip, and the stats (the KL that sets the learning rate among
them) are summed, so every rank takes the same step.  Without a shard of
two or more ranks nothing of this runs.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch

from ..env.config import AlgorithmCfg
from ..ops import cuda_gather
from ..parallel import mesh as pmesh
from ..utils.flags import strict_parity
from .trajectories import rnn_replay, tree_map

POLICY_KINDS = ("decoder", "mlp", "recurrent")

# A fault for the correctness check's readings (bench_port/harness/
# check.py): True leaves out the second half of every minibatch (its rows;
# in the recurrent update its envs), each mean taken over the rest.
HALF_BATCH = False

# the nine stats of an update, averaged over its minibatch steps
STAT_NAMES = ("value_loss", "surrogate_loss", "entropy", "kl", "recons_loss",
              "vel_loss", "kld_loss", "height_loss", "lr")


def normal_log_prob(mean, std, x):
    """Sum of independent Normal log-probs over the action axis."""
    var = std * std
    lp = (-0.5 * torch.square(x - mean) / var - torch.log(std)
          - 0.5 * math.log(2.0 * math.pi))
    return torch.sum(lp, dim=-1)


def normal_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std),
                     dim=-1)


class ClippedAdam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) over a list of
    named parameters, which it updates in place.

    The clip scales by max_norm / norm only when norm >= max_norm (optax's
    form; torch's clip_grad_norm_ divides by norm + 1e-6).  Adam is optax's
    scale_by_adam: b1=0.9, b2=0.999, eps=1e-8, eps_root=0, moments
    bias-corrected by 1 - b^t.  With injected=True the hyperparameters are
    float32 values, as optax.inject_hyperparams stores them, so the moment
    weights 1 - b are formed in float32 (1 - f32(0.999) is 1.3e-5 off
    0.001).  The moments live in two flat float32 buffers on `device`, so
    one step is a few dozen device ops whatever the number of parameters; a
    missing gradient counts as zero.  The list may be empty (the VAE
    optimizer of a net without a VAE): its state is the count alone."""

    def __init__(self, named_params, max_norm: float, device,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 injected: bool = False, shard=None):
        named_params = list(named_params)
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        one = np.float32(1.0) if injected else 1.0
        self.c1 = float(one - (np.float32(b1) if injected else b1))
        self.c2 = float(one - (np.float32(b2) if injected else b2))
        dev = torch.device(device)
        size = sum(p.numel() for p in self.params)
        self.mu = torch.zeros(size, device=dev)
        self.nu = torch.zeros(size, device=dev)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        # a sharded run's EnvShard: the gradients are summed over the
        # ranks before the clip
        self.shard = shard

    def _views(self, flat):
        out, i = [], 0
        for p in self.params:
            out.append(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        return out

    @torch.no_grad()
    def step(self, grads, lr):
        """One update with these gradients (a list parallel to the params,
        None for zero) at learning rate lr (a float or a 0-d tensor)."""
        g = torch.cat([(torch.zeros_like(p) if gi is None else gi).reshape(-1)
                       for gi, p in zip(grads, self.params)])
        g = pmesh.all_sum(g, self.shard)
        # sqrt of a plain sum of squares (vector_norm on the CPU loses
        # ~5e-5 of a 20k-entry f32 norm)
        norm = torch.sqrt(torch.sum(torch.square(g)))
        g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
        self.mu = self.c1 * g + self.b1 * self.mu
        self.nu = self.c2 * torch.square(g) + self.b2 * self.nu
        self.count = self.count + 1
        t = self.count.float()
        mu_hat = self.mu / (1 - self.b1 ** t)
        nu_hat = self.nu / (1 - self.b2 ** t)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps) * (-lr)
        torch._foreach_add_(self.params, self._views(update))

    def state_dict(self) -> dict:
        return dict(count=self.count.clone(),
                    mu=dict(zip(self.names, (v.clone() for v in
                                             self._views(self.mu)))),
                    nu=dict(zip(self.names, (v.clone() for v in
                                             self._views(self.nu)))))

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        dev = self.mu.device
        self.count = sd["count"].to(device=dev, dtype=torch.int32).reshape(())
        for name, buf in (("mu", self.mu), ("nu", self.nu)):
            if set(sd[name]) != set(self.names):
                raise KeyError(f"optimizer state {name}: other parameters")
            for v, n in zip(self._views(buf), self.names):
                v.copy_(sd[name][n])


def make_optimizers(net, alg: AlgorithmCfg, shard=None):
    """(main, vae) optimizers (ppo.py:40-50): the main one spans every
    parameter, its learning rate injected each minibatch; the VAE one spans
    the vae subtree only (mask_non_vae, ppo.py:519-525; none of the MLP and
    recurrent nets) at vae_learning_rate, clipped on the VAE gradient's own
    norm.  Both sum the gradients over `shard`'s ranks."""
    named = list(net.named_parameters())
    dev = net.std.device
    main = ClippedAdam(named, alg.max_grad_norm, dev, injected=True,
                       shard=shard)
    vae = ClippedAdam([(n, p) for n, p in named if n.startswith("vae.")],
                      alg.max_grad_norm, dev, shard=shard)
    return main, vae


def shuffle_layout(alg: AlgorithmCfg, T: int, N: int, n_env_shards: int = 1):
    """(S, rows per stratum, minibatch rows per stratum, G) of the update
    (ppo.py:287-300) over N envs in all: S strata (0 = auto: the env-shard
    count, 1 on one device; 1 under DTC_STRICT_PARITY), shrunk until every
    stratum splits into whole minibatches (with a warning: the JAX package
    shrinks silently), and the granule G capped at gcd(granule, mb_s).
    Over n_env_shards > 1 ranks each rank must hold whole strata: raises
    unless n_env_shards divides S."""
    total, nmb = T * N, alg.num_mini_batches
    want_s = (int(alg.shuffle_strata) if alg.shuffle_strata > 0
              else max(int(n_env_shards), 1))
    S = 1 if strict_parity() else math.gcd(want_s, N)
    while S > 1 and (total // S) % nmb:
        S -= 1
        while N % S:
            S -= 1
    if S < want_s and not strict_parity():
        warnings.warn(f"shuffle_strata: {S} strata in place of {want_s} "
                      f"({N} envs, {T} steps, {nmb} minibatches)",
                      stacklevel=2)
    if n_env_shards > 1 and S % n_env_shards:
        raise ValueError(f"{S} strata over {n_env_shards} ranks: each rank "
                         "must hold whole strata (set shuffle_strata to a "
                         "multiple of the rank count)")
    rows_s = total // S
    mb_s = rows_s // nmb
    G = math.gcd(max(int(alg.minibatch_perm_granule), 1), mb_s)
    return S, rows_s, mb_s, G


@dataclasses.dataclass
class PPO:
    """PPO over an actor-critic of `policy_kind` (POLICY_KINDS: the
    ActorCriticDecoder, ActorCritic or ActorCriticRecurrent).  With a net
    it owns the two optimizers and the learning rate, a 0-d tensor on the
    net's device.  Sharded, `shard` is the rank's EnvShard (a decoder net
    is built with the same one, for its CE-net stats and VAE losses)."""
    net: Any
    alg: AlgorithmCfg
    policy_kind: str = "decoder"
    shard: Any = None

    def __post_init__(self):
        if self.policy_kind not in POLICY_KINDS:
            raise ValueError(f"policy_kind {self.policy_kind!r}: one of "
                             f"{POLICY_KINDS}")
        if self.net is not None:
            self.optimizer, self.vae_optimizer = make_optimizers(
                self.net, self.alg, self.shard)
            self.learning_rate = torch.tensor(
                self.alg.learning_rate, dtype=torch.float32,
                device=self.net.std.device)

    @property
    def world(self) -> int:
        """The env-shard count: the ranks of the shard, 1 without one."""
        return 1 if self.shard is None else self.shard.world

    def _randn_rows(self, n, d, generator, device):
        """This rank's n rows of an (N, d) standard normal draw at the
        global env count."""
        return pmesh.rows(torch.randn(pmesh.global_shape((n, d), self.shard),
                                      generator=generator, device=device),
                          self.shard)

    def value(self, obs, privileged_obs, base_vel):
        """The critic of a decoder or MLP net (the MLP's reads the obs)."""
        if self.policy_kind == "decoder":
            return self.net.evaluate(obs, privileged_obs, base_vel)
        return self.net(obs, obs)[2]

    def _sample(self, mean, std, eps_a, generator):
        if eps_a is None:
            eps_a = self._randn_rows(*mean.shape, generator, mean.device)
        actions = mean + std * eps_a
        return dict(actions=actions,
                    log_prob=normal_log_prob(mean, std, actions),
                    mu=mean, sigma=std)

    @torch.no_grad()
    def act(self, obs, obs_history, privileged_obs, base_vel,
            generator: torch.Generator, eps_z=None, eps_a=None):
        """Sample actions + stats (PPO.act, ppo.py:137-155) of a decoder or
        MLP net.  eps_z (N, z_dim; the decoder's only) and eps_a
        (N, num_actions) are the standard normal draws of the latent and
        the action; drawn from `generator` when None."""
        if self.policy_kind == "decoder":
            if eps_z is None:
                eps_z = self._randn_rows(obs.shape[0], self.net.z_dim,
                                         generator, obs.device)
            mean, std, _, _ = self.net.act_stats(obs, obs_history,
                                                 privileged_obs, eps_z)
            values = self.value(obs, privileged_obs, base_vel)
        else:
            mean, std, values = self.net(obs, obs)
        return dict(self._sample(mean, std, eps_a, generator), values=values)

    @torch.no_grad()
    def act_recurrent(self, obs, carry_a, carry_c,
                      generator: torch.Generator | None = None, eps_a=None):
        """One recurrent acting step (ppo.py:103-110): (stats, carry_a,
        carry_c) with the carries advanced by obs; eps_a (N, num_actions)
        is the action draw, from `generator` when None."""
        mean, std, values, carry_a, carry_c = self.net(obs, obs, carry_a,
                                                       carry_c)
        return (dict(self._sample(mean, std, eps_a, generator),
                     values=values), carry_a, carry_c)

    def replay(self, obs_seq, dones, init_a, init_c):
        """The recurrent net over a stored (T, M, D) rollout from the
        rollout-start carries (ppo.py:112-129): dones[t] is the done that
        env.step returned at step t, so the carries are zeroed after obs[t]
        is consumed, as the collection resets them.  Returns (mean, std,
        value) stacked over T."""
        def step(carry, obs):
            mean, std, value, ca, cc = self.net(obs, obs, *carry)
            return (ca, cc), (mean, std, value)
        init = (init_a, init_c)
        _, out = rnn_replay(step, init, obs_seq, dones,
                            tree_map(torch.zeros_like, init))
        return out

    def compute_gae(self, rewards, dones, values, last_values):
        """compute_returns (rollout_storage.py:138-152): rewards/dones/values
        (T, N), last_values (N,) -> (returns, normalized advantages)."""
        gamma, lam = self.alg.gamma, self.alg.lam
        T = rewards.shape[0]
        not_terminal = 1.0 - dones.float()
        advs = torch.empty_like(values)
        adv = torch.zeros_like(last_values)
        for t in reversed(range(T)):
            next_val = last_values if t == T - 1 else values[t + 1]
            delta = rewards[t] + not_terminal[t] * gamma * next_val - values[t]
            adv = delta + not_terminal[t] * gamma * lam * adv
            advs[t] = adv
        returns = advs + values
        if not pmesh.spans(self.shard):
            advantages = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
            return returns, advantages
        # the global mean and std, in two passes as std(correction=0)
        count = advs.numel() * self.world
        m = pmesh.all_sum(advs.sum(), self.shard) / count
        var = pmesh.all_sum(torch.square(advs - m).sum(), self.shard) / count
        return returns, (advs - m) / (torch.sqrt(var) + 1e-8)

    # ---------------- update ----------------
    def _pol_terms(self, mean, std, value, mb, count=None):
        """(loss, surrogate, value loss, entropy, mean KL) (ppo.py:265-335).
        Sharded, each mean is this rank's share of the mean over `count`
        rows in all (default: the same rows on every rank)."""
        alg = self.alg

        def avg(x):
            return pmesh.mean(x, self.shard, count)
        log_prob = normal_log_prob(mean, std, mb["actions"])
        ratio = torch.exp(log_prob - mb["old_log_prob"])
        adv = mb["advantages"]
        surr = -adv * ratio
        surr_clipped = -adv * torch.clamp(ratio, 1.0 - alg.clip_param,
                                          1.0 + alg.clip_param)
        surrogate_loss = avg(torch.maximum(surr, surr_clipped))
        if alg.use_clipped_value_loss:                    # ppo.py:318-323
            v_clipped = mb["values"] + torch.clamp(
                value - mb["values"], -alg.clip_param, alg.clip_param)
            value_loss = avg(torch.maximum(
                torch.square(value - mb["returns"]),
                torch.square(v_clipped - mb["returns"])))
        else:
            value_loss = avg(torch.square(mb["returns"] - value))
        entropy = avg(normal_entropy(std))
        loss = (surrogate_loss + alg.value_loss_coef * value_loss
                - alg.entropy_coef * entropy)
        kl = torch.sum(
            torch.log(std / mb["old_sigma"] + 1e-5)
            + (torch.square(mb["old_sigma"]) + torch.square(mb["old_mu"] - mean))
            / (2.0 * torch.square(std)) - 0.5, dim=-1)
        return loss, surrogate_loss, value_loss, entropy, avg(kl)

    def _vae_loss(self, parts, mb):
        alg = self.alg
        recons, vel, kld, height = parts
        loss = recons + vel + alg.kld_weight * kld + height
        if alg.belief_loss_coef > 0.0:
            loss = loss + alg.belief_loss_coef * self.net.belief_loss(
                mb["obs_history"], mb["privileged_obs"])
        return loss

    def joint_grads(self, mb, eps_vae, eps_pol):
        """The fused step's forward and both gradients at the same params
        (ppo.py:402-443): returns (vae parts, policy terms, VAE gradients
        over the vae subtree, policy gradients over every parameter)."""
        net = self.net
        with torch.enable_grad():
            parts, mean, std, value = net.joint_forward(
                mb["obs"], mb["obs_history"], mb["privileged_obs"],
                mb["next_obs"], mb["base_vel"], eps_vae, eps_pol)
            pol = self._pol_terms(mean, std, value, mb)
            vae_grads = torch.autograd.grad(
                self._vae_loss(parts, mb), self.vae_optimizer.params,
                retain_graph=True, allow_unused=True)
            grads = torch.autograd.grad(pol[0], self.optimizer.params,
                                        allow_unused=True)
        return parts, pol, vae_grads, grads

    def _sequential_step(self, mb, eps_vae, eps_pol):
        """The reference's order (ppo.py:444-483): VAE loss, VAE optimizer
        step, then the policy loss at the updated VAE params."""
        net = self.net
        with torch.enable_grad():
            parts = net.vae_losses(mb["obs_history"], mb["privileged_obs"],
                                   mb["next_obs"], mb["base_vel"], eps_vae)
            vae_grads = torch.autograd.grad(
                self._vae_loss(parts, mb), self.vae_optimizer.params,
                allow_unused=True)
        self.vae_optimizer.step(vae_grads, self.alg.vae_learning_rate)
        with torch.enable_grad():
            mean, std, _, _ = net.act_stats(mb["obs"], mb["obs_history"],
                                            mb["privileged_obs"], eps_pol)
            value = net.evaluate(mb["obs"], mb["privileged_obs"],
                                 mb["base_vel"])
            pol = self._pol_terms(mean, std, value, mb)
            grads = torch.autograd.grad(pol[0], self.optimizer.params,
                                        allow_unused=True)
        return parts, pol, grads

    def _step_main(self, pol, parts, grads, lr, stats):
        """The main optimizer's step at the adaptive-KL rate from the
        minibatch's terms (summed over the ranks: every rank reads the
        global KL); appends the step's stats and returns the rate."""
        _, surr, value_loss, entropy, kl = pol
        terms = pmesh.all_sum(torch.stack([value_loss, surr, entropy, kl,
                                           *parts]).detach(), self.shard)
        lr = self.adapt_lr(lr, terms[3])
        self.optimizer.step(grads, lr)
        stats.append(torch.cat([terms, lr.reshape(1)]))
        return lr

    def adapt_lr(self, lr, kl):
        """Adaptive-KL learning rate (ppo.py:300-307), on the device."""
        alg = self.alg
        if alg.schedule == "adaptive" and alg.desired_kl is not None:
            lr = torch.where(kl > alg.desired_kl * 2.0,
                             torch.clamp(lr / 1.5, min=1e-5), lr)
            lr = torch.where((kl < alg.desired_kl / 2.0) & (kl > 0),
                             torch.clamp(lr * 1.5, max=1e-2), lr)
        return lr

    def draw(self, T: int, N: int, generator: torch.Generator, device):
        """The update's random draws: the group permutation of each stratum
        (S, rows_s // G) and, for the decoder (else None), the standard
        normal latent draws (steps, 2, minibatch rows, z_dim), [:, 0] for
        the VAE head and [:, 1] for the policy.  N is the global env
        count: every rank draws them whole."""
        alg = self.alg
        S, rows_s, _, G = shuffle_layout(alg, T, N, self.world)
        perm = torch.stack([torch.randperm(rows_s // G, generator=generator,
                                           device=device) for _ in range(S)])
        if self.policy_kind != "decoder":
            return perm, None
        steps = alg.num_learning_epochs * alg.num_mini_batches
        eps = torch.randn((steps, 2, T * N // alg.num_mini_batches,
                           self.net.z_dim), generator=generator, device=device)
        return perm, eps

    def draw_recurrent(self, N: int, generator: torch.Generator, device):
        """The recurrent update's draw (ppo.py:179-181): a fresh permutation
        of the N envs each epoch, cut to nmb * (N // nmb) and split into the
        nmb minibatches: (epochs * nmb, N // nmb) env indices."""
        alg = self.alg
        nmb = alg.num_mini_batches
        mb_envs = N // nmb
        return torch.cat([
            torch.randperm(N, generator=generator, device=device)
            [:nmb * mb_envs].reshape(nmb, mb_envs)
            for _ in range(alg.num_learning_epochs)])

    def _global_n(self, n_local: int) -> int:
        return n_local * self.world

    def shuffle(self, batch: dict, perm) -> dict:
        """The batch permuted once for the whole update (ppo.py:307-346):
        rows in an (S * rows_s) layout — stratum s is env block s over all
        T steps, time-major (S=1: the flat batch, no copy) — with each
        stratum permuted in groups of G by its row of perm (S, rows_s // G),
        all fields in one gather (K9 on the card).  Sharded, the batch is
        the rank's envs, which are whole strata: it takes their rows of
        the global perm."""
        T, N = batch["values"].shape
        total = T * N
        S, rows_s, _, G = shuffle_layout(self.alg, T, self._global_n(N),
                                         self.world)
        dev = batch["values"].device
        C_s = rows_s // G
        perm = perm.to(device=dev, dtype=torch.int64).reshape(S, C_s)
        if self.shard is not None:
            S //= self.world                     # this rank's strata
            perm = perm[self.shard.rank * S:(self.shard.rank + 1) * S]
        if S == 1:
            flat = {k: x.reshape((total,) + x.shape[2:])
                    for k, x in batch.items()}
            gperm = perm.reshape(-1)
        else:
            flat = {k: x.reshape((T, S, N // S) + x.shape[2:]).transpose(0, 1)
                    .reshape((total,) + x.shape[2:]) for k, x in batch.items()}
            gperm = (perm + C_s * torch.arange(S, device=dev)[:, None]
                     ).reshape(-1)
        return cuda_gather.permute_groups(flat, gperm, G)

    def minibatch(self, flat: dict, i: int, S: int) -> dict:
        """Minibatch step i of a batch shuffled in S strata: an equal
        contiguous slice of every stratum (S=1: a plain slice, no copy)."""
        total = next(iter(flat.values())).shape[0]
        nmb = self.alg.num_mini_batches
        rows_s = total // S
        mb_s = rows_s // nmb
        off = (i % nmb) * mb_s
        return {k: x.reshape((S, rows_s) + x.shape[1:])[:, off:off + mb_s]
                .reshape((S * mb_s,) + x.shape[1:]) for k, x in flat.items()}

    @torch.no_grad()
    def update(self, batch: dict, generator: torch.Generator | None = None,
               perm=None, eps=None) -> dict:
        """5 epochs x 4 minibatches over the flattened batch (PPO.update,
        ppo.py:247-516), updating the net, both optimizers and the learning
        rate in place.

        batch: (T, N, ...) fields obs, next_obs, privileged_obs,
        obs_history, base_vel, actions, values, returns, advantages,
        old_log_prob, old_mu, old_sigma.  perm (S, rows_s // G) and eps
        (steps, 2, minibatch rows, z_dim; the decoder's only) as `draw`
        makes them from `generator` when not given.  The MLP net's step is
        the policy step alone (ppo.py:445-472), its VAE stats zeros.
        Returns the nine stats (STAT_NAMES), 0-d tensors averaged over the
        minibatch steps."""
        alg = self.alg
        T, N = batch["values"].shape
        dev = batch["values"].device
        S = shuffle_layout(alg, T, self._global_n(N), self.world)[0]
        decoder = self.policy_kind == "decoder"
        if perm is None or (decoder and eps is None):
            dperm, deps = self.draw(T, self._global_n(N), generator, dev)
            perm = dperm if perm is None else perm
            eps = deps if eps is None else eps
        flat = self.shuffle(batch, perm)
        S //= self.world
        if decoder and self.shard is not None:
            # this rank's rows of each minibatch: its strata's slices
            m = T * N // alg.num_mini_batches
            eps = eps[:, :, self.shard.rank * m:(self.shard.rank + 1) * m]
        lr = self.learning_rate
        zeros = (torch.zeros((), device=dev),) * 4
        stats = []
        for i in range(alg.num_learning_epochs * alg.num_mini_batches):
            mb = self.minibatch(flat, i, S)
            e_vae, e_pol = (eps[i, 0], eps[i, 1]) if decoder else (None, None)
            if HALF_BATCH:
                h = next(iter(mb.values())).shape[0] // 2
                mb = {k: v[:h] for k, v in mb.items()}
                if decoder:
                    e_vae, e_pol = e_vae[:h], e_pol[:h]
            if not decoder:
                with torch.enable_grad():
                    mean, std, value = self.net(mb["obs"], mb["obs"])
                    pol = self._pol_terms(mean, std, value, mb)
                    grads = torch.autograd.grad(pol[0], self.optimizer.params,
                                                allow_unused=True)
                parts = zeros
            elif alg.fused_joint_step:
                parts, pol, vae_grads, grads = self.joint_grads(
                    mb, e_vae, e_pol)
                self.vae_optimizer.step(vae_grads, alg.vae_learning_rate)
            else:
                parts, pol, grads = self._sequential_step(mb, e_vae,
                                                          e_pol)
            lr = self._step_main(pol, parts, grads, lr, stats)
        self.learning_rate = lr
        means = torch.stack(stats).mean(dim=0)
        return dict(zip(STAT_NAMES, means.unbind()))

    def recurrent_grads(self, batch: dict, idx, count=None):
        """One recurrent minibatch (ppo.py:183-216): the envs idx of every
        field, taken on the env axis (axis 0 of the carries), the replay
        and its policy terms; returns (terms, gradients over every
        parameter) as _pol_terms and joint_grads give them.  count: the
        minibatch's (T, envs) rows over all ranks (sharded)."""
        mb = {k: tree_map(lambda x: x.index_select(
                  0 if k.startswith("init_carry") else 1, idx), v)
              for k, v in batch.items()}
        with torch.enable_grad():
            mean, std, value = self.replay(mb["obs"], mb["dones"],
                                           mb["init_carry_a"],
                                           mb["init_carry_c"])
            pol = self._pol_terms(mean, std, value, mb, count)
            grads = torch.autograd.grad(pol[0], self.optimizer.params,
                                        allow_unused=True)
        return pol, grads

    @torch.no_grad()
    def update_recurrent(self, batch: dict,
                         generator: torch.Generator | None = None,
                         env_idx=None) -> dict:
        """Recurrent PPO update (ppo.py:167-244): each minibatch takes its
        envs on the env axis of every (T, N, ...) field and of the
        rollout-start carries (N, H), replays the net over the T steps
        (BPTT through the carries) and steps the main optimizer at the
        adaptive-KL rate; no VAE step, its four stats zeros.

        batch: obs, actions, values, returns, advantages, old_log_prob,
        old_mu, old_sigma, dones (T, N) and init_carry_a/init_carry_c.
        env_idx (epochs * nmb, N // nmb) as `draw_recurrent` makes it from
        `generator` when None (global env indices; a rank replays those of
        its block, any number of them, zero included).  The value loss
        honours use_clipped_value_loss (the JAX update always clips).
        Returns the nine stats (STAT_NAMES), averaged over the minibatch
        steps."""
        T, N = batch["values"].shape
        dev = batch["values"].device
        if env_idx is None:
            env_idx = self.draw_recurrent(self._global_n(N), generator, dev)
        env_idx = env_idx.to(device=dev, dtype=torch.int64)
        lr = self.learning_rate
        zeros = (torch.zeros((), device=dev),) * 4
        stats = []
        count = None
        if self.shard is not None:
            count = T * env_idx.shape[1]
            mine = ((env_idx >= self.shard.row0)
                    & (env_idx < self.shard.row0 + N)).cpu()
        for i, idx in enumerate(env_idx):
            if self.shard is not None:
                idx = idx[mine[i].to(dev)] - self.shard.row0
            if HALF_BATCH:
                idx = idx[:idx.shape[0] // 2]
            pol, grads = self.recurrent_grads(batch, idx, count)
            lr = self._step_main(pol, zeros, grads, lr, stats)
        self.learning_rate = lr
        means = torch.stack(stats).mean(dim=0)
        return dict(zip(STAT_NAMES, means.unbind()))
