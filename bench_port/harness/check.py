"""The comparison that decides `correct`: what the program's checked calls
left at their boundaries (harness/program.py Capture) judged by the plain
reference (bench_port/reference), after the window, at the cell's sizes.

The weights are the benchmark's (harness/weights.py), loaded into both
sides.  The start is checked by itself: the reference builds the terrain
and inits the env from the seed, and these must equal the program's.

Each checked call is then followed from the program's state at its start:
the reference re-steps the call's whole rollout from the program's env
state and generator, with the program's actions and the same draws, on its
own env state.  Contact physics at tens of thousands of envs parts at
float32 rounding in a few rows a step, which then stay apart; so the first
step of each call, which starts from the program's exact state, is judged
by itself.  Its acts take the program's inputs from the batch and the
generator as the rollout reaches them; its updates take the program's
batch and generator, with the reference's own weights, optimizer moments
and learning rate, carried from the benchmark's weights through its own
updates.

The reference net is the configuration's policy (KINDS, the port's own
mapping): the decoder acts on the obs, history, privileged obs and base
velocity, the MLP on the obs alone, the recurrent net (GRU or LSTM) on
the obs and its carries, which start each call from the program's
rollout-start carries and restart from zero at the program's dones, as
the collect restarts them (the dones are inputs, as the obs are: where
contact physics parts a row, the reference's own dones part with it, and
the batch's dones are held to the reference's by themselves); its update
replays the cells over the rollout (update_recurrent).  A carry is
judged where any implementation keeps it: at the end of each call's
rollout, against the program's next rollout-start carries and, after the
last call, the runner's.  Those carries run on the program's weights as
the call started (for the first call the benchmark's, which both sides
share; for the later ones the program's after its updates, which the
update's numbers judge by themselves).

What a sound rewrite of the networks' products (the witness: the same
sums in another order) leaves equal is what the numbers compare.  Adam
from this init moves weights whose gradient is nought to rounding by a
whole step of either sign, and the adaptive rate follows the KL, so from
the first minibatch step on the two runs part: the acts of the calls after
the first, the losses of a call's 20 minibatch steps and the weights'
change over the calls part as far for the witness as for the faults
(PERF.md gives the readings).  So the acts are compared in the first call,
on the weights both sides share, and the update at its first step.

The numbers (each against its limit in bench_port/limits/<cell>.json):
  start_gap         largest absolute difference of the terrain heightfield
                    and tile origins, of the weights as loaded and of the
                    env state after init (exact: the same plain operations
                    on the same draws)
  step_rows_off     % of env rows of the first step of the checked calls
                    whose next obs, privileged obs, obs history or base
                    velocity of the program lie beyond the reference's by
                    more than 1e-3 + rtol |reference| (rtol 1e-3, and 1e-2
                    for the fields the batch keeps in bf16)
  rollout_rows_off  the same over every step of the rollouts, and the
                    rewards and advantages: the program's rewards of the
                    steps before a rollout's last read back from its returns
                    and values through the reference's dones (so they check
                    its GAE), the last step's, with its done flag, from the
                    env state after the rollout, and its advantages against
                    the reference's normalization of its returns less its
                    values; for the recurrent policy the dones the batch
                    keeps and the carries at the end of each rollout, at
                    CARRY_TOL (a batch without the privileged obs, history
                    and base velocity is judged on its obs until the last
                    step).  A network stand-in reads the % of envs whose
                    carries part after the first call
  act_gap           the first call's acts: the largest gap of the actions,
                    values, log probabilities and means over the largest
                    reference value of each field
  grad_gap          worst leaf, over the optimizers the reference stepped
                    (both for the decoder, the main one for the others), of
                    the gap between the norms of the first gradient as the
                    optimizer got it (from its first moment after its first
                    step), over the reference's leaf norm or the median
                    leaf's (over those optimizers), whichever is larger
  unmoved_leaves    % of the leaves that the reference moves over the checked
                    calls which the program leaves where they were (moved by
                    under a thousandth of the reference's change)
Both leave out the leaves whose reference first gradient is under a
thousandth of the median leaf's: nought to rounding, they move under Adam
by round-off alone.
"""
from __future__ import annotations

import contextlib
import copy
import math

import torch

from counts.flops import KINDS

NUMBERS = ("start_gap", "step_rows_off", "rollout_rows_off", "act_gap",
           "grad_gap", "unmoved_leaves")
TOL = 1e-3                 # atol, and rtol of float32 fields
BF16_RTOL = 1e-2           # rtol of the fields the batch keeps in bf16
# atol and rtol of a recurrent carry: after a rollout's 24 steps float32
# cells lie within 6e-7 of float64 ones, cells with TF32 products 1.2e-3
# away (GRU 256 and LSTM 512 at the benchmark's weights)
CARRY_TOL = 1e-4
NEXT_FIELDS = ("obs", "privileged_obs", "obs_history", "base_vel")
ACT_FIELDS = {"actions": "actions", "values": "values",
              "log_prob": "old_log_prob", "mu": "old_mu"}
MOVE_FLOOR = 1e-3
STEP_FAULTS = ("step_unchanged", "step_half")
NET_MODES = ("control", "witness", "half_batch")
CARRIES = ("carry_a", "carry_c")


def _dev(x, device):
    if isinstance(x, dict):
        return {k: _dev(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_dev(v, device) for v in x)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


def _gen(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def abs_max(got, want) -> float:
    got = torch.as_tensor(got).double()
    want = torch.as_tensor(want).double().to(got.device)
    if got.shape != want.shape:
        return math.inf
    return float((got - want).abs().max()) if got.numel() else 0.0


def _tree_abs_max(a, b) -> float:
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return math.inf
        return max((_tree_abs_max(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, torch.Tensor):
        return abs_max(a, b)
    return 0.0 if a == b else math.inf


def _median(xs):
    s = sorted(xs)
    return s[(len(s) - 1) // 2] if s else 0.0


def norm_gaps(got: list, want: list, med: float) -> float:
    """Worst leaf of |got - want| over max(want, med)."""
    worst = 0.0
    for g, w in zip(got, want):
        d = abs(g - w)
        if math.isnan(d):
            return math.inf
        worst = max(worst, _ratio(d, max(w, med)))
    return worst


def moment_norms(sd: dict, names: list, b1: float) -> list:
    """Leaf norms of an optimizer state_dict's bias-corrected first moment
    (zero before any step; a leaf it lacks reads nan)."""
    count = int(sd["count"])
    corr = 1.0 - b1 ** count
    out = []
    for n in names:
        v = sd["mu"].get(n)
        out.append(math.nan if v is None else
                   (float(v.double().norm()) / corr if count else 0.0))
    return out


class Reference:
    """The reference's env and net for one cell and seed."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, device):
        from reference.dtc.agent.ppo import PPO
        from reference.dtc.env.config import TaskCfg, TrainCfg
        from reference.dtc.env.legged_env import LeggedEnv
        from . import config as hc
        self.device = torch.device(device)
        self.seed = seed
        self.mix = mix
        task, self.train = hc.task_and_train(cfg_file, TaskCfg, TrainCfg,
                                             mix["num_envs"], seed)
        self.env = LeggedEnv(task, terrain_seed=seed, device=self.device)
        self.PPO = PPO
        self.kind = KINDS.get(self.train.policy.policy_class_name)
        self._net = None

    def make_net(self):
        """The configuration's policy, from the reference's own classes,
        with the benchmark's weights."""
        from reference.dtc.models import networks
        from . import weights
        if self._net is None:
            pol, env = self.train.policy, self.env
            heads = dict(actor_hidden=tuple(pol.actor_hidden_dims),
                         critic_hidden=tuple(pol.critic_hidden_dims),
                         activation=pol.activation,
                         init_noise_std=pol.init_noise_std)
            if self.kind == "decoder":
                net = networks.ActorCriticDecoder(
                    num_obs=env.num_obs,
                    num_privileged_obs=env.num_privileged_obs,
                    num_actions=env.num_actions,
                    obs_history_dim=env.num_obs_history,
                    terrain_dim=env.num_height_points,
                    terrain_latent=pol.terrain_latent, z_dim=pol.cenet_latent,
                    outlier_filter=pol.outlier_filter, **heads)
            elif self.kind == "mlp":
                net = networks.ActorCritic(
                    num_obs=env.num_obs, num_critic_obs=env.num_obs,
                    num_actions=env.num_actions, **heads)
            elif self.kind == "recurrent":
                net = networks.ActorCriticRecurrent(
                    num_obs=env.num_obs, num_critic_obs=env.num_obs,
                    num_actions=env.num_actions,
                    rnn_hidden_size=pol.rnn_hidden_size,
                    rnn_type=pol.rnn_type, **heads)
            else:
                raise ValueError(f"the reference has no policy "
                                 f"{pol.policy_class_name!r}: one of "
                                 f"{sorted(KINDS)}")
            self._net = net.to(self.device)
            weights.load(self._net, self.seed, pol.init_noise_std)
        return copy.deepcopy(self._net)

    def init(self):
        gen = torch.Generator(self.device).manual_seed(self.seed + 1)
        return self.env.init(gen)


def check_start(ref: Reference, cap) -> tuple:
    """start_gap and the reference's env params."""
    gaps = []
    if cap.terrain is not None:
        hf, origins = cap.terrain
        gaps.append(abs_max(torch.from_numpy(hf.astype("int64")),
                            torch.from_numpy(ref.env.terrain.height_field_raw
                                             .astype("int64"))))
        gaps.append(abs_max(torch.from_numpy(origins),
                            torch.from_numpy(ref.env.terrain.env_origins)))
    want = {n: p.detach().cpu() for n, p in ref.make_net().named_parameters()}
    gaps.append(_tree_abs_max(cap.params0, want))
    params, state = ref.init()
    gaps.append(_tree_abs_max(cap.state0, _dev(state, "cpu")))
    return max(gaps), params


@contextlib.contextmanager
def mode(name: str):
    """The reference's switches for a follower: "reference" (none),
    "control" (float8 operands of the bf16 products, TF32 of the float32
    ones), "witness" (padded products, fused bias) or "half_batch" (each
    minibatch's second half left out)."""
    from reference.dtc.agent import ppo as rppo
    from reference.dtc.models import networks as rnet
    rnet.LOWER = torch.float8_e4m3fn if name == "control" else None
    rnet.TF32 = name == "control"
    rnet.WITNESS = name == "witness"
    rppo.HALF_BATCH = name == "half_batch"
    try:
        yield
    finally:
        rnet.LOWER, rnet.TF32, rnet.WITNESS = None, False, False
        rppo.HALF_BATCH = False


class Follower:
    """A reference net and PPO carried through the checked calls in one
    mode, with what it produced: the optimizers' state after their first
    step and the weights at the start and the end; a recurrent one also
    threads its carries (`carries`, set by the caller at each call's
    start)."""

    def __init__(self, ref: Reference, name: str):
        self.name = name
        self.kind = ref.kind
        self.net = ref.make_net()
        self.ppo = ref.PPO(net=self.net, alg=ref.train.algorithm,
                           policy_kind=ref.kind)
        self.params0 = {n: p.detach().cpu().clone()
                        for n, p in self.net.named_parameters()}
        self.first_step, self.params_end = {}, None
        self.carries = None
        for n in ("optimizer", "vae_optimizer"):
            opt = getattr(self.ppo, n)
            opt.step = self._first(n, opt, opt.step)

    def _first(self, name, opt, step):
        def inner(*a, **k):
            step(*a, **k)
            if name not in self.first_step:
                self.first_step[name] = _dev(opt.state_dict(), "cpu")
        return inner

    def act(self, batch: dict, t: int, gen):
        """The stats of step t of the rollout from the program's inputs."""
        with mode(self.name):
            if self.kind == "recurrent":
                out, ca, cc = self.ppo.act_recurrent(batch["obs"][t],
                                                     *self.carries, gen)
                self.carries = (ca, cc)
                return out
            if self.kind == "mlp":
                return self.ppo.act(batch["obs"][t], None, None, None, gen)
            return self.ppo.act(batch["obs"][t], batch["obs_history"][t],
                                batch["privileged_obs"][t],
                                batch["base_vel"][t], gen)

    def reset(self, done):
        """Zero the carries of the envs whose step returned done."""
        self.carries = restart(self.carries, done)

    def update(self, batch, gen_state, device):
        with mode(self.name):
            up = (self.ppo.update_recurrent if self.kind == "recurrent"
                  else self.ppo.update)
            up(batch, _gen(gen_state, device))

    def finish(self):
        self.params_end = {n: p.detach().cpu().clone()
                           for n, p in self.net.named_parameters()}


def restart(carries: tuple, done) -> tuple:
    """The carries (carry_a, carry_c; each a tensor or the LSTM's (c, h))
    with the rows of `done` zeroed."""
    from reference.dtc.agent.trajectories import tree_map
    return tuple(tree_map(lambda c: torch.where(done[:, None], 0.0, c), x)
                 for x in carries)


def _flat(carry) -> torch.Tensor:
    """A carry's leaves side by side, (N, H) or (N, 2H)."""
    return torch.cat(carry, dim=-1) if isinstance(carry, tuple) else carry


class Carrier:
    """The reference's memories on the program's weights as a call starts,
    threading the carries over the call's obs and dones."""

    def __init__(self, ref: Reference):
        self.net = ref.make_net()

    @torch.no_grad()
    def start(self, params: dict, batch: dict):
        for n, p in self.net.named_parameters():
            p.copy_(params[n])
        self.carries = (batch["init_carry_a"], batch["init_carry_c"])

    @torch.no_grad()
    def step(self, obs, done):
        m = self.net
        self.carries = restart((m.memory_a(obs, self.carries[0])[0],
                                m.memory_c(obs, self.carries[1])[0]), done)


def _off(got: dict, want: dict, tol: float = TOL) -> torch.Tensor:
    """(N,) rows where a field of `got` lies beyond `want` by more than
    tol + rtol |want| (rtol: tol, or BF16_RTOL for a bf16 field of
    `got`)."""
    off = None
    for f, g in got.items():
        w = want[f]
        rtol = BF16_RTOL if g.dtype == torch.bfloat16 else tol
        d = (g.float() - w.float()).abs() > tol + rtol * w.float().abs()
        d = d.reshape(d.shape[0], -1).any(dim=1)
        off = d if off is None else off | d
    return off


def _mark(rows: torch.Tensor, off: torch.Tensor, field: str,
          detail: dict) -> int:
    """Add the rows `off` to `rows` in place; count the new ones in
    detail's first_off_field under `field`; returns their number."""
    n = int((off & ~rows).sum())
    if n:
        counts = detail["first_off_field"]
        counts[field] = counts.get(field, 0) + n
    rows |= off
    return n


def follow(ref: Reference, params, cap, names=(), faults=()) -> tuple:
    """The reference's followers ("reference" and `names` of NET_MODES)
    through the checked calls; returns (followers by name, the program's
    numbers of the rollout and its acts, {fault: numbers} of `faults` of
    STEP_FAULTS judged in the program's place, detail: the rows that
    first part at each step, by the field that parts first)."""
    dev = ref.device
    fs = {n: Follower(ref, n) for n in ("reference",) + tuple(names)}
    alg = ref.train.algorithm
    gamma, lam = alg.gamma, alg.lam
    train = ref.mix["phase"] == "train"
    carrier = Carrier(ref) if ref.kind == "recurrent" else None
    carry_rows = {}                 # stand-in: % of envs, first call
    who = ("program",) + tuple(faults)
    first_rows = dict.fromkeys(who, 0)          # rows off at a call's step 0
    all_rows = dict.fromkeys(who, 0)            # rows off at any step
    detail = dict(first_off_step=[], first_off_field={})
    for i in range(cap.calls):
        batch = _dev(cap.batch[i], dev)
        state = _dev(cap.states[i], dev)
        after = _dev(cap.states[i + 1], dev)
        gen = _gen(cap.gen[i], dev)
        T, N = batch["values"].shape
        fields = [f for f in NEXT_FIELDS if f in batch]
        if carrier is not None:
            for f in fs.values():
                f.carries = (batch["init_carry_a"], batch["init_carry_c"])
            carrier.start(_dev(cap.params_at[i], dev), batch)
        rews, dones = [], []
        rows = {k: torch.zeros(N, dtype=torch.bool, device=dev) for k in who}
        diff = {n: dict.fromkeys(ACT_FIELDS, 0.0)
                for n in ("program",) + tuple(names)}
        rmax = dict.fromkeys(ACT_FIELDS, 0.0)
        for t in range(T):
            g0 = gen.get_state()
            outs = {}
            for n, f in fs.items():
                gen.set_state(g0)
                outs[n] = f.act(batch, t, gen)
            want = outs["reference"]
            outs["program"] = {k: batch[b][t] for k, b in ACT_FIELDS.items()}
            for k in ACT_FIELDS:
                rmax[k] = max(rmax[k], float(want[k].abs().max()))
                for n in diff:
                    diff[n][k] = max(diff[n][k], float(
                        (outs[n][k] - want[k]).abs().max()))
            state, out = ref.env.step(params, state, batch["actions"][t], gen)
            if carrier is not None:
                # the carries restart at the program's dones, an input of
                # the acts as its obs are (where its env parts from the
                # reference's, the reference's own dones part too); the
                # "dones" field below holds them to the reference's
                for f in fs.values():
                    f.reset(batch["dones"][t])
                carrier.step(batch["obs"][t], batch["dones"][t])
            # the next obs: the decoder's and MLP's batch keeps it; the
            # recurrent one's is the next step's obs
            nxt = batch.get("next_obs", batch["obs"][1:])
            if t < T - 1:
                got = {f: nxt[t] if f == "obs" else batch[f][t + 1]
                       for f in fields}
                step_off = {}
            else:
                got = {f: after[f] for f in NEXT_FIELDS}
                if "next_obs" in batch:
                    got["obs"] = batch["next_obs"][t]
                got["rew"] = after["rew_buf"]
                step_off = dict(done=after["reset_buf"].bool()
                                != out["done"].bool())
            if "dones" in batch:
                step_off["dones"] = (batch["dones"][t].bool()
                                     != out["done"].bool())
            step_off.update({f: _off({f: got[f]}, out) for f in got})
            fresh = sum(_mark(rows["program"], off, f, detail)
                        for f, off in step_off.items())
            before = {f: batch[f][t] for f in fields}
            fault_off = {}
            if "step_unchanged" in faults:
                fault_off["step_unchanged"] = _off(before, out)
            if "step_half" in faults:
                h = N // 2
                fault_off["step_half"] = _off(
                    {f: torch.cat([got[f][:h], before[f][h:]])
                     for f in fields}, out)
            if i == 0:
                detail["first_off_step"].append(fresh)
            else:
                detail["first_off_step"][t] += fresh
            for k, off in fault_off.items():
                rows[k] |= off
            if t == 0:
                for k in who:
                    first_rows[k] += int(rows[k].sum())
            rews.append(out["rew"] + gamma * batch["values"][t]
                        * out["time_out"])
            dones.append(out["done"])
        # the program's rewards of steps 0..T-2 from its returns and values
        # (advantages before normalization are returns less values)
        V = batch["values"]
        A = batch["returns"] - V
        nt = 1.0 - torch.stack(dones).float()
        r_prog = (A[:-1] - gamma * lam * nt[:-1] * A[1:]
                  - gamma * nt[:-1] * V[1:] + V[:-1])
        r_ref = torch.stack(rews[:-1])
        _mark(rows["program"], ((r_prog - r_ref).abs()
                                > TOL + TOL * r_ref.abs()).any(dim=0),
              "rew_from_returns", detail)
        norm = (A - A.mean()) / (A.std(correction=0) + 1e-8)
        _mark(rows["program"], ((batch["advantages"] - norm).abs()
                                > TOL + TOL * norm.abs()).any(dim=0),
              "advantages", detail)
        if carrier is not None:
            # the program's carries after the rollout: the next call's
            # rollout-start ones, or the runner's after the last call
            end = (_dev((cap.batch[i + 1]["init_carry_a"],
                         cap.batch[i + 1]["init_carry_c"]), dev)
                   if i + 1 < cap.calls else _dev(cap.carries_end, dev))
            for k, g, w in zip(CARRIES, end, carrier.carries):
                _mark(rows["program"], _off({k: _flat(g)}, {k: _flat(w)},
                                            CARRY_TOL), k, detail)
            if i == 0:
                # a network stand-in's carries after the first call (the
                # weights both sides share), in the program's place
                for n in names:
                    off = _off({k: _flat(c) for k, c in
                                zip(CARRIES, fs[n].carries)},
                               {k: _flat(w) for k, w in
                                zip(CARRIES, carrier.carries)}, CARRY_TOL)
                    carry_rows[n] = 100.0 * int(off.sum()) / N
        for k in who:
            all_rows[k] += int(rows[k].sum())
        if i == 0:
            act_gaps = {n: _act_gap(diff[n], rmax) for n in diff}
        if train:
            for f in fs.values():
                f.update(batch, cap.gen_update[i], dev)
        del batch, state, after
    for f in fs.values():
        f.finish()
    total = cap.calls * N
    per = {k: dict(step_rows_off=100.0 * first_rows[k] / total,
                   rollout_rows_off=100.0 * all_rows[k] / total) for k in who}
    nums = dict(per.pop("program"), act_gap=act_gaps["program"])
    for n in names:
        fs[n].act_gap = act_gaps[n]
        fs[n].carry_rows = carry_rows.get(n)
    return fs, nums, per, detail


def _ratio(d: float, scale: float) -> float:
    """d / scale; 0 / 0 reads 0, d / 0 infinite."""
    return d / scale if scale > 0 else (0.0 if d == 0 else math.inf)


def _act_gap(diff: dict, ref_max: dict) -> float:
    return max(_ratio(diff[k], ref_max[k]) for k in ACT_FIELDS)


def compare_update(got: dict, want: Follower) -> dict:
    """grad_gap and unmoved_leaves of `got` (first_step {optimizer:
    state_dict}, params0, params_end) against the reference follower.

    The optimizers are those the reference stepped (both for the decoder,
    the main one for the MLP and recurrent nets, whose VAE optimizer spans
    nothing).  The median leaf is taken over their leaves; a leaf whose
    reference first gradient is under MOVE_FLOOR of it is nought to
    rounding (the main optimizer spans the VAE's leaves too, which the
    PPO loss all but misses) and is left out of both numbers."""
    norms = {}
    for name in ("optimizer", "vae_optimizer"):
        if name not in want.first_step:
            continue
        opt = getattr(want.ppo, name)
        w = moment_norms(want.first_step[name], opt.names, opt.b1)
        g = (moment_norms(got["first_step"][name], opt.names, opt.b1)
             if name in got["first_step"] else [math.nan] * len(w))
        norms[name] = (opt.names, w, g)
    med = _median([x for _, w, _ in norms.values() for x in w])
    grad, moves = 0.0, {}
    for names, w, g in norms.values():
        kept = [i for i, x in enumerate(w) if x >= MOVE_FLOOR * med]
        grad = max(grad, norm_gaps([g[i] for i in kept],
                                   [w[i] for i in kept], med))
        for i in kept:
            moves[names[i]] = True
    moved = unmoved = 0
    for n, p0 in want.params0.items():
        dw = float((want.params_end[n] - p0).double().norm())
        if n not in moves or dw == 0:
            continue
        try:
            dg = float((got["params_end"][n].double()
                        - got["params0"][n].double()).norm())
        except (KeyError, RuntimeError):
            dg = 0.0
        moved += 1
        unmoved += dg <= MOVE_FLOOR * dw
    return dict(grad_gap=grad,
                unmoved_leaves=100.0 * unmoved / moved if moved else 0.0)


def judge(cfg_file: dict, mix: dict, seed: int, cap, device,
          stand_ins=()) -> tuple:
    """(numbers of the program, {stand-in: numbers}) for the captured
    calls.  stand_ins name what is judged in the program's place for the
    limits' readings: "control" (float8 operands of the bf16 products,
    TF32 of the float32 ones), "witness" (a sound
    rewrite of the products), "half_batch" (the update's fault),
    "step_unchanged" and "step_half" (the env step's faults)."""
    unknown = set(stand_ins) - set(NET_MODES) - set(STEP_FAULTS)
    if unknown:
        raise ValueError(f"stand-ins {sorted(unknown)}")
    if cap.calls == 0 or len(cap.batch) < cap.calls:
        raise RuntimeError("the checked calls ran no collect: the runner's "
                           "learn no longer calls runner.collect")
    ref = Reference(cfg_file, mix, seed, device)
    nums = {}
    nums["start_gap"], params = check_start(ref, cap)
    names = tuple(n for n in stand_ins if n in NET_MODES)
    faults = tuple(n for n in stand_ins if n in STEP_FAULTS)
    fs, rollout_nums, others, detail = follow(ref, params, cap, names,
                                              faults)
    nums.update(rollout_nums)
    want = fs["reference"]
    if mix["phase"] == "train":
        nums.update(compare_update(
            dict(first_step=cap.first_step, params0=cap.params0,
                 params_end=cap.params_end), want))
    for n in names:
        f = fs[n]
        others[n] = dict(act_gap=f.act_gap)
        if f.carry_rows is not None:
            others[n]["rollout_rows_off"] = f.carry_rows
        if mix["phase"] == "train":
            others[n].update(compare_update(vars(f), want))
    others["detail"] = detail
    return nums, others


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the numbers that have a
    limit; a number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        rows.append((name, v, limit))
    return ok, rows
