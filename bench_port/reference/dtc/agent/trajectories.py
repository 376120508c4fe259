"""Trajectory utilities for recurrent training.

Counterpart of the JAX package's agent/trajectories.py (rsl_rl
utils/utils.py:33-69 split_and_pad_trajectories / unpad_trajectories),
plus `rnn_replay`, which re-runs a recurrent cell over a stored (T, N)
rollout and resets the carry where an episode ended: each env column is
one padded trajectory stream whose hidden state restarts after every done,
the static-shape equivalent of split-at-dones + padded-batch replay
(rollout_storage.py:217-267).  PPO.replay runs the recurrent policy
through it.

A carry is a tensor or a tuple of tensors (the LSTM's (c, h)).
"""
from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """fn over the leaves of tensors or (nested) tuples of tensors."""
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def split_and_pad_trajectories(tensor, dones):
    """Split env sequences at dones and pad to T (static shapes).

    tensor: (T, N, ...); dones: (T, N) bool.  Returns (padded (T, M, ...),
    masks (T, M)) with M = N * T, a static bound on the trajectory count:
    slot n*T + k holds trajectory k of env n, which starts one step after
    its (k-1)-th done and runs through its k-th done (or T); empty slots
    have all-False masks (utils.py:33-64)."""
    T, N = dones.shape[:2]
    dev = dones.device
    shifted = torch.cat([torch.zeros((1, N), dtype=torch.long, device=dev),
                         dones[:-1].long()])
    traj_id = torch.cumsum(shifted, dim=0)                 # (T, N) in [0, T)
    # position within the trajectory: t minus the step it started at
    t = torch.arange(T, device=dev)[:, None].expand(T, N)
    start = torch.cummax(torch.where(shifted.bool(), t, 0), dim=0).values
    pos = t - start
    slot = torch.arange(N, device=dev)[None, :] * T + traj_id
    out = torch.zeros((T, N * T) + tensor.shape[2:], dtype=tensor.dtype,
                      device=dev)
    mask = torch.zeros((T, N * T), dtype=torch.bool, device=dev)
    out[pos, slot] = tensor
    mask[pos, slot] = True
    return out, mask


def unpad_trajectories(padded, masks):
    """Inverse of split_and_pad_trajectories (utils.py:66-69): the valid
    entries of each env's slots back in a dense (T, N, ...) block in time
    order.  Needs the masks split_and_pad_trajectories made."""
    T, M = masks.shape
    N = M // T
    dev = masks.device
    flat = padded.reshape((T, N, T) + padded.shape[2:])
    m = masks.reshape(T, N, T)
    lens = m.sum(dim=0)                                    # (N, T) per slot
    starts = torch.cumsum(lens, dim=1) - lens
    t_global = starts[None] + torch.arange(T, device=dev)[:, None, None]
    env = torch.arange(N, device=dev)[None, :, None].expand(T, N, T)
    vals = torch.where(m.reshape(m.shape + (1,) * (padded.ndim - 2)), flat,
                       torch.zeros((), dtype=padded.dtype, device=dev))
    out = torch.zeros((T, N) + padded.shape[2:], dtype=padded.dtype,
                      device=dev)
    return out.index_put_((t_global.clamp(0, T - 1), env), vals,
                          accumulate=True)


def rnn_replay(cell_apply, init_carry, xs_seq, dones, reset_carry):
    """Replay a recurrent cell over a stored rollout with in-sequence
    resets.

    cell_apply(carry, x) -> (carry, out), out a tensor or a tuple of them;
    dones: (T, N) episode ends AFTER each step, so the carry is replaced by
    reset_carry after consuming xs_seq[t].  Returns (final carry, outs
    stacked over T)."""
    carry, outs = init_carry, []
    for x, done in zip(xs_seq, dones):
        carry, out = cell_apply(carry, x)
        carry = tree_map(
            lambda c, r: torch.where(
                done.reshape(done.shape + (1,) * (c.ndim - 1)), r, c),
            carry, reset_carry)
        outs.append(out)
    return carry, tree_map(lambda *o: torch.stack(o), *outs)
