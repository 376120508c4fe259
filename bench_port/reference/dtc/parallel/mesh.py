"""The env axis split over torch.distributed ranks (data-parallel PPO).

Counterpart of the JAX package's parallel/mesh.py, which shards the env
axis of one program over a 1-D device mesh and lets GSPMD insert the
collectives.  Here each rank runs its own process: a contiguous block of
N / W envs (`EnvShard`), the params replicated, and the reductions over
envs or batch rows made global by the collectives below.

  * `shard_tree` / `gather_tree` split a global env state or params tree
    into a rank's block and back, by the JAX package's rule per leaf
    (mesh.py `_spec_for_leaf`): the physics groups are env-trailing, the
    env-logic arrays env-leading, everything else replicated.
  * `all_sum` sums a tensor over the ranks (outside autograd: stats,
    counts, gradients); `all_gather_rows` concatenates every rank's rows
    with autograd,
    written as an all_reduce of a zero-filled global buffer: gloo offers
    only broadcast and all_reduce on CUDA tensors, and adding zeros is
    exact.
  * `mean` is a tensor's share of the mean over every rank's rows.

Random draws stay independent of the layout because every rank draws at
the global shape from a generator in lockstep and keeps its own rows
(`rows`), and the noise kernels take the global row offset.  Without a
shard (None) or at one rank every helper is the identity, so a run
without a process group takes the unsharded path exactly.
"""
from __future__ import annotations

import dataclasses

import torch

ENV_TRAILING = frozenset({"phys", "anchors", "inertias", "body_pts", "planes",
                          "episode_sums"})


@dataclasses.dataclass(frozen=True)
class EnvShard:
    """Rank `rank` of `world` holds global envs [row0, row0 + n_local)."""
    rank: int
    world: int
    num_envs: int
    row0: int
    n_local: int

    @property
    def rows(self) -> slice:
        return slice(self.row0, self.row0 + self.n_local)


def make_shard(num_envs: int, world: int, rank: int) -> EnvShard:
    """The block of envs of `rank`.  Raises unless the world divides the
    env count into blocks of a multiple of 4 envs: the obs kernel draws a
    block's noise from the first Philox block of its first row, which is
    whole only where the row index is 0 mod 4 (csrc/obs.cu)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of world {world}")
    if num_envs % world:
        raise ValueError(f"{world} ranks do not divide {num_envs} envs")
    n = num_envs // world
    if n % 4:
        raise ValueError(f"{n} envs a rank: the obs kernel needs a multiple "
                         "of 4")
    return EnvShard(rank, world, num_envs, rank * n, n)


def spans(shard) -> bool:
    """True where the collectives do something: a shard of two or more
    ranks."""
    return shard is not None and shard.world > 1


def leaf_axis(path, leaf, num_envs):
    """The env axis of one leaf, by the JAX package's rule
    (parallel/mesh.py `_spec_for_leaf`): the last axis in a physics group,
    the first where it is num_envs long, else None (replicated)."""
    shape = getattr(leaf, "shape", ())
    if not isinstance(leaf, torch.Tensor) or not len(shape):
        return None
    if any(k in ENV_TRAILING for k in path):
        return len(shape) - 1
    if shape[0] == num_envs:
        return 0
    return None


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_tree(tree, shard: EnvShard):
    """A rank's block of a global tree (nested dicts of tensors; anything
    else is kept).  Without a shard, the tree itself."""
    if shard is None:
        return tree

    def fn(path, leaf):
        ax = leaf_axis(path, leaf, shard.num_envs)
        if ax is None:
            return leaf
        return leaf.narrow(ax, shard.row0, shard.n_local).contiguous()
    return _map(fn, tree)


def gather_tree(tree, shard: EnvShard):
    """The global tree of every rank's block (the inverse of shard_tree):
    a collective that every rank calls with a tree of the same layout."""
    if not spans(shard):
        return tree

    def fn(path, leaf):
        ax = leaf_axis(path, leaf, shard.n_local)
        if ax is None:
            return leaf
        return gather_axis(leaf, shard, ax)
    return _map(fn, tree)


def rows(x, shard, axis: int = 0):
    """This rank's rows of a tensor drawn at the global env count."""
    if shard is None:
        return x
    return x.narrow(axis, shard.row0, shard.n_local)


def global_shape(shape, shard):
    """`shape` with its leading (local) env count made global."""
    if shard is None:
        return tuple(shape)
    return (shard.num_envs,) + tuple(shape[1:])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _all_reduce(x):
    import torch.distributed as dist
    dist.all_reduce(x)
    return x


def all_sum(x, shard):
    """Sum of x over the ranks (a new tensor; for values outside autograd:
    stats, counts, gradients); x itself without a shard of two or more
    ranks."""
    if not spans(shard):
        return x
    return _all_reduce(x.detach().clone())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rank, world, axis):
        n = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = n * world
        dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
        buf = torch.zeros(shape, dtype=dtype, device=x.device)
        buf.narrow(axis, rank * n, n).copy_(x)
        _all_reduce(buf)
        ctx.rank, ctx.n, ctx.axis = rank, n, axis
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss may read every row: sum the gradients of the
        # global buffer over the ranks, keep this rank's rows
        g = _all_reduce(grad.contiguous().clone())
        return g.narrow(ctx.axis, ctx.rank * ctx.n, ctx.n), None, None, None


def gather_axis(x, shard, axis: int = 0):
    """Every rank's x concatenated in rank order along `axis` (each rank
    holds the same count there), with autograd; x itself without a shard
    of two or more ranks."""
    if not spans(shard):
        return x
    return _GatherRows.apply(x, shard.rank, shard.world, axis)


def all_gather_rows(x, shard):
    """Every rank's rows of x (axis 0) in rank order, with autograd."""
    return gather_axis(x, shard, 0)


def mean(x, shard, count=None):
    """x's share of the mean over every rank's x: its sum over the global
    element count (`count`, default x.numel() times the world), so the
    shares add up to the global mean and their gradients to its gradient.
    torch.mean(x) without a shard of two or more ranks."""
    if not spans(shard):
        return torch.mean(x)
    if count is None:
        count = x.numel() * shard.world
    return x.sum() / count
