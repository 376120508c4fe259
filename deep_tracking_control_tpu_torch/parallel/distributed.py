"""The process group of a sharded run: one runner process per rank.

Counterpart of the JAX package's parallel/distributed.py (`initialize`,
`global_mesh`, `warmup_collectives`).  Under torchrun,

    torchrun --nproc_per_node=W -m deep_tracking_control_tpu_torch.scripts.train \\
        --task lite3_dtc

every rank calls `initialize()` (which reads RANK, WORLD_SIZE and
LOCAL_RANK), builds its env and runner with `global_shard(num_envs)` and
trains its block of envs; the params stay the same on every rank.

The backend is nccl on the card and gloo on the CPU.  NCCL refuses two
ranks on one device, so two ranks that share a card take gloo (its CUDA
all_reduce goes through the host).  `initialize` ends with one small
all_reduce, so that every rank meets the group's first collective at
start-up and not behind a rank's kernel build or compile.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from . import mesh


def _env_int(name, default):
    v = os.environ.get(name)
    return default if v is None else int(v)


def device(device_type=None) -> torch.device:
    """This rank's device: the CPU where `device_type` is "cpu", else
    cuda:LOCAL_RANK (modulo the visible cards, so that ranks may share
    one); raises where no card is visible."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass "
                           "device_type='cpu' (--device cpu) to run on the "
                           "CPU")
    local = _env_int("LOCAL_RANK", 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               device_type=None):
    """Start the process group (a no-op when one is up) and return this
    rank's device.

    Without arguments it reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK
    and its rendezvous (init_method "env://", MASTER_ADDR/MASTER_PORT).
    backend: "nccl" on the card, "gloo" on the CPU by default; gloo is
    accepted on the card too.  device_type "cpu" puts the rank on the CPU;
    any other asks for a card and raises where none is visible."""
    dev = device(device_type)
    if dist.is_initialized():
        return dev
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", 1)
    if rank is None:
        rank = _env_int("RANK", 0)
    if init_method is None:
        init_method = "env://"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    warmup(dev)
    return dev


def warmup(dev):
    """One all_reduce of a small tensor on every rank (the JAX package's
    warmup_collectives, called here from `initialize`)."""
    x = torch.ones(4, device=dev)
    dist.all_reduce(x)
    if int(x[0].item()) != dist.get_world_size():
        raise RuntimeError(f"warm-up all_reduce gave {x.tolist()}, expected "
                           f"{dist.get_world_size()}")


def global_shard(num_envs: int) -> mesh.EnvShard:
    """The EnvShard of this rank for `num_envs` envs in all."""
    return mesh.make_shard(num_envs, dist.get_world_size(), dist.get_rank())


def is_main() -> bool:
    """True on rank 0, or without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    if dist.is_initialized():
        dist.barrier()


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()
