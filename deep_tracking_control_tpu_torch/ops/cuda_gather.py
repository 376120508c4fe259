"""Grouped row gather (the minibatch shuffle): the CUDA kernel
csrc/gather.cu and its plain version.

Replaces the JAX package's experimental/pallas_gather.py `permute_groups`
(the Pallas kernel `_gather`): every field of the flattened (T*N, ...)
rollout batch is permuted in chunks of G flat-adjacent rows,
out[g*G:(g+1)*G] = x[perm[g]*G:(perm[g]+1)*G], in one launch per update.
On the TPU the default route was XLA's gather and the Pallas kernel an
opt-in (DTC_PALLAS_GATHER); this package has one path: the kernel on the
card, the plain version on the CPU.  The kernel is bound by bytes (each
byte read once and written once, about 767.6 MB an update for lite3_dtc
at 4096 envs).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import cuda_build
from ..utils import trace

MAX_FIELDS = 32           # csrc/gather.cu


def permute_groups_plain(flat: dict, perm, G: int) -> dict:
    """x.reshape(C, G, ...)[perm].reshape(len(perm) * G, ...) per field."""
    n = perm.shape[0]
    out = {}
    for k, x in flat.items():
        rest = tuple(x.shape[1:])
        out[k] = x.reshape((x.shape[0] // G, G) + rest)[perm].reshape(
            (n * G,) + rest)
    return out


def _check(flat: dict, perm, G: int):
    if G < 1:
        raise ValueError(f"G={G}: groups need at least one row")
    if perm.dim() != 1 or perm.dtype != torch.int64:
        raise ValueError(f"perm: {perm.dtype} {tuple(perm.shape)}, expected "
                         "a 1-d int64 tensor")
    chunks = None
    for k, x in flat.items():
        if x.device != perm.device:
            raise ValueError(f"{k}: on {x.device}, perm on {perm.device}")
        if x.dim() == 0 or x.shape[0] % G:
            raise ValueError(f"{k}: {x.shape[0] if x.dim() else 0} rows do "
                             f"not split into groups of {G}")
        chunks = x.shape[0] // G if chunks is None else min(chunks,
                                                            x.shape[0] // G)
    return chunks


def permute_groups(flat: dict, perm, G: int) -> dict:
    """Permute groups of G leading rows of every tensor in `flat`.

    flat: name -> (R, ...) tensors, R a multiple of G; perm: (C,) int64
    group indices in [0, R // G), C <= R // G (a prefix is allowed).
    Returns name -> (C * G, ...) tensors of the same dtypes.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (one launch for
    all fields) or raise."""
    chunks = _check(flat, perm, G)
    if perm.device.type == "cpu":
        return permute_groups_plain(flat, perm, G)
    if len(flat) > MAX_FIELDS:
        raise ValueError(f"{len(flat)} fields, the kernel takes {MAX_FIELDS}")
    for k, x in flat.items():
        if not x.is_contiguous():
            raise ValueError(f"{k}: not contiguous")
    if not perm.is_contiguous():
        raise ValueError("perm: not contiguous")
    C = perm.shape[0]
    if C > (chunks or 0):
        raise ValueError(f"perm: {C} groups, the batch has {chunks}")
    out = {k: torch.empty((C * G,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device) for k, x in flat.items()}
    if C == 0 or not flat:
        return out
    lo, hi = torch.aminmax(perm)
    with trace.sync("dtc/sync/perm_check"):          # one sync per call
        lo, hi = torch.stack([lo, hi]).tolist()
    if lo < 0 or hi >= chunks:
        raise ValueError(f"perm: values in [{lo}, {hi}], the batch has "
                         f"{chunks} groups")
    keys = list(flat)
    n = len(keys)
    table = (ctypes.c_longlong * (3 * n))(
        *[flat[k].data_ptr() for k in keys],
        *[out[k].data_ptr() for k in keys],
        *[G * math.prod(flat[k].shape[1:]) * flat[k].element_size()
          for k in keys])
    cuda_build.launch("dtc_permute_groups", table, n, cuda_build.ptr(perm), C,
                      cuda_build.stream_ptr(perm.device))
    _counter.launches += 1
    return out


# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
permute_groups.launches = 0
_counter = permute_groups
