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

import math

import torch


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
    return permute_groups_plain(flat, perm, G)

# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
permute_groups.launches = 0
_counter = permute_groups
