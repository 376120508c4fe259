"""Fused terrain sampler: the CUDA kernel csrc/sampler.cu and its plain
version.

Replaces the JAX package's terrain/pallas_sampler.py `sample_all` (the
Pallas kernel `_sample_all_pallas`): one call answers every terrain query
of a policy step — the 693-point min3 height scan, the 4-point max10 foot
clearance and the 21-point bilinear height + slope at the body contact
points.  On the H100 it is bound by memory traffic (44.4 MB at 4096 envs,
mostly the packed world coordinates and the results); the kernel makes
the patch coordinates itself and runs one thread per 4 queries, with
float4 loads and stores of the query and result rows, and reads table
cells directly where the TPU kernel built one-hot matmuls.  The card path
queues this one kernel and nothing else.
"""
from __future__ import annotations

import torch

from .patch import PATCH_C, PATCH_R, PatchSource, gather_cells, nearest_index

# query layout in the packed (N, Q_TOT) coordinate arrays
Q_MIN3 = 704          # 693 scan points + padding
Q_MAX10 = 8           # 4 feet + padding
Q_BIL = 24            # body points + padding
Q_TOT = Q_MIN3 + Q_MAX10 + Q_BIL
_BIL_ROW_MAX = PATCH_R - 1 - 1e-4
THREADS = 128         # threads a block of the kernel (csrc/sampler.cu)


def _patch_coords(src: PatchSource, origin, qx, qy):
    """World query coords -> fractional patch cells (fr, fc), as the JAX
    package computes them outside its kernel; the CUDA kernel computes the
    same float32 ops itself."""
    hs = src.horizontal_scale
    return (qx - origin[:, 0:1]) / hs, (qy - origin[:, 1:2]) / hs


def sample_all_plain(src: PatchSource, starts, origin, qx, qy):
    """Plain PyTorch version of the kernel (same arguments and results as
    `sample_all`)."""
    hs = src.horizontal_scale
    fr, fc = _patch_coords(src, origin, qx, qy)
    fr = torch.clamp(fr, 0, PATCH_R - 1)
    nq = Q_MIN3 + Q_MAX10
    ir = nearest_index(fr[:, :nq], PATCH_R)
    ic = nearest_index(fc[:, :nq], PATCH_C)
    pooled = src.blocks16
    h_min3 = gather_cells(pooled[0], starts, ir[:, :Q_MIN3],
                          ic[:, :Q_MIN3]).float()
    h_max10 = gather_cells(pooled[1], starts, ir[:, Q_MIN3:],
                           ic[:, Q_MIN3:]).float()

    frb = torch.clamp(fr[:, nq:], max=_BIL_ROW_MAX)
    fcb = fc[:, nq:]
    i0 = torch.clamp(torch.floor(frb), 0, PATCH_R - 2)
    tx = torch.clamp(frb - i0, 0.0, 1.0)
    j0 = torch.clamp(torch.floor(fcb), 0, PATCH_C - 2)
    ty = torch.clamp(fcb - j0, 0.0, 1.0)
    i0, j0 = i0.long(), j0.long()
    raw = src.blocks[0]
    s00 = gather_cells(raw, starts, i0, j0)
    s01 = gather_cells(raw, starts, i0, j0 + 1)
    s10 = gather_cells(raw, starts, i0 + 1, j0)
    s11 = gather_cells(raw, starts, i0 + 1, j0 + 1)
    rw0 = s00 * (1.0 - tx) + s10 * tx
    rw1 = s01 * (1.0 - tx) + s11 * tx
    h_b = rw0 * (1.0 - ty) + rw1 * ty
    gx = torch.clamp(((s10 - s00) * (1.0 - ty) + (s11 - s01) * ty) / hs,
                     -3.0, 3.0)
    gy = torch.clamp((rw1 - rw0) / hs, -3.0, 3.0)
    return torch.cat([h_min3, h_max10, h_b], dim=1), gx, gy


def sample_all(src: PatchSource, starts, origin, qx, qy):
    """Fused terrain sampling for one step.

    src: the 3-table PatchSource; starts (N,2) int32 from patch_starts;
    origin (N,2) world xy of patch cell (0,0); qx/qy (N, Q_TOT) world
    coords packed as [693 scan | pad | 4 feet | pad | body points | pad]
    (pad queries must hold in-range coords, e.g. the base position).

    Returns (h (N, Q_TOT), gx (N, Q_BIL), gy (N, Q_BIL)):
      h[:, :693]      min3 nearest heights (the observation scan)
      h[:, 704:708]   max10 nearest heights (foot clearance)
      h[:, 712:]      raw bilinear heights at the body points
      gx/gy           bilinear slopes at the body points
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    return sample_all_plain(src, starts, origin, qx, qy)

# the launch count: a plain integer on the public wrapper, counted through
# this fixed reference (a caller may wrap the module attribute)
