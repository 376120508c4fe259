"""Blocked terrain tables and the plain per-env samplers.

Counterpart of the JAX package's terrain/patch.py.  At init the
heightfield and its min3/max10 pooled copies are re-blocked into
overlapping 128-column slabs at 64-column stride (`make_source`); each
policy step every env gets a (row_start, col_block) start (`patch_starts`)
that places a 64x128-cell patch around it.  The samplers read a patch's
cells by direct indexing, which is what the JAX package's one-hot matmuls
compute.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import cuda_patch
from .grid import TerrainGrid

PATCH_R = 64        # rows per patch
COL_BLOCK = 64      # column stride between overlapping slabs
PATCH_C = 128       # columns per patch
ROW_ALIGN = 8       # row starts are multiples of 8 (as in the JAX package)


def pooled_tables(grid: TerrainGrid):
    """Static min3/max10 pooled heightfields (meters).

    min3:  min(h[i,j], h[i+1,j], h[i,j+1])      (legged_robot.py:1311-1315)
    max10: max over the 10-point stencil        (legged_robot.py:1455-1468)
    """
    h = grid.height
    if grid.is_plane:
        return h, h

    def shift(a, dx, dy):
        return torch.roll(a, shifts=(-dx, -dy), dims=(0, 1))

    min3 = torch.minimum(torch.minimum(h, shift(h, 1, 0)), shift(h, 0, 1))
    offs = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2),
            (1, 1), (-1, 0), (0, -1), (-2, 0), (0, -2)]
    max10 = h
    for dx, dy in offs[1:]:
        max10 = torch.maximum(max10, shift(h, dx, dy))
    return min3, max10


@dataclasses.dataclass
class PatchSource:
    """Blocked tables: blocks (T, B, R_pad, 128) float32 — [0]=raw,
    [1]=min3, [2]=max10 — plus blocks16, a bfloat16 copy of the pooled
    tables (2, B, R_pad, 128).  The nearest-sampled scan and clearance
    read blocks16: their values are rounded to bf16 exactly as in the JAX
    package (terrain/patch.py:113, sample_nearest)."""
    blocks: torch.Tensor
    blocks16: torch.Tensor
    n_blocks: int
    n_rows: int
    horizontal_scale: float
    border_size: float


def make_source(grid: TerrainGrid, tables) -> PatchSource:
    """Re-block (T, R, C) tables into (T, B, R_pad, 128) overlapping slabs."""
    T, R, C = tables.shape
    n_blocks = max(-(-C // COL_BLOCK), 1)
    pad_c = n_blocks * COL_BLOCK + (PATCH_C - COL_BLOCK) - C
    # rows padded so every patch [r0, r0+64) stays in the table (the JAX
    # package pads 16 rows more for its bf16 DMA alignment; kept so the
    # tables match)
    pad_r = PATCH_R + 16
    padded = F.pad(tables[None], (0, max(pad_c, 0), 0, pad_r),
                   mode="replicate")[0]
    blocks = torch.stack([padded[:, :, b * COL_BLOCK:b * COL_BLOCK + PATCH_C]
                          for b in range(n_blocks)], dim=1).contiguous()
    return PatchSource(blocks=blocks,
                       blocks16=blocks[1:].to(torch.bfloat16).contiguous(),
                       n_blocks=n_blocks, n_rows=R,
                       horizontal_scale=grid.horizontal_scale,
                       border_size=grid.border_size)


def patch_starts(src: PatchSource, base_xy):
    """Per-env (row_start, col_block) (N,2) int32 + world origin (N,2)."""
    hs = src.horizontal_scale
    fr = (base_xy[:, 0] + src.border_size) / hs - PATCH_R / 2
    r0 = torch.floor(fr / ROW_ALIGN).to(torch.int32) * ROW_ALIGN
    r0 = torch.clamp(r0, 0, max(src.n_rows - 1, 0))
    fc = (base_xy[:, 1] + src.border_size) / hs - PATCH_C / 2
    b = torch.clamp(torch.round(fc / COL_BLOCK).to(torch.int32),
                    0, src.n_blocks - 1)
    origin = torch.stack(
        [r0.to(torch.float32) * hs - src.border_size,
         (b * COL_BLOCK).to(torch.float32) * hs - src.border_size], dim=1)
    return torch.stack([r0, b], dim=1), origin


def extract(src: PatchSource, starts):
    """Patch extraction -> (T, N, PATCH_R, PATCH_C), table-major: the patch
    copy kernel (ops/cuda_patch.py, K4) on the card, the advanced-index
    gather on the CPU.  The default route never materializes patches; the
    sampler-off and physics-off routes do, once a step."""
    return cuda_patch.extract_patches(src.blocks, starts)


def extract_window(src: PatchSource, starts, win_r0: int = 16,
                   win_r: int = 40):
    """Physics contact window: raw-table rows [r0+win_r0, r0+win_r0+win_r)
    -> (N, win_r, PATCH_C): the window copy kernel (ops/cuda_patch.py, K5)
    on the card, the slice-gather on the CPU."""
    return cuda_patch.extract_windows(src.blocks, starts, win_r0, win_r)


def gather_cells(table, starts, rows, cols):
    """table (B, R_pad, 128); starts (N,2); rows/cols (N,K) int64 patch
    coordinates -> (N,K) values of table[b, r0 + row, col]."""
    Rp, Cw = table.shape[1], table.shape[2]
    b = starts[:, 1:2].long()
    r = starts[:, 0:1].long() + rows
    return table.reshape(-1)[(b * Rp + r) * Cw + cols]


def nearest_index(f, size):
    """floor(f) clipped into [0, size-1] (the one-hot index of
    _weights_nearest, patch.py:149)."""
    return torch.clamp(torch.floor(f), 0, size - 1).long()


def sample_bilinear_slope(patches, origin, hs, x, y):
    """Bilinear height + slope + max corner at world (x, y) from patches
    (N, PATCH_R, PATCH_C): (N,K) each -> (h, dh/dx, dh/dy, h_max) (N,K),
    with the corner clip and slope cap of the JAX package."""
    fr = (x - origin[:, 0:1]) / hs
    fc = (y - origin[:, 1:2]) / hs
    i0 = torch.clamp(torch.floor(fr), 0, PATCH_R - 2)
    tx = torch.clamp(fr - i0, 0.0, 1.0)
    j0 = torch.clamp(torch.floor(fc), 0, PATCH_C - 2)
    ty = torch.clamp(fc - j0, 0.0, 1.0)
    i0, j0 = i0.long(), j0.long()
    flat = patches.reshape(patches.shape[0], -1)

    def cell(i, j):
        return torch.gather(flat, 1, i * PATCH_C + j)
    c00, c10 = cell(i0, j0), cell(i0 + 1, j0)
    c01, c11 = cell(i0, j0 + 1), cell(i0 + 1, j0 + 1)
    h = (c00 * (1 - tx) * (1 - ty) + c10 * tx * (1 - ty)
         + c01 * (1 - tx) * ty + c11 * tx * ty)
    dhdx = ((c10 - c00) * (1 - ty) + (c11 - c01) * ty) / hs
    dhdy = ((c01 - c00) * (1 - tx) + (c11 - c10) * tx) / hs
    h_max = torch.maximum(torch.maximum(c00, c10), torch.maximum(c01, c11))
    cap = 3.0
    return (h, torch.clamp(dhdx, -cap, cap), torch.clamp(dhdy, -cap, cap),
            h_max)


def sample_nearest(patches, origin, hs, x, y):
    """Integer-cell lookup at world (x, y) from a (pooled) patch
    (N, PATCH_R, PATCH_C): (N,K) -> (N,K), the cell value rounded to
    bfloat16 as in the JAX package (its one-hot matmul runs in bf16)."""
    ir = nearest_index((x - origin[:, 0:1]) / hs, PATCH_R)
    ic = nearest_index((y - origin[:, 1:2]) / hs, PATCH_C)
    flat = patches.to(torch.bfloat16).reshape(patches.shape[0], -1)
    return torch.gather(flat, 1, ir * PATCH_C + ic).float()
