"""Per-env terrain patch and contact-window copies: the CUDA kernels
csrc/patch.cu and their plain versions.

Replace the JAX package's ops/pallas_patch.py `extract_patches_pallas`
(K4) and `extract_windows_pallas` (K5).  From the blocked tables
(terrain/patch.py make_source, (T, B, R_pad, 128) float32) and each env's
start (row r0, column block b):
  * `extract_patches`: out[t, n] = blocks[t, b_n, r0_n : r0_n + 64]
    -> (T, N, 64, 128), table-major;
  * `extract_windows`: out[n] = blocks[0, b_n, r0_n + 16 : r0_n + 56]
    -> (N, 40, 128), the decimation step's contact window.
Both are pure copies, bound by bytes: at 4096 envs a step's patches are
402.7 MB written (and as much read), a step's windows 83.9 MB.
"""
from __future__ import annotations

import torch


PATCH_ROWS = 64      # terrain/patch.py PATCH_R
COLS = 128           # terrain/patch.py PATCH_C


def _rows(starts, row0: int, rows: int):
    return (starts[:, 0].long()[:, None] + row0
            + torch.arange(rows, device=starts.device))


def extract_patches_plain(blocks, starts):
    """The advanced-index gather: (T, N, 64, 128)."""
    return blocks[:, starts[:, 1].long()[:, None],
                  _rows(starts, 0, PATCH_ROWS)]


def extract_windows_plain(blocks, starts, win_r0: int = 16, win_r: int = 40):
    """The slice-gather of table 0: (N, win_r, 128)."""
    return blocks[0, starts[:, 1].long()[:, None],
                  _rows(starts, win_r0, win_r)]


def extract_patches(blocks, starts):
    """Each env's 64 x 128 patch of every table: blocks (T, B, R_pad, 128)
    float32, starts (N, 2) int32 (row, column block) -> (T, N, 64, 128).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    return extract_patches_plain(blocks, starts)

def extract_windows(blocks, starts, win_r0: int = 16, win_r: int = 40):
    """Rows [r0 + win_r0, r0 + win_r0 + win_r) of table 0 for each env:
    -> (N, win_r, 128).  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    return extract_windows_plain(blocks, starts, win_r0, win_r)

# the launch counts: plain integers on the public wrappers, counted through
# these fixed references (a caller may wrap the module attributes)
_patches, _windows = extract_patches, extract_windows
