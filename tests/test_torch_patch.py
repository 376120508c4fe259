"""The patch and window copies (K4, K5) of the torch port against the JAX
package.

The plain versions of the port's copy kernels (ops/cuda_patch.py) must
equal ops/pallas_patch.py `extract_patches_pallas` and
`extract_windows_pallas` (run in interpret mode) and the JAX package's CPU
`extract` / `extract_window` (dynamic slices) bit for bit: they are
copies.  The starts cover N=6 (not a multiple of the TPU kernel's 8 envs
a program), a row start clipped at the last table row, the first and the
last column block.  Tables are three seeded random heightfields blocked by
both packages' make_source.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.ops import pallas_patch as jpp
from deep_tracking_control_tpu.terrain import patch as jpatch
from deep_tracking_control_tpu.terrain.grid import TerrainGrid as JGrid
from deep_tracking_control_tpu_torch.ops import cuda_patch
from deep_tracking_control_tpu_torch.terrain import patch as tpatch
from deep_tracking_control_tpu_torch.terrain.grid import TerrainGrid as TGrid


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(4)
    R, C, hs = 150, 300, 0.1
    t = rng.normal(0, 0.2, (3, R, C)).astype(np.float32)
    jsrc = jpatch.make_source(
        JGrid(height=jnp.asarray(t[0]), horizontal_scale=hs, border_size=2.0,
              is_plane=False), jnp.asarray(t))
    tsrc = tpatch.make_source(
        TGrid(height=torch.from_numpy(t[0]), horizontal_scale=hs,
              border_size=2.0), torch.from_numpy(t))
    np.testing.assert_array_equal(tsrc.blocks.numpy(), np.asarray(jsrc.blocks))
    return jsrc, tsrc


def _starts(src, n, seed):
    """n starts: random 8-aligned rows and blocks, then the edge cases."""
    rng = np.random.default_rng(seed)
    rows = 8 * rng.integers(0, src.n_rows // 8, n)
    blocks = rng.integers(0, src.n_blocks, n)
    rows[0], blocks[0] = src.n_rows - 1, src.n_blocks - 1   # clipped row
    rows[1], blocks[1] = 0, 0
    rows[2], blocks[2] = src.n_rows - 1, 0
    return np.stack([rows, blocks], axis=1).astype(np.int32)


@pytest.mark.parametrize("n", [6, 13])
def test_patch_copy_plain_matches_pallas(tables, n):
    jsrc, tsrc = tables
    s = _starts(tsrc, n, n)
    got = cuda_patch.extract_patches_plain(tsrc.blocks, torch.from_numpy(s))
    assert got.shape == (3, n, 64, 128)
    want = jpp.extract_patches_pallas(jsrc.blocks, jnp.asarray(s),
                                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpatch.extract(tsrc, torch.from_numpy(s)).numpy(),
        np.asarray(jpatch.extract(jsrc, jnp.asarray(s))))


@pytest.mark.parametrize("n", [6, 13])
def test_window_copy_plain_matches_pallas(tables, n):
    jsrc, tsrc = tables
    s = _starts(tsrc, n, 100 + n)
    got = cuda_patch.extract_windows_plain(tsrc.blocks, torch.from_numpy(s),
                                           16, 40)
    assert got.shape == (n, 40, 128)
    want = jpp.extract_windows_pallas(jsrc.blocks, jnp.asarray(s), 16, 40,
                                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpatch.extract_window(tsrc, torch.from_numpy(s)).numpy(),
        np.asarray(jpatch.extract_window(jsrc, jnp.asarray(s))))
    # the window is rows 16..56 of the patch of table 0
    patches = tpatch.extract(tsrc, torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), patches[0, :, 16:56].numpy())


def test_copies_count_no_launch_on_the_cpu(tables):
    _, tsrc = tables
    s = torch.from_numpy(_starts(tsrc, 6, 0))
    before = (cuda_patch.extract_patches.launches,
              cuda_patch.extract_windows.launches)
    cuda_patch.extract_patches(tsrc.blocks, s)
    cuda_patch.extract_windows(tsrc.blocks, s)
    assert (cuda_patch.extract_patches.launches,
            cuda_patch.extract_windows.launches) == before
