"""Terrain tables and the fused sampler (K2) of the torch port against the
JAX package.

The blocked tables, the patch starts and the plain samplers must equal the
JAX package's terrain/patch.py; the plain version of the port's sampler
kernel must reproduce terrain/pallas_sampler.py `sample_all` (run in
interpret mode) at the JAX package's own budget: 1e-5 on heights, 1e-4 on
slopes (tests/test_pallas_sampler.py:56-71).
"""
import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deep_tracking_control_tpu.env.config import TerrainCfg
from deep_tracking_control_tpu.terrain import pallas_sampler as jsmp
from deep_tracking_control_tpu.terrain import patch as jpatch
from deep_tracking_control_tpu.terrain.generator import Terrain
from deep_tracking_control_tpu.terrain.grid import TerrainGrid as JGrid
from deep_tracking_control_tpu_torch.terrain import cuda_sampler as tsmp
from deep_tracking_control_tpu_torch.terrain import patch as tpatch
from deep_tracking_control_tpu_torch.terrain.grid import TerrainGrid as TGrid


@pytest.fixture(scope="module")
def world():
    cfg = TerrainCfg(num_rows=2, num_cols=2, border_size=4.0)
    terr = Terrain(cfg, seed=3)
    h = terr.heights_meters()
    jgrid = JGrid(height=jnp.asarray(h), horizontal_scale=cfg.horizontal_scale,
                  border_size=cfg.border_size, is_plane=False)
    m3, m10 = jpatch.pooled_tables(jgrid)
    jsrc = jpatch.make_source(jgrid, jnp.stack([jgrid.height, m3, m10]))
    tgrid = TGrid(height=torch.from_numpy(h), horizontal_scale=cfg.horizontal_scale,
                  border_size=cfg.border_size)
    t3, t10 = tpatch.pooled_tables(tgrid)
    tsrc = tpatch.make_source(tgrid, torch.stack([tgrid.height, t3, t10]))
    return terr, jsrc, tsrc


def _bases(terr, n, seed):
    rng = np.random.default_rng(seed)
    return (terr.env_origins.reshape(-1, 3)[rng.integers(0, 4, n)][:, :2]
            + rng.uniform(-0.4, 0.4, (n, 2))).astype(np.float32)


def test_blocked_tables_equal(world):
    _, jsrc, tsrc = world
    np.testing.assert_array_equal(tsrc.blocks.numpy(), np.asarray(jsrc.blocks))
    np.testing.assert_array_equal(tsrc.blocks16.float().numpy(),
                                  np.asarray(jsrc.blocks16.astype(jnp.float32)))
    assert (tsrc.n_blocks, tsrc.n_rows) == (jsrc.n_blocks, jsrc.n_rows)


def test_patch_starts_equal(world):
    terr, jsrc, tsrc = world
    base = _bases(terr, 64, 5)
    base[:4] = [[-9.0, -9.0], [40.0, 40.0], [-9.0, 40.0], [3.0, -9.0]]
    js, jo = jpatch.patch_starts(jsrc, jnp.asarray(base))
    ts, to = tpatch.patch_starts(tsrc, torch.from_numpy(base))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_plain_samplers_match_patch_samplers(world):
    terr, jsrc, tsrc = world
    N, K = 8, 50
    base = _bases(terr, N, 6)
    rng = np.random.default_rng(7)
    x = (base[:, 0:1] + rng.uniform(-2.0, 2.0, (N, K))).astype(np.float32)
    y = (base[:, 1:2] + rng.uniform(-2.0, 2.0, (N, K))).astype(np.float32)
    js, jo = jpatch.patch_starts(jsrc, jnp.asarray(base))
    ts, to = tpatch.patch_starts(tsrc, torch.from_numpy(base))
    jp = jpatch.extract(jsrc, js)
    tp = tpatch.extract(tsrc, ts)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    hs = tsrc.horizontal_scale
    for t in (1, 2):
        want = jpatch.sample_nearest(jp[t], jo, hs, jnp.asarray(x), jnp.asarray(y))
        got = tpatch.sample_nearest(tp[t], to, hs, torch.from_numpy(x),
                                    torch.from_numpy(y))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jpatch.sample_bilinear_slope(jp[0], jo, hs, jnp.asarray(x),
                                        jnp.asarray(y))
    got = tpatch.sample_bilinear_slope(tp[0], to, hs, torch.from_numpy(x),
                                       torch.from_numpy(y))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("spread", [1.0, 2.5])
def test_sample_all_plain_matches_pallas_kernel(world, spread):
    """spread 2.5 m puts queries beyond the 64x128 patch: the edge clips."""
    terr, jsrc, tsrc = world
    N = 8
    base = _bases(terr, N, 0)
    rng = np.random.default_rng(int(spread * 10))
    qx = (base[:, 0:1] + rng.uniform(-spread, spread, (N, tsmp.Q_TOT))
          ).astype(np.float32)
    qy = (base[:, 1:2] + rng.uniform(-spread, spread, (N, tsmp.Q_TOT))
          ).astype(np.float32)
    js, jo = jpatch.patch_starts(jsrc, jnp.asarray(base))
    jh, jgx, jgy = jsmp.sample_all(jsrc, js, jo, jnp.asarray(qx),
                                   jnp.asarray(qy), interpret=True)
    ts, to = tpatch.patch_starts(tsrc, torch.from_numpy(base))
    th, tgx, tgy = tsmp.sample_all(tsrc, ts, to, torch.from_numpy(qx),
                                   torch.from_numpy(qy))
    near = tsmp.Q_MIN3 + tsmp.Q_MAX10
    # nearest samples are bf16 table cells: equal
    np.testing.assert_array_equal(th[:, :near].numpy(), np.asarray(jh[:, :near]))
    np.testing.assert_allclose(th[:, near:].numpy(), np.asarray(jh[:, near:]),
                               atol=1e-5)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-4)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), atol=1e-4)


def test_launch_shape_mirrors_the_kernel():
    """The wrapper's block size is csrc/sampler.cu's; a thread per 4
    queries: at the published 4096 envs 5,888 blocks of 128 threads, and
    the ragged tail's last block part-filled."""
    src = (pathlib.Path(tsmp.__file__).resolve().parents[1] / "csrc"
           / "sampler.cu").read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);", src).group(1))
    assert threads == tsmp.THREADS
    for name in ("Q_MIN3", "Q_MAX10", "Q_BIL"):
        got = re.search(r"constexpr int %s = (\d+);" % name, src).group(1)
        assert int(got) == getattr(tsmp, name), name
    assert tsmp.launch_shape(4096) == (5888, 128, 4)
    assert tsmp.launch_shape(37) == (54, 128, 4)
    assert tsmp.launch_shape(1) == (2, 128, 4)
