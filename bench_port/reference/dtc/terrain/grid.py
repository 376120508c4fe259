"""Device-resident heightfield container and its direct queries.

Counterpart of the JAX package's terrain/grid.py.  The plane task's
physics takes `height_and_slope` on a flat grid as its terrain function
(its plane branch: zeros).  The heightfield branches and `height_min3` /
`height_max10` run on no path of the port (the heightfield rollout samples
through terrain/patch.py and the fused sampler): they are kept for parity
with the JAX package's queries and held to them by
tests/test_torch_plane.py.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TerrainGrid:
    """Heightfield (rows, cols) float32 in meters plus its geometry."""
    height: torch.Tensor
    horizontal_scale: float    # m per cell (legged_robot_config.py:19)
    border_size: float         # m (legged_robot_config.py:21)
    is_plane: bool = False


def flat_grid(size_m: float = 16.0, horizontal_scale: float = 0.05,
              device="cuda") -> TerrainGrid:
    """A zero plane of size_m x size_m meters, centred on the origin (its
    table one zero seen as n x n: the queries answer a plane without it)."""
    n = int(size_m / horizontal_scale)
    return TerrainGrid(height=torch.zeros((), device=device).expand(n, n),
                       horizontal_scale=horizontal_scale,
                       border_size=size_m / 2, is_plane=True)


def _cell_coords(grid: TerrainGrid, x, y):
    """World xy -> fractional grid coords (fx, fy), clipped inside the grid."""
    fx = (x + grid.border_size) / grid.horizontal_scale
    fy = (y + grid.border_size) / grid.horizontal_scale
    fx = torch.clamp(fx, 0.0, grid.height.shape[0] - 1.001)
    fy = torch.clamp(fy, 0.0, grid.height.shape[1] - 1.001)
    return fx, fy


def _gather(grid: TerrainGrid, ix, iy):
    """Flat gather from the heightfield: int coords -> heights (the flat
    index clipped into the table, as JAX's take with mode="clip")."""
    flat = grid.height.reshape(-1)
    idx = torch.clamp(ix.long() * grid.height.shape[1] + iy.long(), 0,
                      flat.numel() - 1)
    return flat[idx]


def height_and_slope(grid: TerrainGrid, x, y):
    """Bilinear height, slope and max corner at world xy (the contact
    query): (h, dh/dx, dh/dy, h_max), slopes capped at 3.0."""
    if grid.is_plane:
        z = torch.zeros_like(x)
        return z, z, z, z
    fx, fy = _cell_coords(grid, x, y)
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    tx = fx - ix
    ty = fy - iy
    h00 = _gather(grid, ix, iy)
    h10 = _gather(grid, ix + 1, iy)
    h01 = _gather(grid, ix, iy + 1)
    h11 = _gather(grid, ix + 1, iy + 1)
    h = (h00 * (1 - tx) * (1 - ty) + h10 * tx * (1 - ty)
         + h01 * (1 - tx) * ty + h11 * tx * ty)
    dhdx = ((h10 - h00) * (1 - ty) + (h11 - h01) * ty) / grid.horizontal_scale
    dhdy = ((h01 - h00) * (1 - tx) + (h11 - h10) * tx) / grid.horizontal_scale
    h_max = torch.maximum(torch.maximum(h00, h10), torch.maximum(h01, h11))
    cap = 3.0
    return (h, torch.clamp(dhdx, -cap, cap), torch.clamp(dhdy, -cap, cap),
            h_max)


def height_min3(grid: TerrainGrid, x, y):
    """min(h[p], h[p+dx], h[p+dy]): the height scan's sampling
    (legged_robot.py:1303-1317)."""
    if grid.is_plane:
        return torch.zeros_like(x)
    fx = (x + grid.border_size) / grid.horizontal_scale
    fy = (y + grid.border_size) / grid.horizontal_scale
    ix = torch.clamp(fx.to(torch.int32), 0, grid.height.shape[0] - 2)
    iy = torch.clamp(fy.to(torch.int32), 0, grid.height.shape[1] - 2)
    h1 = _gather(grid, ix, iy)
    h2 = _gather(grid, ix + 1, iy)
    h3 = _gather(grid, ix, iy + 1)
    return torch.minimum(torch.minimum(h1, h2), h3)


def height_max10(grid: TerrainGrid, x, y):
    """The max over the 10-neighbour stencil: foot-clearance sampling
    (`_get_foot_clearance`, legged_robot.py:1450-1469)."""
    if grid.is_plane:
        return torch.zeros_like(x)
    fx = (x + grid.border_size) / grid.horizontal_scale
    fy = (y + grid.border_size) / grid.horizontal_scale
    ix = torch.clamp(fx.to(torch.int32), 1, grid.height.shape[0] - 3)
    iy = torch.clamp(fy.to(torch.int32), 1, grid.height.shape[1] - 3)
    offs = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2),
            (1, 1), (-1, 0), (0, -1), (-2, 0), (0, -2)]
    h = _gather(grid, ix, iy)
    for dx, dy in offs[1:]:
        h = torch.maximum(h, _gather(grid, ix + dx, iy + dy))
    return h
