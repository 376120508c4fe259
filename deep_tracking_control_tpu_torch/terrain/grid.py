"""Device-resident heightfield container.

Counterpart of the JAX package's terrain/grid.py container.  The direct
grid queries there (height_and_slope, height_min3, height_max10) serve
planes and the non-kernel paths; the rollout path here samples through
terrain/patch.py and the fused sampler instead.
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
