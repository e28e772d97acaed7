"""Acceleration structures behind one ``shoot`` API (reference layer L4).

Ported so far: the voxel grid (K1 ``grid_shoot`` + K2 ``finalize_hits``).
"""

from .common import finalize_hits
from .voxel import VoxelGrid, build_voxel_grid, grid_shoot, shoot_grid
from .partition import SpatialPartition

__all__ = [
    "SpatialPartition",
    "VoxelGrid",
    "build_voxel_grid",
    "finalize_hits",
    "grid_shoot",
    "shoot_grid",
]
