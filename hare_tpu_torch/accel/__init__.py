"""Acceleration structures behind one ``shoot`` API (reference layer L4).

All five backends of the JAX package: brute force (B1 ``brute_shoot``), the
voxel grid (K1 ``grid_shoot``), the octree and KD-tree stack walk (B2
``tree_shoot``) and the KD-tree rope walk (B3 ``ropes_shoot``); each hands
its winners to K2 ``finalize_hits``.
"""

from .brute import brute_shoot, shoot_brute
from .common import finalize_hits
from .kdtree import KDTree, build_kdtree, shoot_kdtree
from .octree import Octree, build_octree, shoot_octree
from .partition import ACCELS, SpatialPartition
from .ropes import KDRopes, build_kdtree_ropes, ropes_shoot, shoot_kdtree_ropes
from .tree import TreeTables, shoot_tree, tree_shoot
from .voxel import VoxelGrid, build_voxel_grid, grid_shoot, shoot_grid

__all__ = [
    "ACCELS",
    "KDRopes",
    "KDTree",
    "Octree",
    "SpatialPartition",
    "TreeTables",
    "VoxelGrid",
    "brute_shoot",
    "build_kdtree",
    "build_kdtree_ropes",
    "build_octree",
    "build_voxel_grid",
    "finalize_hits",
    "grid_shoot",
    "ropes_shoot",
    "shoot_brute",
    "shoot_grid",
    "shoot_kdtree",
    "shoot_kdtree_ropes",
    "shoot_octree",
    "shoot_tree",
    "tree_shoot",
]
