"""hare_tpu_torch — the PyTorch/CUDA port of hare_tpu.

Same module layout and names as ``hare_tpu``; plain functions on torch
tensors with an explicit device.  On CUDA tensors the main path runs
hand-written kernels (``kernels/csrc``): the traversal of the chosen
backend (K1 ``grid_shoot``, B1 ``brute_shoot``, B2 ``tree_shoot`` for the
octree and KD-tree, B3 ``ropes_shoot``), K2 ``finalize_hits`` and K3
``energy_histogram``; on CPU tensors it runs their plain PyTorch versions.
Imports neither JAX nor ``hare_tpu``.
"""

from . import accel, convert, geom, kernels, mesh, oracle, trace
from .accel import (
    KDRopes,
    SpatialPartition,
    TreeTables,
    build_kdtree,
    build_kdtree_ropes,
    build_octree,
    shoot_brute,
    shoot_kdtree,
    shoot_kdtree_ropes,
    shoot_octree,
)
from .geom import NO_POLY, HitRecord, Ray
from .mesh import Scene, Topology, build_scene
from .trace import TraceResult, energy_histogram, trace_rays, uniform_sphere

__version__ = "0.1.0"

__all__ = [
    "HitRecord",
    "KDRopes",
    "NO_POLY",
    "Ray",
    "Scene",
    "SpatialPartition",
    "Topology",
    "TraceResult",
    "TreeTables",
    "accel",
    "build_kdtree",
    "build_kdtree_ropes",
    "build_octree",
    "build_scene",
    "convert",
    "energy_histogram",
    "geom",
    "kernels",
    "mesh",
    "oracle",
    "shoot_brute",
    "shoot_kdtree",
    "shoot_kdtree_ropes",
    "shoot_octree",
    "trace",
    "trace_rays",
    "uniform_sphere",
]
