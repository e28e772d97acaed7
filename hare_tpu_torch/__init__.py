"""hare_tpu_torch — the PyTorch/CUDA port of hare_tpu.

Same module layout and names as ``hare_tpu``; plain functions on torch
tensors.  Every entry point that places tensors (``build_scene``,
``SpatialPartition``, the structure builders, ``convert``, the
samplers) puts them on ``"cuda"`` unless the caller passes
another ``device``; with no card such a call raises.  On CUDA tensors the main path runs
hand-written kernels (``kernels/csrc``): the traversal of the chosen
backend (K1 ``grid_shoot``, B1 ``brute_shoot``, B2 ``tree_shoot`` for the
octree and KD-tree, B3 ``ropes_shoot``), K2 ``finalize_hits`` and K3
``energy_histogram``, and each bounce step is K4 (``bounce_step.cu``),
forward and backward; on CPU tensors it runs their plain PyTorch versions.
``dist`` runs the ray-parallel histogram and training step over
``torch.distributed`` (NCCL on the card, gloo on the CPU); ``utils`` holds
the run configuration, profiling, metrics, checkpoints and checks, and
``examples`` the two inverse-design programs.  Imports neither JAX nor
``hare_tpu``.
"""

from . import accel, convert, dist, geom, kernels, mesh, oracle, trace, utils
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
from .geom import AABB, NO_POLY, HitRecord, Ray
from .mesh import Scene, Topology, build_scene
from .trace import (
    TraceResult,
    cosine_lobe,
    energy_histogram,
    polygon_points,
    scene_surface_points,
    trace_rays,
    triangle_points,
    uniform_sphere,
)
from .utils import HareConfig

__version__ = "0.1.0"

__all__ = [
    "AABB",
    "HareConfig",
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
    "cosine_lobe",
    "dist",
    "energy_histogram",
    "geom",
    "kernels",
    "mesh",
    "oracle",
    "polygon_points",
    "scene_surface_points",
    "shoot_brute",
    "shoot_kdtree",
    "shoot_kdtree_ropes",
    "shoot_octree",
    "trace",
    "trace_rays",
    "triangle_points",
    "uniform_sphere",
    "utils",
]
