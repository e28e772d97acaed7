"""Geometric primitives, intersection tests and proximity queries (reference
layers L1/L2; ``hare_tpu/geom``): the JAX package's names, on torch tensors
(``tribox`` is NumPy, build time only)."""

from .closest import (
    closest_point_aabb,
    closest_point_plane,
    closest_point_segment,
    closest_point_triangle,
    dist_to_plane,
    ray_side,
    sq_distance_to_edges,
)
from .intersect import (
    DET_EPS,
    MIN_T,
    kernel_components,
    ray_aabb,
    ray_triangle_mt,
    ray_triangle_watertight,
)
from .math import cross, distance, dot, is_coplanar, norm, normalize, scalar_triple
from .primitives import AABB, NO_POLY, HitRecord, Ray
from .tribox import poly_box_overlap_area, tri_box_overlap

__all__ = [
    "AABB",
    "DET_EPS",
    "HitRecord",
    "MIN_T",
    "NO_POLY",
    "Ray",
    "closest_point_aabb",
    "closest_point_plane",
    "closest_point_segment",
    "closest_point_triangle",
    "cross",
    "dist_to_plane",
    "distance",
    "dot",
    "is_coplanar",
    "kernel_components",
    "norm",
    "normalize",
    "poly_box_overlap_area",
    "ray_aabb",
    "ray_side",
    "ray_triangle_mt",
    "ray_triangle_watertight",
    "scalar_triple",
    "sq_distance_to_edges",
    "tri_box_overlap",
]
