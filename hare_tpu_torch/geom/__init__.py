"""Geometric primitives and intersection tests (reference layers L1/L2)."""

from .intersect import DET_EPS, MIN_T, kernel_components, ray_aabb
from .math import cross, dot, norm, normalize
from .primitives import NO_POLY, HitRecord, Ray
from .tribox import tri_box_overlap

__all__ = [
    "DET_EPS",
    "HitRecord",
    "MIN_T",
    "NO_POLY",
    "Ray",
    "cross",
    "dot",
    "kernel_components",
    "norm",
    "normalize",
    "ray_aabb",
    "tri_box_overlap",
]
