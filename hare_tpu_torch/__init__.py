"""hare_tpu_torch — the PyTorch/CUDA port of hare_tpu.

Same module layout and names as ``hare_tpu``; plain functions on torch
tensors with an explicit device.  On CUDA tensors the main path runs three
hand-written kernels (``kernels/csrc``): K1 ``grid_shoot``, K2
``finalize_hits`` and K3 ``energy_histogram``; on CPU tensors it runs their
plain PyTorch versions.  Imports neither JAX nor ``hare_tpu``.
"""

from . import accel, convert, geom, kernels, mesh, trace
from .accel import SpatialPartition
from .geom import NO_POLY, HitRecord, Ray
from .mesh import Scene, Topology, build_scene
from .trace import TraceResult, energy_histogram, trace_rays, uniform_sphere

__version__ = "0.1.0"

__all__ = [
    "HitRecord",
    "NO_POLY",
    "Ray",
    "Scene",
    "SpatialPartition",
    "Topology",
    "TraceResult",
    "accel",
    "build_scene",
    "convert",
    "energy_histogram",
    "geom",
    "kernels",
    "mesh",
    "trace",
    "trace_rays",
    "uniform_sphere",
]
