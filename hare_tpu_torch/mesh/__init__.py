"""Mesh compilation: welding, adjacency, planes -> device Scene (layer L3)."""

from . import shapes
from .scene import PAD_POLY, Scene
from .topology import GroupedRows, Topology, build_scene

__all__ = [
    "GroupedRows",
    "PAD_POLY",
    "Scene",
    "Topology",
    "build_scene",
    "shapes",
]
