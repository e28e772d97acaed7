"""Mesh compilation: welding, adjacency, planes -> device Scene (layer L3)."""

from . import shapes
from .scene import PAD_POLY, Scene
from .topology import EdgeAux, GroupedRows, Topology, build_scene, merge_topologies

__all__ = [
    "EdgeAux",
    "GroupedRows",
    "PAD_POLY",
    "Scene",
    "Topology",
    "build_scene",
    "merge_topologies",
    "shapes",
]
