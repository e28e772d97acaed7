"""Turn the JAX package's tables, given as NumPy, into the port's tensors.

The tests build a scene and an accel structure (grid, tree, rope tree) once
with ``hare_tpu``, pass the arrays through ``np.asarray``, and hand them to
both packages — so a parity test compares traversal and tracing on
identical tables.  This module imports
neither JAX nor the JAX package: it takes plain NumPy arrays, or (trees and
rope trees) the JAX tables themselves, read through ``np.asarray``.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .accel.ropes import KDRopes
from .accel.tree import TreeTables
from .accel.voxel import VoxelGrid
from .mesh.scene import Scene

__all__ = ["grid_from_numpy", "ropes_from_numpy", "scene_from_numpy", "tree_from_numpy"]


def scene_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Scene:
    """The port's ``Scene`` from the JAX ``Scene`` fields (as NumPy).

    The JAX ``tri_geom`` (T, 16) keeps int32 ids bitcast in f32 lanes
    9-15; the port keeps lanes 0-8 (geometry) and reads the ids from
    ``tri_meta``, whose lanes 0-6 hold the same values as int32.
    """

    def dev(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)  # a writable copy

    return Scene(
        vertices=dev(d["vertices"], np.float32),
        tri_v=dev(d["tri_v"], np.int32),
        tri_poly=dev(d["tri_poly"], np.int32),
        tri_top=dev(d["tri_top"], np.int32),
        poly_plane=dev(d["poly_plane"], np.int32),
        tri_edge_poly=dev(d["tri_edge_poly"], np.int32),
        tri_meta=dev(d["tri_meta"], np.int32),
        tri_geom=dev(np.asarray(d["tri_geom"])[:, :9], np.float32),
    )


def grid_from_numpy(
    d: Mapping[str, np.ndarray],
    dims: Tuple[int, int, int],
    char_step: float,
    max_cell_wins: int,
    n_tris: int,
    device="cuda",
) -> VoxelGrid:
    """The port's ``VoxelGrid`` from the JAX ``VoxelGrid`` arrays
    (``cell_meta``, ``win_data``, ``grid_min``, ``voxel_size``, as NumPy)
    and its static fields."""
    return VoxelGrid.from_numpy(
        np.asarray(d["cell_meta"]), np.asarray(d["win_data"]),
        np.asarray(d["grid_min"]), np.asarray(d["voxel_size"]),
        dims, char_step, max_cell_wins, n_tris, device=device,
    )


def _tables(t) -> Tuple[np.ndarray, ...]:
    """The four arrays that the JAX ``TreeTables`` and ``KDRopes`` share."""
    return tuple(np.asarray(getattr(t, f)) for f in ("node_rows", "win_data", "root_min", "root_max"))


def tree_from_numpy(t, device="cuda") -> TreeTables:
    """The port's ``TreeTables`` (child rows repacked) from a JAX
    ``TreeTables``, or any object with its fields: the arrays ``node_rows``,
    ``win_data``, ``root_min``, ``root_max`` (JAX or NumPy) and the statics
    ``branch`` and ``max_depth``.  The JAX field names live here only."""
    return TreeTables.from_numpy(*_tables(t), t.branch, t.max_depth, device=device)


def ropes_from_numpy(t, device="cuda") -> KDRopes:
    """The port's ``KDRopes`` (typed node rows) from a JAX ``KDRopes``, or
    any object with its fields: the arrays of :func:`tree_from_numpy` and
    the statics ``max_depth``, ``char_step`` and ``n_tris``."""
    return KDRopes.from_numpy(*_tables(t), t.max_depth, t.char_step, t.n_tris, device=device)
