"""Turn the JAX package's tables, given as NumPy, into the port's tensors.

The tests build a scene and a grid once with ``hare_tpu``, pass the arrays
through ``np.asarray``, and hand them to both packages — so a parity test
compares traversal and tracing on identical tables.  This module imports
neither JAX nor the JAX package: it takes plain NumPy arrays.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .accel.voxel import VoxelGrid
from .mesh.scene import Scene

__all__ = ["grid_from_numpy", "scene_from_numpy"]


def scene_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Scene:
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
    device=None,
) -> VoxelGrid:
    """The port's ``VoxelGrid`` from the JAX ``VoxelGrid`` arrays
    (``cell_meta``, ``win_data``, ``grid_min``, ``voxel_size``, as NumPy)
    and its static fields."""
    return VoxelGrid.from_numpy(
        np.asarray(d["cell_meta"]), np.asarray(d["win_data"]),
        np.asarray(d["grid_min"]), np.asarray(d["voxel_size"]),
        dims, char_step, max_cell_wins, n_tris, device=device,
    )
