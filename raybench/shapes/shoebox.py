"""A rectangular room, normals facing inward: 6 quads or 12 triangles."""

from __future__ import annotations

import numpy as np


def quads(lx: float = 4.0, ly: float = 5.0, lz: float = 3.0) -> np.ndarray:
    """The room as 6 quadrilaterals, ``(6, 4, 3)``."""
    c = np.array(
        [
            [0, 0, 0], [lx, 0, 0], [lx, ly, 0], [0, ly, 0],
            [0, 0, lz], [lx, 0, lz], [lx, ly, lz], [0, ly, lz],
        ],
        np.float64,
    )
    q = [[0, 1, 2, 3], [7, 6, 5, 4], [4, 5, 1, 0], [6, 7, 3, 2], [7, 4, 0, 3], [5, 6, 2, 1]]
    return c[np.array(q)]


def faces(lx: float = 4.0, ly: float = 5.0, lz: float = 3.0) -> np.ndarray:
    """The room as 12 triangles, ``(12, 3, 3)``: each quad split into its
    corners (0, 1, 2) and (2, 3, 0)."""
    q = quads(lx, ly, lz)
    return np.stack([t for x in q for t in (x[[0, 1, 2]], x[[2, 3, 0]])])
