"""Vectorized triangle/AABB overlap (separating-axis test) — build time only.

A NumPy copy of ``hare_tpu/geom/tribox.py`` ``tri_box_overlap`` (the grid
build must run where JAX is not installed); the tests hold the two equal.

Re-expression of the Akenine-Möller SAT translated in ``AABB_Tri_Int.cs:22-260``
(9 edge-axis tests, 3 face-axis tests, plane/box test).  The reference version
uses mutable shared scratch fields and is not thread-safe
(``AABB_Tri_Int.cs:97-98`` — a documented latent race under the multithreaded
voxel fill); this version is pure NumPy, broadcasting over arbitrary batch
shapes, so the whole voxel fill is one vectorized call with no threads and no
races.

NumPy (not jnp) on purpose: acceleration-structure builds are host-side scene
compilation; the device never sees this code.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tri_box_overlap"]


def _axis_test(v_a, v_b, half, a_idx, b_idx, ea, eb):
    """One SAT edge-axis test on axis formed from edge components (ea, eb).

    Projects two triangle verts (the third projects equal to one of them for
    these axes) and the box half-extent; returns separating (True = disjoint).
    v_a, v_b: (..., 3) the two distinct-projection vertices.
    a_idx, b_idx: which coordinates form the projection p = ea*v[a] - eb*v[b].
    """
    p1 = ea * v_a[..., a_idx] - eb * v_a[..., b_idx]
    p2 = ea * v_b[..., a_idx] - eb * v_b[..., b_idx]
    lo = np.minimum(p1, p2)
    hi = np.maximum(p1, p2)
    rad = np.abs(ea) * half[..., a_idx] + np.abs(eb) * half[..., b_idx]
    return (lo > rad) | (hi < -rad)


def tri_box_overlap(
    tri: np.ndarray, box_center: np.ndarray, box_half: np.ndarray
) -> np.ndarray:
    """SAT overlap test, broadcast over batch dims.

    Args:
      tri: ``(..., 3, 3)`` triangle vertices.
      box_center: ``(..., 3)`` box centers.
      box_half: ``(..., 3)`` box half-extents.
    Returns:
      ``(...)`` bool — True where triangle and box overlap.
    """
    v0 = tri[..., 0, :] - box_center
    v1 = tri[..., 1, :] - box_center
    v2 = tri[..., 2, :] - box_center
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2
    h = box_half

    sep = np.zeros(v0.shape[:-1], dtype=bool)

    # 9 edge-cross-axis tests (AXISTEST_* macros, AABB_Tri_Int.cs:101-162).
    # For axis e_i x (unit axis), both endpoints of e_i project identically,
    # so the two distinct-projection vertices are one endpoint plus the
    # opposite vertex — the same pair serves all three axes of that edge.
    X, Y, Z = 0, 1, 2
    for e, va, vb in ((e0, v0, v2), (e1, v1, v0), (e2, v2, v1)):
        ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
        # a = e x X = (0, ez, -ey): p = ez*y - ey*z
        sep |= _axis_test(va, vb, h, Y, Z, ez, ey)
        # a = e x Y = (-ez, 0, ex): p = ex*z - ez*x
        sep |= _axis_test(va, vb, h, Z, X, ex, ez)
        # a = e x Z = (ey, -ex, 0): p = ey*x - ex*y
        sep |= _axis_test(va, vb, h, X, Y, ey, ex)

    # 3 face-axis (box axes) tests (AABB_Tri_Int.cs:239-249).
    for ax in (X, Y, Z):
        lo = np.minimum(np.minimum(v0[..., ax], v1[..., ax]), v2[..., ax])
        hi = np.maximum(np.maximum(v0[..., ax], v1[..., ax]), v2[..., ax])
        sep |= (lo > h[..., ax]) | (hi < -h[..., ax])

    # Triangle-plane vs box test (planeBoxOverlap, AABB_Tri_Int.cs:51-95).
    n = np.cross(e0, e1)
    d = -np.sum(n * v0, axis=-1)
    # vmin/vmax: box corner most negative / positive along n.
    r = np.sum(np.abs(n) * h, axis=-1)
    sep |= (d > r) | (d < -r)

    return ~sep
