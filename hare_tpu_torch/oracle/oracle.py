"""Golden oracle: NumPy/float64 re-expression of the reference semantics.

A copy of ``hare_tpu/oracle/oracle.py`` (the port imports no JAX package):
the reference's exact branching logic (winding flip by ``Ray_Side`` +
one-sided Möller–Trumbore per determinant sign, scalar slab test, sequential
nearest-hit scan with ``t > 1e-10`` acceptance and origin-polygon
exclusion).  It needs nothing but NumPy, so on a GPU host it referees the
brute-force kernel B1, which in turn referees every accel structure.

Deliberately scalar and slow: clarity over speed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

DET_EPS = 1e-6  # Hare_Geometry_Polygons.cs:406
MIN_T = 1e-10  # Voxel_Grid.cs:482


def mt_intersect(
    origin: np.ndarray,
    direction: np.ndarray,
    v0: np.ndarray,
    v1: np.ndarray,
    v2: np.ndarray,
    normal: Optional[np.ndarray] = None,
) -> Optional[Tuple[float, float, float]]:
    """``Triangle.Intersect`` semantics (``Hare_Geometry_Polygons.cs:637-688``).

    Flips winding by ``Ray_Side`` (dot(dir, normal) >= 0 keeps (0,1,2), else
    (2,1,0)), then runs the one-sided MT of ``RayXtri`` (:385-435).
    Returns (t, u, v) or None.  u, v refer to the *possibly flipped* vertex
    order, exactly as the reference reports them.
    """
    if normal is None:
        normal = np.cross(v1 - v0, v2 - v0)
    if np.dot(direction, normal) < 0:  # Ray_Side == false -> flip
        v0, v1, v2 = v2, v1, v0

    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(direction, e2)
    det = np.dot(e1, pvec)
    tvec = origin - v0
    qvec = np.cross(tvec, e1)

    if det > DET_EPS:
        u = np.dot(tvec, pvec)
        if u < 0.0 or u > det:
            return None
        v = np.dot(direction, qvec)
        if v < 0.0 or u + v > det:
            return None
    elif det < -DET_EPS:
        u = np.dot(tvec, pvec)
        if u > 0.0 or u < det:
            return None
        v = np.dot(direction, qvec)
        if v > 0.0 or u + v < det:
            return None
    else:
        return None

    inv_det = 1.0 / det
    return (np.dot(e2, qvec) * inv_det, u * inv_det, v * inv_det)


def slab_intersect(
    origin: np.ndarray,
    direction: np.ndarray,
    box_min: np.ndarray,
    box_max: np.ndarray,
) -> Optional[Tuple[float, float]]:
    """``AABB.Intersect`` slab test (``AABB_Main.cs:86-171``).

    Returns (t_near, t_far) or None.  Parallel-axis handling matches the
    reference's per-axis branch vs ``double.Epsilon``.
    """
    t_near, t_far = -np.inf, np.inf
    for ax in range(3):
        d = direction[ax]
        if abs(d) <= np.finfo(float).tiny:
            if origin[ax] < box_min[ax] or origin[ax] > box_max[ax]:
                return None
            continue
        t1 = (box_min[ax] - origin[ax]) / d
        t2 = (box_max[ax] - origin[ax]) / d
        if t1 > t2:
            t1, t2 = t2, t1
        t_near = max(t_near, t1)
        t_far = min(t_far, t2)
        if t_near > t_far:
            return None
    if t_far < 0:
        return None
    return (t_near, t_far)


def oracle_shoot(
    topology,
    origin: np.ndarray,
    direction: np.ndarray,
    exclude: Tuple[int, int] = (-1, -1),
    min_t: float = MIN_T,
) -> Optional[dict]:
    """Sequential nearest-hit scan over all triangles of a Topology.

    The brute-force ground truth every accel structure must reproduce
    (acceptance: ``Voxel_Grid.cs:475-499``).  Quad polygons are two
    triangles tried in order — matching ``Quadrilateral.Intersect``
    (``Hare_Geometry_Polygons.cs:731-782``).
    Returns dict(t, u, v, point, poly_id, tri_id) or None.
    """
    origin = np.asarray(origin, float)
    direction = np.asarray(direction, float)
    best = None
    for ti in range(topology.n_tris):
        pid = int(topology.tri_poly[ti])
        if pid == exclude[0] or pid == exclude[1]:
            continue
        iv = topology.tri_v[ti]
        res = mt_intersect(
            origin,
            direction,
            topology.vertices[iv[0]],
            topology.vertices[iv[1]],
            topology.vertices[iv[2]],
        )
        if res is None:
            continue
        t, u, v = res
        if t <= min_t:
            continue
        if best is None or t < best["t"]:
            best = {
                "t": t,
                "u": u,
                "v": v,
                "point": origin + t * direction,
                "poly_id": pid,
                "tri_id": ti,
            }
    return best


def oracle_trace(
    topology,
    origin: np.ndarray,
    direction: np.ndarray,
    absorption: np.ndarray,
    n_bounces: int,
    sound_speed: float = 343.0,
) -> list:
    """Reference-style specular bounce loop (SURVEY.md §3.3 consumer pattern).

    Shoot -> reflect about the hit triangle's geometric normal -> new ray
    excluding the hit polygon -> repeat.  Energy starts at 1 and is scaled by
    (1 - absorption[poly]) per hit.  Returns a list of per-bounce dicts
    (hit info + energy + cumulative path time).
    """
    o = np.asarray(origin, float).copy()
    d = np.asarray(direction, float)
    d = d / np.linalg.norm(d)
    energy = 1.0
    dist = 0.0
    exclude = (-1, -1)
    out = []
    for _ in range(n_bounces):
        h = oracle_shoot(topology, o, d, exclude)
        if h is None:
            break
        iv = topology.tri_v[h["tri_id"]]
        n = np.cross(
            topology.vertices[iv[1]] - topology.vertices[iv[0]],
            topology.vertices[iv[2]] - topology.vertices[iv[0]],
        )
        n = n / np.linalg.norm(n)
        energy *= 1.0 - float(absorption[h["poly_id"]])
        dist += h["t"] * np.linalg.norm(d)
        out.append(
            dict(h, energy=energy, time=dist / sound_speed)
        )
        d = d - 2.0 * np.dot(d, n) * n
        o = h["point"]
        exclude = (h["poly_id"], -1)
    return out
