"""Closest-point and distance queries, branch-free and differentiable
(``hare_tpu/geom/closest.py``).

- :func:`closest_point_triangle` <- ``Polygon.triclosestpoint``
  (``Hare_Geometry_Polygons.cs:62-114``): the Voronoi-region closest point
  on a triangle (Ericson, Real-Time Collision Detection §5.1.5), the
  reference's 7-branch cascade as a first-match select chain.
- :func:`sq_distance_to_edges` <- ``Polygon.SqDistanceToEdges``
  (``:116-145``), with the cyclic edge enumeration (i, i+1 mod n); the
  reference wraps with ``% (n-1)``, testing one edge twice and skipping the
  closing edge (a documented defect, not replicated).
- :func:`dist_to_plane` / :func:`closest_point_plane` <-
  ``Polygon.DistToPlane`` / ``ClosestPtPointPlane`` (``:575-617``).
- :func:`ray_side` <- ``Polygon.Ray_Side`` (``:589-606``).
- :func:`closest_point_aabb` <- ``AABB.ClosestPt`` (``AABB_Tri_Int.cs:265-288``).
- :func:`closest_point_segment` <- ``Edge.closestpoint``
  (``Hare_Geometry_Primitives.cs:301-314``).

Plain torch functions on tensors of any device; they broadcast over leading
batch dimensions.
"""

from __future__ import annotations

import torch

from .math import dot

__all__ = [
    "closest_point_triangle",
    "closest_point_segment",
    "closest_point_aabb",
    "closest_point_plane",
    "dist_to_plane",
    "ray_side",
    "sq_distance_to_edges",
]


def closest_point_triangle(
    p: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
) -> torch.Tensor:
    """Closest point on triangle (a, b, c) to p — ``triclosestpoint``.

    All seven candidate points are computed, then chosen by the region
    predicates in the reference's order.  Divisions go through a guard
    (``safe_div``: a denominator within 1e-30 of zero becomes 1), so values
    and gradients stay finite on a degenerate triangle.
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = p - b
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = p - c
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)

    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4

    # Region predicates, in the reference's order.
    in_a = (d1 <= 0.0) & (d2 <= 0.0)
    in_b = (d3 >= 0.0) & (d4 <= d3)
    on_ab = (vc <= 0.0) & (d1 >= 0.0) & (d3 <= 0.0)
    in_c = (d6 >= 0.0) & (d5 <= d6)
    on_ac = (vb <= 0.0) & (d2 >= 0.0) & (d6 <= 0.0)
    on_bc = (va <= 0.0) & ((d4 - d3) >= 0.0) & ((d5 - d6) >= 0.0)

    def safe_div(x, y):
        y = torch.where(torch.abs(y) > 1e-30, y, torch.ones_like(y))
        return x / y

    q_ab = a + safe_div(d1, d1 - d3)[..., None] * ab
    q_ac = a + safe_div(d2, d2 - d6)[..., None] * ac
    w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    q_bc = b + w_bc[..., None] * (c - b)
    denom = safe_div(torch.ones_like(va), va + vb + vc)
    q_in = a + (vb * denom)[..., None] * ab + (vc * denom)[..., None] * ac

    # First-match select: apply in reverse so earlier regions win.
    out = q_in
    out = torch.where(on_bc[..., None], q_bc, out)
    out = torch.where(on_ac[..., None], q_ac, out)
    out = torch.where(in_c[..., None], c.expand_as(out), out)
    out = torch.where(on_ab[..., None], q_ab, out)
    out = torch.where(in_b[..., None], b.expand_as(out), out)
    out = torch.where(in_a[..., None], a.expand_as(out), out)
    return out


def closest_point_segment(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closest point on segment [a, b] to p — ``Edge.closestpoint``
    (``Hare_Geometry_Primitives.cs:301-314``): projection clamped to [0, 1]."""
    ab = b - a
    denom = dot(ab, ab)
    pos = denom > 0
    t = torch.where(pos, dot(p - a, ab) / torch.where(pos, denom, torch.ones_like(denom)), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def closest_point_aabb(
    p: torch.Tensor, box_min: torch.Tensor, box_max: torch.Tensor
) -> torch.Tensor:
    """Closest point on/in an AABB — ``AABB.ClosestPt``
    (``AABB_Tri_Int.cs:265-288``): per-axis clamp."""
    return torch.minimum(torch.maximum(p, box_min), box_max)


def dist_to_plane(q: torch.Tensor, normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Signed distance from q to the plane n·x = d — ``Polygon.DistToPlane``
    (``Hare_Geometry_Polygons.cs:579-582``), scaled by 1/|n| so a non-unit
    normal still gives the metric distance."""
    n2 = dot(normal, normal)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, torch.ones_like(n2))), 0.0)
    return (dot(normal, q) - d) * inv


def closest_point_plane(q: torch.Tensor, normal: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Closest point on the plane n·x = d — ``Polygon.ClosestPtPointPlane``
    (``Hare_Geometry_Polygons.cs:613-617``)."""
    n2 = dot(normal, normal)
    pos = n2 > 0
    t = torch.where(pos, (dot(normal, q) - d) / torch.where(pos, n2, torch.ones_like(n2)), 0.0)
    return q - t[..., None] * normal


def ray_side(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """``Polygon.Ray_Side`` (``Hare_Geometry_Polygons.cs:589-606``): True
    where direction·normal >= 0 (the winding the reference would flip to)."""
    return dot(direction, normal) >= 0.0


def sq_distance_to_edges(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Min squared distance from p to the polygon's edge loop
    (``Polygon.SqDistanceToEdges``, cyclic edges (i, i+1 mod n)).

    Args:
      p: ``(..., 3)`` query points.
      pts: ``(..., K, 3)`` polygon corners.
    """
    a = pts
    b = torch.roll(pts, -1, dims=-2)
    edge = b - a
    pea = p[..., None, :] - a
    peb = p[..., None, :] - b
    e = dot(pea, edge)
    f = dot(edge, edge)
    # Ericson's three cases: before a, after b, or projected interior.
    d_a = dot(pea, pea)
    d_b = dot(peb, peb)
    pos = f > 0
    d_i = d_a - torch.where(pos, e * e / torch.where(pos, f, torch.ones_like(f)), 0.0)
    d_edge = torch.where(e <= 0, d_a, torch.where(e >= f, d_b, d_i))
    return torch.amin(d_edge, dim=-1)
