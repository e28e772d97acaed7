"""Vector math over ``(..., 3)`` tensors (``hare_tpu/geom/math.py``)."""

from __future__ import annotations

import torch

__all__ = ["dot", "cross", "scalar_triple", "norm", "normalize", "distance", "is_coplanar"]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (``Hare_math.Dot``)."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector cross product (``Hare_math.Cross``), by component."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def scalar_triple(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a . (b x c)  (``Hare_math.ScalarTriple``)."""
    return dot(a, cross(b, c))


def norm(a: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the trailing axis."""
    return torch.sqrt(torch.sum(a * a, dim=-1))


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector; zero-length inputs map to zero (``eps=0``), or are
    clamped to length ``eps`` when ``eps > 0`` — the JAX semantics."""
    n2 = torch.sum(a * a, dim=-1, keepdim=True)
    if eps > 0.0:
        n2 = torch.clamp(n2, min=eps * eps)
    pos = n2 > 0
    return a * torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Point-to-point distance (``Hare_math.distance``)."""
    return norm(a - b)


def is_coplanar(points: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Whether a polygon's triangle fans share one normal.

    ``Corrective_Tools.IsCoPlanar`` (``Hare_Geometry_Math.cs:113-135``)
    fans (p0, p_i, p_{i+1}), normalizes each fan normal and requires every
    pairwise dot to be exactly 1 (a strict ``x < 1``, a documented defect);
    as the JAX package does, each fan normal's |dot| with the first must
    exceed ``1 - tol``.

    Args:
      points: ``(..., K, 3)`` polygon corners, K >= 3.
    Returns:
      boolean ``(...)`` mask.
    """
    p0 = points[..., :1, :]
    e1 = points[..., 1:-1, :] - p0  # (..., K-2, 3)
    e2 = points[..., 2:, :] - p0
    normals = normalize(cross(e1, e2))
    ref = normals[..., :1, :]
    dots = torch.abs(dot(normals, ref.expand_as(normals)))
    return torch.all(dots > 1.0 - tol, dim=-1)
