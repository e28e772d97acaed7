"""Vector math over ``(..., 3)`` tensors (``hare_tpu/geom/math.py``)."""

from __future__ import annotations

import torch

__all__ = ["dot", "cross", "norm", "normalize"]


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
