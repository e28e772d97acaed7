"""Core geometric record types as NamedTuples of torch tensors (SoA, batch-first).

Counterpart of ``hare_tpu/geom/primitives.py``: ``Ray`` carries the
reference's ``poly_origin1/2`` exclusion pair, ``HitRecord`` the ``X_Event``
fields, ``AABB`` the box record (``AABB_Main.cs:24-84``; the slab test is
``geom.intersect.ray_aabb``).  All fields share one batch prefix and live
on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Ray", "HitRecord", "AABB", "NO_POLY"]

# Sentinel polygon id meaning "no exclusion" / "no hit".
NO_POLY = -1


class Ray(NamedTuple):
    """A batch of rays.

    ``exclude_poly`` (``(..., 2)`` int32) holds the polygon ids the ray must
    not re-hit (``Spatial_Partition.cs:33``), ``NO_POLY`` where unused.
    """

    origin: torch.Tensor  # (..., 3) float32
    direction: torch.Tensor  # (..., 3) float32
    exclude_poly: torch.Tensor  # (..., 2) int32

    @classmethod
    def make(cls, origin, direction, exclude_poly=None) -> "Ray":
        origin = torch.as_tensor(origin)
        direction = torch.as_tensor(direction, device=origin.device)
        if exclude_poly is None:
            exclude_poly = torch.full(
                origin.shape[:-1] + (2,), NO_POLY, dtype=torch.int32,
                device=origin.device,
            )
        else:
            exclude_poly = torch.as_tensor(
                exclude_poly, dtype=torch.int32, device=origin.device
            )
        return cls(origin, direction, exclude_poly)

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Point along the ray: origin + t * direction."""
        return self.origin + t[..., None] * self.direction

    def reverse(self) -> "Ray":
        """Flipped-direction copy (``Ray.Reverse()``,
        ``Hare_Geometry_Primitives.cs:421-428``; a new batch, the rays stay
        unchanged)."""
        return self._replace(direction=-self.direction)


class HitRecord(NamedTuple):
    """A batch of intersection results (the ``X_Event`` analog).

    ``normal`` is the un-normalized geometric normal ``cross(e1, e2)`` of the
    hit triangle; it is junk on miss lanes, so mask it with ``hit``.
    ``edge_nbr`` extends the JAX record: per triangle edge, the COPLANAR
    neighbour polygon across it (``-1`` where none) — the id lanes the
    bounce step's second exclusion reads.
    """

    hit: torch.Tensor  # (...) bool
    t: torch.Tensor  # (...) float — nearest accepted hit parameter, inf on miss
    u: torch.Tensor  # (...) float — barycentric weight of v1
    v: torch.Tensor  # (...) float — barycentric weight of v2
    point: torch.Tensor  # (..., 3) float
    poly_id: torch.Tensor  # (...) int32
    tri_id: torch.Tensor  # (...) int32
    normal: torch.Tensor  # (..., 3) float
    edge_nbr: Optional[torch.Tensor] = None  # (..., 3) int32

    @classmethod
    def miss(cls, batch_shape, dtype: torch.dtype = torch.float32, device="cuda") -> "HitRecord":
        """An all-miss record (t = +inf, ids ``NO_POLY``, normal +x), the
        ``X_Event()`` empty constructor's analog, on ``device``."""
        batch_shape = tuple(batch_shape)
        z = torch.zeros(batch_shape, dtype=dtype, device=device)
        normal = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
        normal[..., 0] = 1.0
        return cls(
            hit=torch.zeros(batch_shape, dtype=torch.bool, device=device),
            t=torch.full(batch_shape, float("inf"), dtype=dtype, device=device),
            u=z,
            v=z.clone(),
            point=torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
            poly_id=torch.full(batch_shape, NO_POLY, dtype=torch.int32, device=device),
            tri_id=torch.full(batch_shape, NO_POLY, dtype=torch.int32, device=device),
            normal=normal,
        )


class AABB(NamedTuple):
    """Axis-aligned box batch (``AABB_Main.cs:26-68``); the derived
    quantities are computed on demand."""

    min: torch.Tensor  # (..., 3)
    max: torch.Tensor  # (..., 3)

    @property
    def center(self) -> torch.Tensor:
        return 0.5 * (self.min + self.max)

    @property
    def width(self) -> torch.Tensor:
        return self.max - self.min

    @property
    def half_width(self) -> torch.Tensor:
        return 0.5 * (self.max - self.min)

    def contains(self, p: torch.Tensor) -> torch.Tensor:
        """Point-in-box test (``AABB_Main.cs:75-84``, inclusive bounds)."""
        return torch.all((p >= self.min) & (p <= self.max), dim=-1)
