"""Core geometric record types as NamedTuples of torch tensors (SoA, batch-first).

Counterpart of ``hare_tpu/geom/primitives.py``: ``Ray`` carries the
reference's ``poly_origin1/2`` exclusion pair, ``HitRecord`` the ``X_Event``
fields.  All fields share one batch prefix and live on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Ray", "HitRecord", "NO_POLY"]

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
