"""Ray and point sampling (``hare_tpu/trace/sampler.py``).

``uniform_sphere`` (the acoustic source's emission), and the surface
samplers: ``Triangle.GetRandomPoint``'s sqrt warp
(``Hare_Geometry_Polygons.cs:690-696``), ``Quadrilateral``'s area-weighted
choice of its two triangles (``:724-728, 839-862``) and its generalization
to a whole scene.

``torch.Generator`` streams differ from ``jax.random``'s, so parity tests
feed both packages the same NumPy directions, or JAX's own uniforms through
:func:`warp_triangle`.  Every sampler draws its numbers on the generator's
device (the CPU without one) and then moves them to ``device``, the card
unless the caller names another, so one seed gives the same samples on
every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..accel.scatter import gather_rows
from ..geom.math import cross, norm
from ..mesh.scene import Scene

__all__ = [
    "polygon_points",
    "scene_surface_points",
    "triangle_points",
    "uniform_sphere",
    "warp_triangle",
]


def _rand(n: int, generator: Optional[torch.Generator], dtype=torch.float32) -> torch.Tensor:
    src = generator.device if generator is not None else torch.device("cpu")
    return torch.rand(n, generator=generator, device=src, dtype=dtype)


def uniform_sphere(
    n: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """n directions uniform on S^2 (the standard acoustic source emission)."""
    z = _rand(n, generator, dtype) * 2.0 - 1.0
    phi = _rand(n, generator, dtype) * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    out = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return out.to(device)


def warp_triangle(
    v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
) -> torch.Tensor:
    """The points of the sqrt warp ``u = 1 - sqrt(r1)``, ``v = r2 sqrt(r1)``
    on the triangles ``(v0, v1, v2)`` (each ``(3,)`` or ``(n, 3)``), from the
    uniforms ``r1``, ``r2`` ``(n,)``."""
    tmp = torch.sqrt(r1)
    u = 1.0 - tmp
    v = r2 * tmp
    return v0 + u[:, None] * (v1 - v0) + v[:, None] * (v2 - v0)


def triangle_points(
    v0: torch.Tensor,
    v1: torch.Tensor,
    v2: torch.Tensor,
    n: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """n uniform points on the triangle ``(v0, v1, v2)`` (``GetRandomPoint``,
    ``Hare_Geometry_Polygons.cs:690-696``), ``(n, 3)`` on ``device``."""
    r1 = _rand(n, generator).to(device)
    r2 = _rand(n, generator).to(device)
    return warp_triangle(*(v.to(device) for v in (v0, v1, v2)), r1, r2)


def polygon_points(
    topology,
    poly_id: int,
    n: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """n uniform points on polygon ``poly_id`` of a :class:`Topology`.

    ``Quadrilateral.GetRandomPoint`` (``Hare_Geometry_Polygons.cs:724-728,
    839-862``): a quad picks its (0,1,2) or (2,3,0) half with probability
    proportional to its f32 area, then sqrt-warps inside it; a triangle is
    ``Triangle.GetRandomPoint`` directly."""
    v = torch.as_tensor(topology.vertices[topology.poly_verts[poly_id]], dtype=torch.float32)
    if v.shape[0] == 3:
        return triangle_points(v[0], v[1], v[2], n, generator, device)
    a1 = 0.5 * norm(cross(v[1] - v[0], v[2] - v[0]))
    a2 = 0.5 * norm(cross(v[3] - v[2], v[0] - v[2]))
    second = _rand(n, generator).to(device) < (a2 / (a1 + a2)).to(device)
    p1 = triangle_points(v[0], v[1], v[2], n, generator, device)
    p2 = triangle_points(v[2], v[3], v[0], n, generator, device)
    return torch.where(second[:, None], p2, p1)


def scene_surface_points(
    scene: Scene,
    n: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """n area-weighted uniform points on the whole scene surface, ``(n, 3)``
    on ``device``: triangles picked with probability proportional to area
    (``torch.multinomial``, where the JAX package takes
    ``jax.random.categorical``), then sqrt-warped.  Padding triangles, of
    area 0, are never picked (JAX weights them at 1e-30)."""
    v0, v1, v2 = scene.tri_vertices()
    area = 0.5 * norm(cross(v1 - v0, v2 - v0))
    src = generator.device if generator is not None else torch.device("cpu")
    idx = torch.multinomial(area.detach().to(src), n, replacement=True, generator=generator)
    idx = idx.to(device=v0.device, dtype=torch.int32)
    r1 = _rand(n, generator).to(device)
    r2 = _rand(n, generator).to(device)
    return warp_triangle(*(gather_rows(x, idx).to(device) for x in (v0, v1, v2)), r1, r2)
