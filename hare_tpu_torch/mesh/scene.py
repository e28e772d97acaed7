"""Device-side scene representation: padded SoA tensors in a NamedTuple.

Counterpart of ``hare_tpu/mesh/scene.py``.  One layout change: the JAX
``tri_geom`` row (T, 16) carries int32 ids bitcast into f32 lanes 9-15.  Here
those ids stay int32 in ``tri_meta`` and ``tri_geom`` is the (T, 9) f32
geometry block, so no id ever passes through float data movement, and
``with_vertices`` refreshes the geometry without the TPU's int-domain
splice (``hare_tpu/mesh/scene.py:132-148``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geom.math import cross, normalize

__all__ = ["Scene", "PAD_POLY"]

# Polygon id used for padding triangles: never matches a real poly nor the
# NO_POLY (-1) exclusion sentinel.
PAD_POLY = -2


class Scene(NamedTuple):
    """Flat triangle soup + topology metadata, ready for device kernels.

    Quads are pre-split (0,1,2)+(2,3,0) with both halves sharing one
    ``tri_poly`` id; triangle arrays are padded with degenerate all-zero
    triangles of poly id ``PAD_POLY``, which never hit (``det == 0``).
    """

    vertices: torch.Tensor  # (V, 3) f32
    tri_v: torch.Tensor  # (T, 3) i32 — vertex indices per triangle
    tri_poly: torch.Tensor  # (T,) i32 — polygon id (quad halves share)
    tri_top: torch.Tensor  # (T,) i32 — topology index
    poly_plane: torch.Tensor  # (P,) i32 — plane group id per polygon
    # Neighbouring polygon across each triangle edge k = corners (k, k+1);
    # NO_POLY where boundary or same-poly (quad diagonal).
    tri_edge_poly: torch.Tensor  # (T, 3) i32
    # Packed static per-triangle metadata (the JAX layout):
    #   lane 0    tri_poly
    #   lanes 1-3 tri_edge_poly pre-filtered to COPLANAR neighbours only
    #   lanes 4-6 tri_v
    #   lane 7    tri_top
    tri_meta: torch.Tensor  # (T, 8) i32
    # Per-triangle geometry v0 | e1 | e2 (f32, from build-time vertices).
    tri_geom: torch.Tensor  # (T, 9) f32

    @property
    def n_tris(self) -> int:
        return self.tri_v.shape[0]

    @property
    def n_polys(self) -> int:
        return self.poly_plane.shape[0]

    def tri_vertices(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-triangle corners ``(v0, v1, v2)``, each ``(T, 3)``, gathered
        from ``vertices`` (``hare_tpu/mesh/scene.py:91-99``).  The gradient
        to ``vertices`` goes through ``gather_rows``' fixed-order scatter, so
        it repeats to the bit (plain indexing's backward is an atomic
        ``index_put_``)."""
        from ..accel.scatter import gather_rows

        return tuple(gather_rows(self.vertices, self.tri_v[:, k]) for k in range(3))

    def tri_normals(self, unit: bool = True) -> torch.Tensor:
        """Per-triangle normals ``cross(v1 - v0, v2 - v0)`` from the current
        vertices, ``(T, 3)``, unit unless ``unit=False``
        (``hare_tpu/mesh/scene.py:101-109``; ``Polygon`` ctor,
        ``Hare_Geometry_Polygons.cs:158-172``).  Built on
        :meth:`tri_vertices`, so the vertex gradient repeats to the bit; a
        pad triangle (all corners at one vertex) has a zero normal and adds
        nothing to the gradient."""
        v0, v1, v2 = self.tri_vertices()
        n = cross(v1 - v0, v2 - v0)
        return normalize(n) if unit else n

    def with_vertices(self, vertices: torch.Tensor) -> "Scene":
        """``Set_Vertex`` (``Hare_Geometry_Topology.cs:506-511``): the same
        topology at new coordinates, ``hare_tpu/mesh/scene.py:111-149``.

        ``tri_geom`` is recomputed from ``vertices`` (v0 | v1 - v0 | v2 - v0
        in f32, bit-equal to the JAX package's lanes 0-8), so every backend's
        forward sees the live coordinates; the traversal tables keep their
        build-time geometry (rebuild the structure after large moves).  The
        rows are computed without autograd, as the JAX package stops their
        gradient: the finalize backward (``accel.common.finalize_hits``)
        takes d/d(vertices) from the live vertices, exactly once.
        """
        if self.tri_geom.shape[0] == 0 or vertices.shape[0] == 0:
            return self._replace(vertices=vertices)
        with torch.no_grad():
            v = vertices.to(self.tri_geom.dtype)
            tv = self.tri_v.long()
            v0, v1, v2 = v[tv[:, 0]], v[tv[:, 1]], v[tv[:, 2]]
            tri_geom = torch.cat([v0, v1 - v0, v2 - v0], dim=1)
        return self._replace(vertices=vertices, tri_geom=tri_geom)
