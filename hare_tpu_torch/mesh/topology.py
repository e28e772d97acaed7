"""Host-side mesh compiler: welding, adjacency, planes — emits a torch `Scene`.

A NumPy copy of ``hare_tpu/mesh/topology.py`` (``Topology.build``, the
per-polygon queries, ``set_vertex``, ``poly_frames``, ``device_aux``,
``build_scene`` and ``merge_topologies``): the machine that runs the port
has no JAX, so the port cannot import the JAX package's host code.  The
tests hold every array this module makes bit-equal to the JAX package's.
``build_scene`` and ``device_aux`` end in torch tensors on the requested
device; ``closest_point`` goes through the port's
``geom.closest_point_triangle`` on CPU tensors.

Semantics preserved from the reference (``Hare_Geometry_Topology.cs``):
welding by rounding to ``precision`` decimals then ``np.unique``; degenerate
edges (< 1e-4) skipped; 3- and 4-gons only, quads split (0,1,2)+(2,3,0);
plane grouping by sign-normalized (a,b,c,d) rounded to 3 digits; edge
tributary area/length/tangent; vertex normals as normalized sums of
incident polygon normals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..utils.tracing import span, spanned
from .scene import PAD_POLY, Scene

__all__ = ["EdgeAux", "GroupedRows", "Topology", "build_scene", "merge_topologies"]


class EdgeAux(NamedTuple):
    """Device-side edge-diffraction arrays (see ``Topology.device_aux``).

    Ragged per-edge incident-polygon lists are padded to ``kmax`` lanes
    (``edge_poly == -1`` marks padding).
    """

    vertex_normals: torch.Tensor  # (V, 3)
    edges: torch.Tensor  # (E, 2) i32 vertex pairs
    edge_poly: torch.Tensor  # (E, kmax) i32, -1 padded
    edge_tributary_area: torch.Tensor  # (E, kmax)
    edge_tributary_length: torch.Tensor  # (E, kmax)
    edge_tangent: torch.Tensor  # (E, kmax, 3) unit toward poly centroid
    poly_frame: torch.Tensor  # (P, 3, 3) rows (diffx, diffy, diffz)

# Degenerate-edge threshold (Hare_Geometry_Topology.cs:282).
MIN_EDGE_LEN = 1e-4


def _round_prec(x: np.ndarray, precision: int) -> np.ndarray:
    """``Point.Round(Precision)``: round to `precision` decimal digits."""
    return np.round(x, precision)


class GroupedRows:
    """CSR-backed list-of-arrays: group ``g`` is ``values[start[g]:start[g+1]]``.

    Behaves like the ``List[np.ndarray]`` it replaces (len / index / iterate)
    but stores one flat array + offsets.  ``np.split`` materialized millions
    of tiny ndarrays at 5M-face scale (minutes of pure allocator time); this
    is O(1) per access and O(n log n) to build.
    """

    __slots__ = ("values", "start")

    def __init__(self, values: np.ndarray, start: np.ndarray):
        self.values = values
        self.start = start

    def __len__(self) -> int:
        return len(self.start) - 1

    def __getitem__(self, g):
        if isinstance(g, (int, np.integer)):
            if g < 0:
                g += len(self)
            return self.values[self.start[g] : self.start[g + 1]]
        raise TypeError(f"GroupedRows indices must be integers, got {g!r}")

    def __iter__(self):
        for g in range(len(self)):
            yield self.values[self.start[g] : self.start[g + 1]]

    def __repr__(self) -> str:
        return f"GroupedRows({len(self)} groups, {len(self.values)} items)"


@dataclass
class Topology:
    """Compiled mesh topology (host arrays, float64).

    Produced by :func:`Topology.build`; all arrays are NumPy.  The device
    handoff is :meth:`scene`, which downcasts to f32 padded tensors.
    """

    # Core
    vertices: np.ndarray  # (V, 3) f64 welded vertex positions
    poly_verts: List[np.ndarray]  # per polygon: (3,) or (4,) vertex indices
    tri_v: np.ndarray  # (T, 3) i32 triangulated faces
    tri_poly: np.ndarray  # (T,) i32 polygon id per triangle
    # Plane grouping
    poly_plane: np.ndarray  # (P,) i32 plane id per polygon
    plane_members: List[np.ndarray]  # per plane: polygon ids
    planes: np.ndarray  # (NP, 4) f64 sign-normalized (a,b,c,d)
    # Adjacency
    edges: np.ndarray  # (E, 2) i32 canonical vertex pairs
    edge_polys: List[np.ndarray]  # per edge: incident polygon ids
    edge_tributary_area: List[np.ndarray]  # per edge: area per incident poly
    edge_tributary_length: List[np.ndarray]
    edge_tangents: List[np.ndarray]  # per edge: (k,3) unit toward centroid
    poly_edges: List[np.ndarray]  # per polygon: edge ids
    vertex_polys: List[np.ndarray]  # per vertex: incident polygon ids
    # Derived
    poly_normal: np.ndarray  # (P, 3) f64 unit normals
    poly_centroid: np.ndarray  # (P, 3) f64
    poly_area: np.ndarray  # (P,) f64
    poly_convex: np.ndarray  # (P,) bool (Polygon.Convexity analog)
    poly_degenerate: np.ndarray  # (P,) bool (zero-normal polygons)
    vertex_normals: np.ndarray  # (V, 3) f64
    bbox_min: np.ndarray  # (3,) padded by 1e-12 like the reference
    bbox_max: np.ndarray
    precision: int = 15

    # ------------------------------------------------------------------ build
    @classmethod
    @spanned("hare.setup.topology")
    def build(
        cls, faces: Sequence[np.ndarray], precision: int = 15
    ) -> "Topology":
        """Compile faces into a queryable mesh.

        ``faces`` is a sequence whose elements are single ``(K, 3)`` faces
        (K in {3, 4}) or stacked ``(F, K, 3)`` chunks — chunked input skips
        the per-face Python overhead that dominates multi-million-face
        builds.  A bare ``(F, K, 3)`` ndarray is accepted too.

        The ``Build_Topology(Point[][])`` analog
        (``Hare_Geometry_Topology.cs:258-340``).
        """
        if isinstance(faces, np.ndarray) and faces.ndim == 3:
            faces = [faces]
        chunks = []
        for f in faces:
            a = np.asarray(f, np.float64)
            chunks.append(a[None] if a.ndim == 2 else a)
        if any(c.shape[-2] not in (3, 4) for c in chunks):
            raise NotImplementedError(
                "polygons of more than 4 (or fewer than 3) sides are not "
                "supported (Hare_Geometry_Topology.cs:298)"
            )
        counts = np.concatenate(
            [np.full(len(c), c.shape[1], np.int64) for c in chunks]
        ) if chunks else np.zeros(0, np.int64)

        # --- Weld: round then unique over all corners (AddGetIndex analog).
        with span("hare.setup.topology.weld"):
            flat = _round_prec(
                np.concatenate([c.reshape(-1, 3) for c in chunks], axis=0)
                if chunks else np.zeros((0, 3)),
                precision,
            )
            vertices, inverse = np.unique(flat, axis=0, return_inverse=True)
            # np.unique sorts; keep first-appearance order like the reference's
            # incremental indexing so vertex ids are stable under face order.
            first_pos = np.full(len(vertices), len(flat), np.int64)
            np.minimum.at(first_pos, inverse, np.arange(len(flat)))
            order = np.argsort(first_pos, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            vertices = vertices[order]
            inverse = rank[inverse].astype(np.int32)

            offsets = np.concatenate([[0], np.cumsum(counts)])
            poly_verts = GroupedRows(inverse, offsets)

        # --- Per-polygon centroid / normal / area (Polygon ctor analog),
        # vectorized over a (P, 4) padded index table: tris repeat corner 0
        # in slot 3 (never read where it matters).
        with span("hare.setup.topology.polys"):
            P = len(counts)
            is_quad = counts == 4
            i0 = offsets[:-1]
            pv = np.empty((P, 4), np.int32)
            pv[:, 0] = inverse[i0]
            pv[:, 1] = inverse[i0 + 1]
            pv[:, 2] = inverse[i0 + 2]
            pv[:, 3] = np.where(is_quad, inverse[np.minimum(i0 + 3, len(inverse) - 1)], pv[:, 0])
            p0, p1, p2, p3 = (vertices[pv[:, k]] for k in range(4))

            poly_centroid = (p0 + p1 + p2 + np.where(is_quad[:, None], p3, 0.0)) / counts[:, None]
            # First non-zero fan normal (Hare_Geometry_Polygons.cs:159-163):
            # fan (1,2); quads fall back to fan (1,3) if it vanishes.
            n1 = np.cross(p1 - p0, p2 - p0)
            n2 = np.cross(p1 - p0, p3 - p0)
            use2 = (np.einsum("ij,ij->i", n1, n1) == 0.0) & is_quad
            n = np.where(use2[:, None], n2, n1)
            ln = np.linalg.norm(n, axis=1, keepdims=True)
            poly_normal = np.where(ln > 0, n / np.where(ln > 0, ln, 1.0), 0.0)
            area1 = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
            area2 = 0.5 * np.linalg.norm(np.cross(p3 - p2, p0 - p2), axis=1)
            poly_area = area1 + np.where(is_quad, area2, 0.0)

            # --- Convexity / degeneracy flags (Polygon ctor analog:
            # Convexity() at Hare_Geometry_Polygons.cs:285-371 — but computed in
            # the polygon's own plane rather than the reference's unconditional
            # XY projection, which misclassifies vertical polygons; degenerate =
            # vanishing normal, :188-191).  Triangles are always convex.
            poly_degenerate = (ln[:, 0] == 0.0)
            e01 = p1 - p0
            e12 = p2 - p1
            e23 = p3 - p2
            e30 = p0 - p3
            signs = np.stack(
                [
                    np.einsum("ij,ij->i", np.cross(a_, b_), poly_normal)
                    for a_, b_ in ((e01, e12), (e12, e23), (e23, e30), (e30, e01))
                ],
                axis=1,
            )
            quad_convex = (signs >= -1e-12).all(axis=1) | (signs <= 1e-12).all(axis=1)
            poly_convex = np.where(is_quad, quad_convex, True) & ~poly_degenerate

            # --- Triangulation: quads -> (0,1,2) + (2,3,0)
            # (Hare_Geometry_Polygons.cs:731-782), in face order.
            tri_per_poly = 1 + is_quad.astype(np.int64)
            tri_poly = np.repeat(np.arange(P), tri_per_poly).astype(np.int32)
            T = len(tri_poly)
            t_start = np.concatenate([[0], np.cumsum(tri_per_poly)])[:-1]
            tri_v = np.empty((T, 3), np.int32)
            tri_v[t_start] = pv[:, :3]
            tri_v[t_start[is_quad] + 1] = pv[is_quad][:, [2, 3, 0]]

        def _group(keys, values, n_groups):
            """Group values by small-int keys, preserving order (CSR-backed)."""
            order = np.argsort(keys, kind="stable")
            counts_g = np.bincount(keys, minlength=n_groups)
            start_g = np.concatenate([[0], np.cumsum(counts_g)])
            return GroupedRows(values[order], start_g)

        # --- Plane grouping by sign-normalized rounded (a,b,c,d).
        with span("hare.setup.topology.planes"):
            a_d = -np.einsum("ij,ij->i", poly_normal, p0)
            abcd = np.concatenate([poly_normal, a_d[:, None]], axis=1)
            flip = abcd[:, 3] < 0
            abcd[flip] *= -1.0
            key = np.round(abcd, 3)
            planes, plane_inv = np.unique(key, axis=0, return_inverse=True)
            # stable first-appearance ordering again
            first = np.full(len(planes), P, np.int64)
            np.minimum.at(first, plane_inv, np.arange(P))
            order = np.argsort(first, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            planes = planes[order]
            poly_plane = rank[plane_inv].astype(np.int32)
            plane_members = _group(poly_plane, np.arange(P, dtype=np.int32), len(planes))

        # --- Edges: canonical pairs per face side, unique; skip short edges
        # (Hare_Geometry_Topology.cs:282).  (P, 4, 2) padded side table; side
        # 2 closes the triangle (2,0) or continues the quad (2,3); side 3
        # exists only for quads.
        with span("hare.setup.topology.edges"):
            sides = np.empty((P, 4, 2), np.int32)
            sides[:, 0] = pv[:, [0, 1]]
            sides[:, 1] = pv[:, [1, 2]]
            sides[:, 2, 0] = pv[:, 2]
            sides[:, 2, 1] = np.where(is_quad, pv[:, 3], pv[:, 0])
            sides[:, 3] = pv[:, [3, 0]]
            side_valid = np.ones((P, 4), bool)
            side_valid[:, 3] = is_quad
            inst_poly = np.repeat(np.arange(P, dtype=np.int32), 4)[side_valid.ravel()]
            inst = sides.reshape(-1, 2)[side_valid.ravel()]
            seg = vertices[inst[:, 0]] - vertices[inst[:, 1]]
            keep = np.linalg.norm(seg, axis=1) >= MIN_EDGE_LEN
            inst, inst_poly = inst[keep], inst_poly[keep]
            canon = np.sort(inst, axis=1)
            if len(canon):
                edges, e_inv = np.unique(canon, axis=0, return_inverse=True)
                firste = np.full(len(edges), len(canon), np.int64)
                np.minimum.at(firste, e_inv, np.arange(len(canon)))
                order = np.argsort(firste, kind="stable")
                rank = np.empty_like(order)
                rank[order] = np.arange(len(order))
                edges = edges[order]
                e_inv = rank[e_inv].astype(np.int32)
            else:
                edges = np.zeros((0, 2), np.int32)
                e_inv = np.zeros((0,), np.int32)
            E = len(edges)

            # Edge.Append_Poly_Relationship quantities, vectorized per instance
            # (Hare_Geometry_Primitives.cs:288-299).
            a = vertices[edges[e_inv, 0]] if len(e_inv) else np.zeros((0, 3))
            b = vertices[edges[e_inv, 1]] if len(e_inv) else np.zeros((0, 3))
            c = poly_centroid[inst_poly]
            ta = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
            ab = b - a
            tproj = np.einsum("ij,ij->i", c - a, ab) / np.einsum("ij,ij->i", ab, ab)
            tan = c - (a + tproj[:, None] * ab)
            tl = np.linalg.norm(tan, axis=1)
            tanu = np.where(tl[:, None] > 0, tan / np.where(tl[:, None] > 0, tl[:, None], 1), tan)

            edge_polys = _group(e_inv, inst_poly, E)
            edge_ta = _group(e_inv, ta, E)
            edge_tl = _group(e_inv, tl, E)
            edge_tan = _group(e_inv, tanu, E)
            poly_edges = _group(inst_poly, e_inv, P)

            # --- Vertex adjacency + normals (Finish_Topology analog): one unit
            # polygon normal added per vertex occurrence, then normalized.
            corner_poly = np.repeat(np.arange(P, dtype=np.int32), counts)
            vertex_polys = _group(inverse, corner_poly, len(vertices))
            vertex_normals = np.zeros_like(vertices)
            np.add.at(vertex_normals, inverse, poly_normal[corner_poly])
            ln = np.linalg.norm(vertex_normals, axis=1, keepdims=True)
            vertex_normals = np.where(ln > 0, vertex_normals / np.where(ln > 0, ln, 1), 0.0)

        pad = 1e-12  # Hare_Geometry_Topology.cs:165-166
        return cls(
            vertices=vertices,
            poly_verts=poly_verts,
            tri_v=tri_v,
            tri_poly=tri_poly,
            poly_plane=poly_plane,
            plane_members=plane_members,
            planes=planes,
            edges=edges.astype(np.int32),
            edge_polys=edge_polys,
            edge_tributary_area=edge_ta,
            edge_tributary_length=edge_tl,
            edge_tangents=edge_tan,
            poly_edges=poly_edges,
            vertex_polys=vertex_polys,
            poly_normal=poly_normal,
            poly_centroid=poly_centroid,
            poly_area=poly_area,
            poly_convex=poly_convex,
            poly_degenerate=poly_degenerate,
            vertex_normals=vertex_normals,
            bbox_min=vertices.min(axis=0) - pad if len(vertices) else np.zeros(3),
            bbox_max=vertices.max(axis=0) + pad if len(vertices) else np.zeros(3),
            precision=precision,
        )

    @classmethod
    def from_indexed(
        cls, points: np.ndarray, faces: Sequence[Sequence[int]], precision: int = 15
    ) -> "Topology":
        """``Set_Topology(Point[], int[][])`` analog
        (``Hare_Geometry_Topology.cs:518-532``): indexed-mesh ingest.  Still
        welds (indices may alias coincident points)."""
        points = np.asarray(points, np.float64)
        return cls.build([points[np.asarray(f)] for f in faces], precision)

    # ----------------------------------------------------------------- counts
    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_polys(self) -> int:
        return len(self.poly_verts)

    @property
    def n_tris(self) -> int:
        return len(self.tri_v)

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_planes(self) -> int:
        return len(self.planes)

    # ----------------------------------------------------------- device scene
    def scene(
        self,
        dtype=np.float32,
        pad_to: int = 128,
        top_index: int = 0,
        n_topologies: int = 1,
        device="cuda",
    ) -> Scene:
        """Emit the padded device :class:`Scene` on ``device``.
        ``top_index`` and ``n_topologies`` are accepted and ignored, as the
        JAX ``Topology.scene`` ignores them; ``dtype`` is float32 only
        (:func:`build_scene`)."""
        return build_scene([self], dtype=dtype, pad_to=pad_to, device=device)

    # -------------------------------------------------- per-polygon queries
    # Host-side analogs of the reference Topology utility surface
    # (Hare_Geometry_Topology.cs:550-675).
    def polygon_area(self, poly_id: int) -> float:
        """``Polygon_Area`` (``Hare_Geometry_Topology.cs:550-560``)."""
        return float(self.poly_area[poly_id])

    def polygon_centroid(self, poly_id: int) -> np.ndarray:
        """``Polygon_Centroid`` (``:562-566``)."""
        return self.poly_centroid[poly_id]

    def dist_to_plane(self, p, poly_id: int) -> float:
        """``DistToPlane(Point, Poly_ID)`` (``:583-587``): signed distance
        from p to the polygon's plane."""
        n = self.poly_normal[poly_id]
        q = self.vertices[self.poly_verts[poly_id][0]]
        return float(np.dot(n, np.asarray(p, np.float64) - q))

    def closest_point(self, p, poly_id: int) -> np.ndarray:
        """``Closest_Point(Point, Poly_ID)`` (``:589-615``): closest point on
        the polygon (min over its triangle fans, Voronoi-region exact), by
        :func:`~..geom.closest.closest_point_triangle` on float32 CPU
        tensors, as the JAX package computes it (JAX's default 32-bit
        arrays)."""
        from ..geom.closest import closest_point_triangle

        p = np.asarray(p, np.float64)
        tris = self.tri_v[self.tri_poly == poly_id]
        v = self.vertices
        best, best_d = None, np.inf
        for t in tris:
            q = closest_point_triangle(
                *(torch.from_numpy(x.astype(np.float32)) for x in (p, v[t[0]], v[t[1]], v[t[2]]))
            ).numpy()
            dd = float(np.sum((q - p) ** 2))
            if dd < best_d:
                best, best_d = q, dd
        return best

    def set_vertex(self, index: int, xyz) -> None:
        """In-place coordinate update (``Set_Vertex``,
        ``Hare_Geometry_Topology.cs:506-511``).  Derived host quantities are
        NOT recomputed (the reference also leaves polygon normals stale);
        the device kernels recompute from the vertices."""
        self.vertices[index] = np.asarray(xyz, np.float64)

    def poly_frames(self) -> np.ndarray:
        """Per-polygon orthonormal local frame, ``(P, 3, 3)`` with rows
        (diffx, diffy, diffz) — the stored frame of
        ``Hare_Geometry_Polygons.cs:173-182``: diffz = unit normal, diffx =
        first edge normalized, diffy = diffz x diffx.  Degenerate polygons
        get a zero frame."""
        P = self.n_polys
        v = self.vertices
        i0 = np.fromiter((pv[0] for pv in self.poly_verts), np.int64, P)
        i1 = np.fromiter((pv[1] for pv in self.poly_verts), np.int64, P)
        dx = v[i1] - v[i0]
        ln = np.linalg.norm(dx, axis=1, keepdims=True)
        dx = np.where(ln > 0, dx / np.where(ln > 0, ln, 1), 0.0)
        dz = self.poly_normal
        dy = np.cross(dz, dx)
        frames = np.stack([dx, dy, dz], axis=1)
        frames[self.poly_degenerate] = 0.0
        return frames

    def device_aux(self, dtype: torch.dtype = torch.float32, device="cuda") -> EdgeAux:
        """Device-side consumer arrays for edge diffraction on ``device``:
        vertex normals (``Hare_Geometry_Topology.cs:169-179``), per-edge
        tributary area / length / tangent per incident polygon
        (``Hare_Geometry_Primitives.cs:288-299``) and polygon local frames,
        the ragged lists padded to rectangles, so a consumer can gather them
        per hit on the device."""
        E = len(self.edges)
        counts = (
            np.diff(self.edge_polys.start)
            if isinstance(self.edge_polys, GroupedRows)
            else np.fromiter((len(g) for g in self.edge_polys), np.int64, E)
        )
        kmax = int(counts.max(initial=1))
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        ep = np.full((E, kmax), -1, np.int32)
        ta = np.zeros((E, kmax), np_dtype)
        tl = np.zeros((E, kmax), np_dtype)
        tg = np.zeros((E, kmax, 3), np_dtype)
        lane = np.arange(kmax)
        msk = lane[None, :] < counts[:, None]
        if isinstance(self.edge_polys, GroupedRows):
            pos = (self.edge_polys.start[:-1, None] + lane)[msk]
            ep[msk] = self.edge_polys.values[pos]
            ta[msk] = self.edge_tributary_area.values[pos]
            tl[msk] = self.edge_tributary_length.values[pos]
            tg[msk] = self.edge_tangents.values[pos]
        else:  # plain list-of-arrays
            for e in range(E):
                k = counts[e]
                ep[e, :k] = self.edge_polys[e]
                ta[e, :k] = self.edge_tributary_area[e]
                tl[e, :k] = self.edge_tributary_length[e]
                tg[e, :k] = self.edge_tangents[e]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return EdgeAux(
            vertex_normals=dev(self.vertex_normals.astype(np_dtype)),
            edges=dev(self.edges),
            edge_poly=dev(ep),
            edge_tributary_area=dev(ta),
            edge_tributary_length=dev(tl),
            edge_tangent=dev(tg),
            poly_frame=dev(self.poly_frames().astype(np_dtype)),
        )


def _ceil_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


@spanned("hare.setup.scene")
def build_scene(
    topologies: Sequence[Topology], dtype=np.float32, pad_to: int = 128, device="cuda"
) -> Scene:
    """Pack one or more topologies into a single padded device Scene.

    The multi-topology model (``Spatial_Partition.Model`` being a
    ``Topology[]``, ``Spatial_Partition.cs:29``) is realized as a ``tri_top``
    id array — unlike the reference octree/KD-tree, which rebuild and
    overwrite the root per topology and only actually serve the last one
    (defect noted at ``KDTree.cs:71-87`` / ``Octree - alt.cs:63-88``).

    The tables are built in NumPy exactly as the JAX package builds them;
    the JAX ``tri_geom`` row's int32 lanes 9-15 are NOT carried as floats
    here — the same ids live in ``tri_meta`` (lanes 0-6), so ``tri_geom``
    is the (T, 9) geometry block alone.

    ``dtype`` is the vertices' type, float32 only: every kernel reads f32
    scenes, and the JAX package, which never enables x64, makes f32 arrays
    for ``np.float64`` too.  Any other type raises ``ValueError``.
    """
    if not (dtype is torch.float32
            or (not isinstance(dtype, torch.dtype) and np.dtype(dtype) == np.float32)):
        raise ValueError(f"dtype {dtype!r}: the port's scenes are float32 (its kernels read f32)")
    v_parts, tv_parts, tp_parts, tt_parts, pp_parts = [], [], [], [], []
    v_off = p_off = 0
    for ti, top in enumerate(topologies):
        v_parts.append(top.vertices)
        tv_parts.append(top.tri_v + v_off)
        tp_parts.append(top.tri_poly + p_off)
        tt_parts.append(np.full(top.n_tris, ti, np.int32))
        pp_parts.append(top.poly_plane)
        v_off += top.n_vertices
        p_off += top.n_polys
    vertices = np.concatenate(v_parts, axis=0)
    tri_v = np.concatenate(tv_parts, axis=0)
    tri_poly = np.concatenate(tp_parts, axis=0)
    tri_top = np.concatenate(tt_parts, axis=0)
    poly_plane = np.concatenate(pp_parts, axis=0)

    T = len(tri_v)

    # --- edge-neighbor polygons (poly_origin2 support): for each triangle
    # edge (corner k -> k+1), the OTHER polygon sharing that vertex pair.
    # Vectorized: sort all 3T canonical edges, pair up identical keys.
    tri_edge_poly = np.full((T, 3), -1, np.int64)
    if T:
        ek = np.stack(
            [tri_v[:, [0, 1]], tri_v[:, [1, 2]], tri_v[:, [2, 0]]], axis=1
        ).reshape(-1, 2)  # (3T, 2)
        ek.sort(axis=1)
        key = ek[:, 0].astype(np.int64) * (v_off + 1) + ek[:, 1]
        owner = np.repeat(tri_poly, 3).astype(np.int64)
        slot = np.arange(3 * T)
        order = np.argsort(key, kind="stable")
        k_s, own_s, slot_s = key[order], owner[order], slot[order]
        # Within each equal-key run, neighbor = another instance with a
        # DIFFERENT poly id (manifold: runs of length <= 2 per poly pair;
        # welded quads contribute two same-poly instances on the diagonal).
        grp_start = np.concatenate([[True], k_s[1:] != k_s[:-1]])
        gid = np.cumsum(grp_start) - 1
        n_grp = int(gid[-1]) + 1 if len(gid) else 0
        # Each run of equal keys is one geometric edge.  A member's neighbor
        # is the run's first DIFFERENT poly id (manifold meshes have <= 2
        # distinct polys per edge; non-manifold fans resolve to the first).
        run_first = own_s[np.nonzero(grp_start)[0]][gid]
        diff = own_s != run_first
        sec = np.full(n_grp, -1, np.int64)
        pos_diff = np.nonzero(diff)[0]
        if len(pos_diff):
            g_d = gid[pos_diff]
            keep = np.concatenate([[True], g_d[1:] != g_d[:-1]])
            sec[g_d[keep]] = own_s[pos_diff[keep]]
        # Members matching the run's first poly get the second distinct poly
        # (or -1); differing members get the first.
        other = np.where(diff, run_first, sec[gid])
        tep = np.full(3 * T, -1, np.int64)
        tep[slot_s] = other
        tri_edge_poly = tep.reshape(T, 3)
        # Same-poly adjacency (quad diagonals) is useless for exclusion.
        tri_edge_poly[tri_edge_poly == np.repeat(tri_poly, 3).reshape(T, 3)] = -1

    Tp = _ceil_to(T, pad_to)
    tri_v = np.concatenate([tri_v, np.zeros((Tp - T, 3), np.int32)])
    tri_poly = np.concatenate([tri_poly, np.full(Tp - T, PAD_POLY, np.int32)])
    tri_top = np.concatenate([tri_top, np.full(Tp - T, -1, np.int32)])
    tri_edge_poly = np.concatenate(
        [tri_edge_poly, np.full((Tp - T, 3), -1, np.int64)]
    ).astype(np.int32)

    # Packed static per-tri metadata row (see Scene.tri_meta).  The coplanar
    # filter on edge neighbors is static (plane ids are build products), so
    # the bounce loop's poly_origin2 logic needs no plane lookups at all.
    if len(poly_plane):
        safe_nbr = np.maximum(tri_edge_poly, 0)
        own_plane = poly_plane[
            np.maximum(np.minimum(tri_poly, len(poly_plane) - 1), 0)
        ]
        coplanar = (tri_edge_poly >= 0) & (
            poly_plane[safe_nbr] == own_plane[:, None]
        )
    else:  # zero-polygon topology: only padded rows exist
        coplanar = np.zeros((Tp, 3), bool)
    tri_meta = np.empty((Tp, 8), np.int32)
    tri_meta[:, 0] = tri_poly
    tri_meta[:, 1:4] = np.where(coplanar, tri_edge_poly, -1)
    tri_meta[:, 4:7] = tri_v
    tri_meta[:, 7] = tri_top

    # Packed geometry row (see Scene.tri_geom): build-time v0|e1|e2 in f32.
    # Padded rows are degenerate (tri_v = 0 -> e1 = e2 = 0).
    vtx = (
        vertices[tri_v].astype(np.float32)
        if len(vertices)
        else np.zeros((Tp, 3, 3), np.float32)
    )  # (Tp, 3, 3); degenerate for the all-padding zero-vertex scene
    tri_geom = np.empty((Tp, 9), np.float32)
    tri_geom[:, 0:3] = vtx[:, 0]
    tri_geom[:, 3:6] = vtx[:, 1] - vtx[:, 0]
    tri_geom[:, 6:9] = vtx[:, 2] - vtx[:, 0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Scene(
        vertices=dev(vertices.astype(np.float32)),
        tri_v=dev(tri_v),
        tri_poly=dev(tri_poly),
        tri_top=dev(tri_top),
        poly_plane=dev(poly_plane),
        tri_edge_poly=dev(tri_edge_poly),
        tri_meta=dev(tri_meta),
        tri_geom=dev(tri_geom),
    )


def merge_topologies(topologies: Sequence[Topology], device="cuda") -> Scene:
    """Pack several topologies into one Scene on ``device``
    (:func:`build_scene`)."""
    return build_scene(topologies, device=device)
