"""Octree: host build + the shared tree traversal (B2).

Counterpart of ``hare_tpu/accel/octree.py``.  ``_extract``, ``auto_depth``
and the build are NumPy copies of the JAX host code (bit-equal tables; the
SAT is the port's ``geom/tribox.py``) — the rebuild of the live octree of
``Octree - alt.cs:22-308``: a cubified padded root box, 8-way splits at the
centre with children padded by 0.1 %, triangles replicated into every child
the SAT says they overlap, recursion to ``max_depth`` or
``max_tris_per_node``.  Empty children do not exist in the tables.

Traversal: :func:`~.tree.shoot_tree` (B2, K = 8).  All topologies share one
tree; ``top_index`` filters at test time.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..geom.intersect import MIN_T
from ..geom.tribox import tri_box_overlap
from ..mesh.scene import PAD_POLY, Scene
from ..mesh.topology import Topology
from ..utils.tracing import span
from .tree import TreeTables, build_tree_tables, shoot_tree

__all__ = ["Octree", "auto_depth", "build_octree", "build_octree_tables", "shoot_octree"]

# Alias: the octree device structure IS the shared tree tables.
Octree = TreeTables

CHILD_PAD = 1.001  # 0.1% child box padding (Octree - alt.cs:118-130)


def _extract(source: Union[Topology, Sequence[Topology], Scene]):
    """(tri (T, 3, 3) f64, tri_poly, tri_top) of a topology, a list of
    them (with the polygon offsets of ``build_scene``) or a ``Scene``: its
    f32 corners widened to f64 on the host, the pad rows dropped, as the
    JAX ``_extract`` reads ``scene.tri_vertices()`` (the tables then round
    as JAX's built from the same ``Scene``)."""
    if isinstance(source, Scene):
        tri_poly = source.tri_poly.cpu().numpy()
        keep = tri_poly != PAD_POLY
        v = source.vertices.detach().cpu().numpy()
        tri = v[source.tri_v.cpu().numpy()[keep]].astype(np.float64)
        return tri, tri_poly[keep], source.tri_top.cpu().numpy()[keep]
    if isinstance(source, Topology):
        return (
            source.vertices[source.tri_v],
            source.tri_poly,
            np.zeros(source.n_tris, np.int32),
        )
    parts, pp, tt = [], [], []
    p_off = 0
    for ti, t in enumerate(source):
        parts.append(t.vertices[t.tri_v])
        pp.append(t.tri_poly + p_off)
        tt.append(np.full(t.n_tris, ti, np.int32))
        p_off += t.n_polys
    return np.concatenate(parts), np.concatenate(pp), np.concatenate(tt)


def auto_depth(
    n_tris: int, leaf: int, branch: int, slack: int, lo: int, hi: int
) -> int:
    """Right-size a tree depth to the scene: ``ceil(log_branch(ceil(n/leaf)))
    + slack``, clamped to [lo, hi].  Shared by the octree and both KD
    builders so the heuristic cannot diverge."""
    full = max(1, -(-n_tris // max(leaf, 1)))
    return min(max(int(np.ceil(np.log(full) / np.log(branch))) + slack, lo), hi)


def build_octree_tables(
    source: Union[Topology, Sequence[Topology], Scene],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 16,
    pad: float = 1e-3,
) -> dict:
    """The octree's host tables, bit-equal to the JAX ``build_octree``
    (fields of ``build_tree_tables``).  ``max_depth=None`` right-sizes the
    depth to the scene via :func:`auto_depth`."""
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 8, 1, 2, 10)
    lo = tri.reshape(-1, 3).min(axis=0) - pad
    hi = tri.reshape(-1, 3).max(axis=0) + pad
    # Cubify on the max dimension (Octree - alt.cs:78-85), centered.
    c = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo).max()

    node_min, node_max = [c - half], [c + half]
    child_ids = [np.full(8, -1, np.int64)]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        nmin, nmax = node_min[nid], node_max[nid]
        ctr = 0.5 * (nmin + nmax)
        for k in range(8):
            cmin = np.where([k & 4, k & 2, k & 1], ctr, nmin)
            cmax = np.where([k & 4, k & 2, k & 1], nmax, ctr)
            half_k = 0.5 * (cmax - cmin) * CHILD_PAD
            keep = tri_box_overlap(tri[ids], 0.5 * (cmin + cmax), half_k)
            cids = ids[keep]
            if len(cids) == 0:
                continue  # empty children do not exist in the tables
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_ids.append(np.full(8, -1, np.int64))
            leaf_lists.append(np.zeros(0, np.int64))
            child_ids[nid][k] = cid
            stack.append((cid, cids, depth + 1))
        if (child_ids[nid] < 0).all():
            leaf_lists[nid] = ids.astype(np.int64)  # nothing split out

    return build_tree_tables(
        tri, tri_poly, tri_top, np.stack(child_ids), np.stack(node_min),
        np.stack(node_max), leaf_lists, root=0, max_depth=max_depth,
    )


def build_octree(
    source: Union[Topology, Sequence[Topology], Scene],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 16,
    pad: float = 1e-3,
    device="cuda",
) -> Octree:
    """Build the octree on the host (:func:`build_octree_tables`) and put it
    on ``device``."""
    with span("hare.setup.structure", accel="octree"):
        with span("hare.setup.structure.tables"):
            tables = build_octree_tables(source, max_depth, max_tris_per_node, pad)
        with span("hare.setup.structure.upload"):
            return TreeTables.from_numpy(**tables, device=device)


def shoot_octree(
    scene, rays, tree: Octree, kernel: str = "watertight", min_t: float = MIN_T,
    top_index: Optional[int] = None, with_stats: bool = False,
):
    """Nearest-hit via the shared tree traversal (B2 then K2)."""
    return shoot_tree(scene, rays, tree, kernel, min_t, top_index, with_stats)
