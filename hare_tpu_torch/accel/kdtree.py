"""KD-tree: host build + the shared tree traversal (B2).

Counterpart of ``hare_tpu/accel/kdtree.py``; ``_sah_plane`` and the build
are NumPy copies of the JAX host code (bit-equal tables) — the rebuild of
``KDTree.cs:23-633``:

  - plane placement: binned SAH with free axis choice (``split="sah"``,
    the default) or the reference's depth%3 axis with the median member
    centroid (``split="median"``, ``KDTree.cs:95-105``);
  - triangles straddling the plane go to both children (``:123-133``);
  - recursion stops at ``max_depth`` or ``max_tris_per_node`` (``:92``),
    and SAH also stops where no plane beats the leaf cost, so SAH leaves
    may hold more than ``max_tris_per_node`` triangles;
  - ``levels > 1`` collapses that many binary levels into one supernode
    layer (``tree.collapse_levels``, K = 2^levels).

Traversal: :func:`~.tree.shoot_tree` (B2).  Unlike the reference's
near/far stack, which never prunes against the best hit, B2 prunes every
node whose entry t exceeds it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ..geom.intersect import MIN_T
from ..mesh.topology import Topology
from .octree import _extract, auto_depth
from .tree import TreeTables, build_tree_tables, collapse_levels, shoot_tree

__all__ = ["KDTree", "build_kdtree", "build_kdtree_tables", "shoot_kdtree"]

# Alias: the KD-tree device structure IS the shared tree tables.
KDTree = TreeTables

SPLITS = ("median", "sah")


def _sah_plane(
    ids: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    nmin: np.ndarray,
    nmax: np.ndarray,
    n_bins: int = 32,
    traversal_cost: float = 1.0,
    isect_cost: float = 1.5,
    empty_bonus: float = 0.8,
):
    """Best binned-SAH split plane ``(axis, value)`` for one node, or
    ``None`` if no plane beats the leaf cost.

    ``n_bins - 1`` uniformly spaced candidate planes per axis:
    ``cost = Ct + Ci * (SA_L*NL + SA_R*NR) / SA_parent`` with straddlers
    counted on both sides (the membership rule ``lo <= sv`` / ``hi >= sv``)
    and the ``empty_bonus`` discount when one side is empty."""
    n = len(ids)
    ext = nmax - nmin
    sa_parent = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[2] * ext[0])
    if sa_parent <= 0.0:
        return None
    leaf_cost = isect_cost * n
    best = (leaf_cost, -1, 0.0)
    for ax in range(3):
        if ext[ax] <= 1e-12:
            continue
        planes = nmin[ax] + ext[ax] * (np.arange(1, n_bins) / n_bins)
        lo_s = np.sort(lo[ids, ax])
        hi_s = np.sort(hi[ids, ax])
        nl = np.searchsorted(lo_s, planes, side="right")
        nr = n - np.searchsorted(hi_s, planes, side="left")
        o = (ax + 1) % 3, (ax + 2) % 3
        girth = ext[o[0]] * ext[o[1]]
        rim = ext[o[0]] + ext[o[1]]
        d_l = planes - nmin[ax]
        sa_l = 2.0 * (girth + rim * d_l)
        sa_r = 2.0 * (girth + rim * (ext[ax] - d_l))
        cost = traversal_cost + isect_cost * (sa_l * nl + sa_r * nr) / sa_parent
        cost = np.where((nl == 0) | (nr == 0), cost * empty_bonus, cost)
        j = int(np.argmin(cost))
        if cost[j] < best[0]:
            best = (float(cost[j]), ax, float(planes[j]))
    if best[1] < 0:
        return None
    return best[1], best[2]


def kd_split(split, ids, depth, lo, hi, centroid, nmin, nmax):
    """The split plane ``(axis, value)`` of one node under policy
    ``split``, or ``None`` (SAH: no plane beats the leaf cost)."""
    if split == "sah":
        return _sah_plane(ids, lo, hi, nmin, nmax)
    ax = depth % 3  # KDTree.cs:95
    return ax, float(np.median(centroid[ids, ax]))  # median centroid split


def build_kdtree_tables(
    source: Union[Topology, Sequence[Topology]],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    levels: int = 1,
    split: str = "sah",
) -> dict:
    """The KD-tree's host tables, bit-equal to the JAX ``build_kdtree``
    (fields of ``build_tree_tables``).  ``max_depth=None`` right-sizes the
    depth via :func:`~.octree.auto_depth`."""
    if split not in SPLITS:
        raise ValueError(f"unknown split policy {split!r}")
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 2, 2, 2, 22)
    lo = tri.min(axis=1)  # (T, 3) per-tri AABB
    hi = tri.max(axis=1)
    centroid = tri.mean(axis=1)
    root_min = lo.min(axis=0) - pad
    root_max = hi.max(axis=0) + pad

    node_min, node_max = [root_min.copy()], [root_max.copy()]
    child_ids = [np.full(2, -1, np.int64)]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        plane = kd_split(split, ids, depth, lo, hi, centroid, node_min[nid], node_max[nid])
        if plane is None:  # no plane beats the leaf cost
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        ax, sv = plane
        go_left = lo[ids, ax] <= sv  # straddlers -> both (:123-133)
        go_right = hi[ids, ax] >= sv
        lids, rids = ids[go_left], ids[go_right]
        if len(lids) == len(ids) and len(rids) == len(ids):
            # Degenerate split (all straddle): make a leaf.
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        for side, cids in ((0, lids), (1, rids)):
            cmin = node_min[nid].copy()
            cmax = node_max[nid].copy()
            if side == 0:
                cmax[ax] = sv
            else:
                cmin[ax] = sv
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_ids.append(np.full(2, -1, np.int64))
            leaf_lists.append(np.zeros(0, np.int64))
            child_ids[nid][side] = cid
            stack.append((cid, cids, depth + 1))

    ch = np.stack(child_ids)
    eff_depth = max_depth
    if levels > 1:
        ch = collapse_levels(ch, root=0, levels=levels)
        eff_depth = -(-max_depth // levels)
    return build_tree_tables(
        tri, tri_poly, tri_top, ch, np.stack(node_min), np.stack(node_max),
        leaf_lists, root=0, max_depth=eff_depth,
    )


def build_kdtree(
    source: Union[Topology, Sequence[Topology]],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    levels: int = 1,
    split: str = "sah",
    device="cuda",
) -> KDTree:
    """Build the KD-tree on the host (:func:`build_kdtree_tables`) and put
    it on ``device``."""
    tables = build_kdtree_tables(source, max_depth, max_tris_per_node, pad, levels, split)
    return TreeTables.from_numpy(**tables, device=device)


def shoot_kdtree(
    scene, rays, tree: KDTree, kernel: str = "watertight", min_t: float = MIN_T,
    top_index: Optional[int] = None, with_stats: bool = False,
):
    """Nearest-hit via the shared tree traversal (B2 then K2)."""
    return shoot_tree(scene, rays, tree, kernel, min_t, top_index, with_stats)
