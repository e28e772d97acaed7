"""Shared K-ary tree traversal for the octree and the KD-tree (stack walk).

Counterpart of ``hare_tpu/accel/tree.py``.  ``collapse_levels`` and
``build_tree_tables`` are NumPy copies of the JAX host code and make
bit-equal tables (the JAX gather-row layout: one row per node packs all K
children component-major — lane ``c*K + k`` holds component c of child k,
components [min.xyz | max.xyz | child id | leaf window start | leaf window
count], ids bitcast into f32 lanes).  :meth:`TreeTables.from_numpy` repacks
those rows for one GPU thread per ray:

  - ``child_box`` (n+2, K, 8) f32: min.xyz, 0, max.xyz, 0 — two float4;
  - ``child_info`` (n+2, K, 4) i32: child node id (-1 for a leaf or a
    missing child), leaf window start, leaf window count, 0;
  - the window rows tri-major (``common.repack_windows``).

Row n is the pseudo-root, whose only child is the root; row n+1 is the null
row (no children).  A missing child has an inverted box (+inf min, -inf
max), id -1 and no windows.

Traversal: :func:`tree_shoot` is B2 (``kernels/csrc/tree_shoot.cu``, one
ray per group of lanes with a stack of exact f32 ``(node, tmin)`` entries)
for CUDA tensors, :func:`tree_shoot_plain` — the same walk, lockstep over
the active rays — for CPU tensors.  Each ray pops a node, prunes it if its entry t
exceeds the best hit, slab-tests the K children, tests the window run of
each hit leaf child at once (best hit updated live), and pushes the hit
inner children far-to-near, so the nearest pops first (the reference's
``ComputeTraversalOrder``, ``Octree - alt.cs:286-306``).  Children are kept
while ``tmin <= best_t``, inclusive, so an equal-t hit with a lower
triangle id in a later leaf still wins.  None of the JAX walk's TPU shaping
is ported: the 8-bit quantised packed stack, the candidate buffers, the
P-slot push, the tiers and the straggler rounds.

The stack bound is the JAX one, ``S = (K-1) * (max_depth + 2) + 4``: each
pop pushes at most K children and inner nodes lie above ``max_depth``.  A
ray that would overflow it raises; nothing is truncated.
"""

from __future__ import annotations

import ctypes
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geom.intersect import MIN_T
from ..geom.primitives import Ray
from ..kernels import build
from ..mesh.scene import Scene
from ..utils.tracing import sync
from .common import (
    NO_HIT_KEY,
    check_device,
    check_kernel,
    check_rays,
    detach_rays,
    finalize_hits,
    key_to_hit,
    note_rows,
    pack_windows,
    ray_counter,
    repack_windows,
    test_runs,
    traversal_span,
)

__all__ = [
    "TreeTables",
    "build_tree_tables",
    "collapse_levels",
    "shoot_tree",
    "tree_shoot",
    "tree_shoot_args",
    "tree_shoot_plain",
]

# Child-row component blocks of the JAX layout: minx,miny,minz,maxx,maxy,maxz,id,ws,nw
N_COMP = 9
# Branch factors the kernel is compiled for (octree 8, KD 2, KD levels=2 4).
KERNEL_BRANCHES = (2, 4, 8)
# The largest stack bound S the kernel's launch takes; a larger S raises.
KERNEL_MAX_STACK = 128


def collapse_levels(child_ids: np.ndarray, root: int, levels: int) -> np.ndarray:
    """Collapse ``levels`` tree levels into one supernode layer (host side).

    A K-ary tree becomes a K^levels-ary tree whose supernode children are
    the depth-``levels`` frontier under each kept node (stopping early at
    leaves).  A layout transform: boxes, leaf membership and results are
    unchanged.

    Args:
      child_ids: (n, K) i64, -1 = missing; leaves have all -1.
      root: the tree root; only rows reachable from it are rewritten.
    Returns: new_child_ids (n, K^levels).
    """
    n, K = child_ids.shape
    KK = K ** levels
    is_leaf = (child_ids < 0).all(axis=1)
    new_children = np.full((n, KK), -1, np.int64)
    seen = np.zeros(n, bool)
    q = deque()
    if n and not is_leaf[root]:
        q.append(int(root))
        seen[root] = True
    while q:
        u = q.popleft()
        frontier = [u]
        for _ in range(levels):
            nxt = []
            for v in frontier:
                if is_leaf[v]:
                    nxt.append(v)
                else:
                    nxt.extend(int(c) for c in child_ids[v] if c >= 0)
            frontier = nxt
        new_children[u, : len(frontier)] = frontier
        for v in frontier:
            if not is_leaf[v] and not seen[v]:
                seen[v] = True
                q.append(v)
    return new_children


def build_tree_tables(
    tri: np.ndarray,
    tri_poly: np.ndarray,
    tri_top: np.ndarray,
    child_ids: np.ndarray,  # (n_nodes, K) i64, -1 = no child
    node_min: np.ndarray,  # (n_nodes, 3)
    node_max: np.ndarray,  # (n_nodes, 3)
    leaf_lists: list,  # per node: np.ndarray of triangle ids ([] for inner)
    root: int,
    max_depth: int,
) -> dict:
    """Pack a host-built tree into the JAX gather-row layout: the fields of
    the JAX ``TreeTables``, bit-equal, as NumPy (``branch``, ``max_depth``,
    ``row_width`` and ``max_node_need`` as Python ints).

    A pseudo-root row is appended whose only child is ``root``, so the
    traversal treats every node alike (pop -> expand children).  The JAX
    builder's 2^23-node check guards its packed (node, qtmin) stack entries;
    the port's stack keeps the node id in its own int32 and needs none.
    """
    K = child_ids.shape[1]
    n = len(node_min)
    counts = np.fromiter((len(l) for l in leaf_lists), np.int64, n)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    items = (
        np.concatenate([np.asarray(l, np.int64) for l in leaf_lists])
        if counts.sum()
        else np.zeros(0, np.int64)
    )
    win_data, win_start, n_wins = pack_windows(
        tri, tri_poly, tri_top, starts, counts, items
    )

    row_width = 32 if N_COMP * K <= 32 else 128
    # rows[i] describes node i's children; extra pseudo-root at index n.
    rows = np.zeros((n + 2, row_width), np.float32)

    # default: nonexistent children get id -1, nw 0, and an inverted box.
    neg1 = np.asarray(np.int32(-1)).view(np.float32)
    for c in range(3):
        rows[:, (0 + c) * K : (0 + c) * K + K] = np.inf  # min = +inf
        rows[:, (3 + c) * K : (3 + c) * K + K] = -np.inf  # max = -inf
    rows[:, 6 * K : 7 * K] = neg1
    rows[:, 7 * K : 8 * K] = 0.0
    rows[:, 8 * K : 9 * K] = 0.0

    # Vectorized fill over all real (parent, slot, child) edges, plus the
    # pseudo-root edge (n, 0, root) appended at the end.
    is_inner = (child_ids >= 0).any(axis=1)  # (n,)
    p_idx, k_idx = np.nonzero(child_ids >= 0)
    cids = child_ids[p_idx, k_idx]
    p_idx = np.concatenate([p_idx, [n]])
    k_idx = np.concatenate([k_idx, [0]])
    cids = np.concatenate([cids, [root]]).astype(np.int64)
    for c in range(3):
        rows[p_idx, c * K + k_idx] = node_min[cids, c]
        rows[p_idx, (3 + c) * K + k_idx] = node_max[cids, c]
    # child id only for internal nodes (-1 for leaves: nothing to push)
    rows[p_idx, 6 * K + k_idx] = np.where(
        is_inner[cids], cids, -1
    ).astype(np.int32).view(np.float32)
    rows[p_idx, 7 * K + k_idx] = win_start[cids].astype(np.int32).view(np.float32)
    rows[p_idx, 8 * K + k_idx] = n_wins[cids].astype(np.int32).view(np.float32)
    # rows[n+1] is the null row (all nonexistent children).

    # Worst single expansion: sum of leaf-children windows of one node row.
    need = np.zeros(n + 1, np.int64)
    np.add.at(need, p_idx, np.where(is_inner[cids], 0, n_wins[cids]))

    return dict(
        node_rows=rows,
        win_data=win_data,
        root_min=np.asarray(node_min[root], np.float32),
        root_max=np.asarray(node_max[root], np.float32),
        branch=K,
        max_depth=int(max_depth),
        row_width=row_width,
        max_node_need=int(need.max(initial=0)),
    )


class TreeTables(NamedTuple):
    """Device tables of a K-ary spatial tree (octree K=8, KD-tree K=2 or,
    with ``levels``, K=2^levels)."""

    child_box: torch.Tensor  # (n+2, K, 8) f32 min.xyz, 0, max.xyz, 0
    child_info: torch.Tensor  # (n+2, K, 4) i32 id | win_start | n_wins | 0
    win_geom: torch.Tensor  # (R, win, 12) f32 v0|e1|e2|0,0,0; last row null
    win_ids: torch.Tensor  # (R, win, 4) i32 tri|poly|top|0; null: -1|-2|-1
    root_min: torch.Tensor  # (3,) f32
    root_max: torch.Tensor  # (3,) f32
    branch: int  # K
    max_depth: int
    stack: int  # per-ray stack bound S = (K-1)*(max_depth+2)+4

    @property
    def n_nodes(self) -> int:
        """Rows without the null row, as the JAX ``TreeTables.n_nodes``."""
        return self.child_box.shape[0] - 1

    @property
    def pseudo_root(self) -> int:
        return self.n_nodes - 1

    @classmethod
    def from_numpy(
        cls, node_rows, win_data, root_min, root_max, branch, max_depth,
        device="cuda", **_,
    ) -> "TreeTables":
        """From the JAX ``TreeTables`` fields (as NumPy): repack the
        component-major child rows and window rows.  The remaining keyword
        fields (``row_width``, ``max_node_need``) size the JAX layout and
        its candidate buffers, which the port does not have."""
        K = int(branch)
        rows = np.ascontiguousarray(node_rows, np.float32)
        comp = rows[:, : N_COMP * K].reshape(len(rows), N_COMP, K).transpose(0, 2, 1)
        box = np.zeros((len(rows), K, 8), np.float32)
        box[..., 0:3] = comp[..., 0:3]
        box[..., 4:7] = comp[..., 3:6]
        info = np.zeros((len(rows), K, 4), np.int32)
        info[..., 0:3] = np.ascontiguousarray(comp[..., 6:9]).view(np.int32)
        geom, ids = repack_windows(win_data)

        def dev(a):
            return torch.from_numpy(np.array(a)).to(device)  # a writable copy

        return cls(
            child_box=dev(box),
            child_info=dev(info),
            win_geom=dev(geom),
            win_ids=dev(ids),
            root_min=dev(np.asarray(root_min, np.float32)),
            root_max=dev(np.asarray(root_max, np.float32)),
            branch=K,
            max_depth=int(max_depth),
            stack=(K - 1) * (int(max_depth) + 2) + 4,
        )


def _stack_overflow(tree: TreeTables) -> RuntimeError:
    return RuntimeError(
        f"tree_shoot: a ray's stack outgrew its bound S={tree.stack} "
        f"(K={tree.branch}, max_depth={tree.max_depth}); the tables are "
        "deeper than max_depth says"
    )


def tree_shoot(
    rays: Ray,
    tree: TreeTables,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """B2: nearest accepted hit ``(best_t (N,) f32 — inf on miss, best_tri
    (N,) i32 — -1 on miss)``, plus each ray's node pops (N,) i32 with
    ``with_stats``.

    CUDA tensors launch ``kernels/csrc/tree_shoot.cu`` (K in
    ``KERNEL_BRANCHES``, S <= ``KERNEL_MAX_STACK``; other trees raise);
    CPU tensors take :func:`tree_shoot_plain`.  Raises if a ray's stack
    outgrows ``tree.stack``.  Reading the kernel's overflow flag waits for
    the launch.
    """
    check_kernel(kernel)
    check_rays(rays)
    rays = detach_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    kind = check_device(o, d, ex, tree.child_box, tree.win_geom)
    if kind == "cpu":
        return tree_shoot_plain(rays, tree, kernel, min_t, top_index, with_stats)
    if tree.branch not in KERNEL_BRANCHES:
        raise ValueError(f"tree_shoot: the kernel takes K in {KERNEL_BRANCHES}, not {tree.branch}")
    if tree.stack > KERNEL_MAX_STACK:
        raise ValueError(f"tree_shoot: stack bound {tree.stack} > {KERNEL_MAX_STACK}")
    n, dev = o.shape[0], o.device
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    best_tri = torch.empty(n, dtype=torch.int32, device=dev)
    pops = torch.empty(n, dtype=torch.int32, device=dev) if with_stats else None
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    args = tree_shoot_args(rays, tree, best_t, best_tri, pops, err, kernel, min_t, top_index)
    build.launch("hare_tree_shoot", *args, ray_counter(dev))
    with sync("tree_flag"):
        overflow = int(err.item())
    if overflow:
        raise _stack_overflow(tree)
    return (best_t, best_tri, pops) if with_stats else (best_t, best_tri)


def tree_shoot_args(
    rays: Ray,
    tree: TreeTables,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    pops: Optional[torch.Tensor],
    err: torch.Tensor,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> tuple:
    """The arguments of the C entry point ``hare_tree_shoot`` up to the
    outputs and the error flag (tensors as tensors, for
    :func:`~..kernels.build.launch`; ``pops`` may be None); the ray counter
    (:func:`~.common.ray_counter`) and the stream follow."""
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    iparams = (ctypes.c_int * 6)(
        tree.branch, tree.win_geom.shape[1], tree.pseudo_root, tree.stack,
        -1 if top_index is None else int(top_index), int(kernel == "mt"),
    )
    return (o.contiguous(), d.contiguous(), ex.contiguous(), o.shape[0],
            tree.child_box, tree.child_info, tree.win_geom, tree.win_ids,
            float(min_t), iparams, best_t, best_tri, pops, err)


def tree_shoot_plain(
    rays: Ray,
    tree: TreeTables,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """Plain version of B2: the kernel's walk, lockstep over the active rays.

    Each step pops one ``(node, tmin)`` per active ray from an (N, S) stack,
    drops it if ``tmin > best_t``, slab-tests the node's K children, tests
    each hit leaf child's window run in child order (best hit folded in with
    ``scatter_reduce(amin)`` after each), and pushes the hit inner children
    with ``tmin <= best_t`` far-to-near (ties: the higher child slot first,
    so the lower slot pops first) — the same per-ray sequence as the kernel.
    The node rows it reads (one a pop that survives the prune) go to an open
    :func:`~.common.tally_rows` block as table ``"child"``.
    """
    check_kernel(kernel)
    check_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    dev, n, K, S = o.device, o.shape[0], tree.branch, tree.stack
    inf = float("inf")
    inv_d = 1.0 / torch.where(d == 0, 1e-30, d)  # tree.py:283
    st_node = torch.zeros((n, S), dtype=torch.int64, device=dev)
    st_t = torch.zeros((n, S), dtype=torch.float32, device=dev)
    st_node[:, 0] = tree.pseudo_root
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best_key = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    pops = torch.zeros(n, dtype=torch.int32, device=dev)
    slot = torch.arange(K, device=dev)
    idx = torch.arange(n, device=dev)

    def best_t(rows):
        return key_to_hit(best_key[rows])[0]

    while idx.numel():
        # ---- pop, and prune what starts beyond the best hit.
        top = sp[idx] - 1
        sp[idx] = top
        pops[idx] += 1
        node, t_node = st_node[idx, top], st_t[idx, top]
        live = t_node <= best_t(idx)
        r, node = idx[live], node[live]
        note_rows("child", node)

        # ---- slab test of the K children (NaN-propagating min/max).
        box = tree.child_box[node]  # (m, K, 8)
        info = tree.child_info[node]  # (m, K, 4)
        oo, ii = o[r][:, None, :], inv_d[r][:, None, :]
        t1 = (box[..., 0:3] - oo) * ii
        t2 = (box[..., 4:7] - oo) * ii
        t_lo = torch.full(box.shape[:2], -inf, device=dev)
        t_hi = torch.full(box.shape[:2], inf, device=dev)
        for c in range(3):
            t_lo = torch.maximum(t_lo, torch.minimum(t1[..., c], t2[..., c]))
            t_hi = torch.minimum(t_hi, torch.maximum(t1[..., c], t2[..., c]))
        tmin = torch.clamp(t_lo, min=0.0)
        slab = (t_hi >= tmin) & (t_hi >= 0.0)
        cid, ws, nw = info[..., 0], info[..., 1], info[..., 2]

        # ---- leaf children in slot order, best hit updated after each.
        for k in range(K):
            q = torch.nonzero(slab[:, k] & (nw[:, k] > 0) & (tmin[:, k] <= best_t(r))).squeeze(1)
            if q.numel():
                rq = r[q]
                keys = test_runs(
                    tree.win_geom, tree.win_ids, ws[q, k], nw[q, k],
                    o[rq], d[rq], ex[rq], min_t, top_index, kernel,
                )
                best_key.scatter_reduce_(0, rq, keys, reduce="amin")

        # ---- push the inner children far-to-near.
        push = slab & (cid >= 0) & (tmin <= best_t(r)[:, None])
        tj, tk = tmin[:, None, :], tmin[:, :, None]
        before = push[:, None, :] & ((tj > tk) | ((tj == tk) & (slot[None, None, :] > slot[None, :, None])))
        pos = before.sum(-1)  # (m, K): pushes that go below child k
        base = sp[r]
        n_push = push.sum(-1)
        if bool((base + n_push > S).any()):
            raise _stack_overflow(tree)
        m_i, k_i = torch.nonzero(push, as_tuple=True)
        at = base[m_i] + pos[m_i, k_i]
        st_node[r[m_i], at] = cid[m_i, k_i].to(torch.int64)
        st_t[r[m_i], at] = tmin[m_i, k_i]
        sp[r] = base + n_push
        idx = idx[sp[idx] > 0]
    best_t_all, best_tri = key_to_hit(best_key)
    return (best_t_all, best_tri, pops) if with_stats else (best_t_all, best_tri)


def shoot_tree(
    scene: Scene,
    rays: Ray,
    tree: TreeTables,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """Nearest-hit query via the tree: B2 then K2 (``finalize_hits``).
    ``with_stats=True`` returns ``(HitRecord, pops)``: each ray's node pops,
    the port's own count (not the JAX lockstep iterations)."""
    with traversal_span("tree", rays):
        out = tree_shoot(rays, tree, kernel, min_t, top_index, with_stats)
    hits = finalize_hits(scene, rays, out[0], out[1], kernel)
    return (hits, out[2]) if with_stats else hits
