"""Stackless rope-based KD-tree traversal (Popov, Günther, Slusallek &
Seidel 2007, "Stackless KD-Tree Traversal for High Performance GPU Ray
Tracing").

Counterpart of ``hare_tpu/accel/ropes.py``.  The build — the KD split
(``kdtree.kd_split``), per-leaf rope assignment with push-down to the
deepest node fully containing the shared face, the 32-lane node rows, the
terminal row and ``char_step`` — is a NumPy copy of the JAX host code and
makes bit-equal tables.  :meth:`KDRopes.from_numpy` repacks the rows into
typed arrays one GPU thread reads:

  - ``node`` (n+1, 4) i32: split axis, is_leaf, child_lo, child_hi;
  - ``split`` (n+1,) f32: split value (inner nodes);
  - ``box`` (n+1, 8) f32: min.xyz, 0, max.xyz, 0 (leaves) — two float4;
  - ``leaf_win`` (n+1, 2) i32: window start, window count (leaves);
  - ``ropes`` (n+1, 8) i32: ropes -x, +x, -y, +y, -z, +z (-1 = off the
    tree) and two -1 lanes — two int4;
  - the window rows tri-major (``common.repack_windows``).

Row n is the JAX terminal row (a leaf with no windows, an unbounded box and
all ropes -1); the port's walks stop a ray instead of parking it there.

Traversal: :func:`ropes_shoot` is B3 (``kernels/csrc/ropes_shoot.cu``, one
group of lanes per ray carrying ``(node, t, position)``) for CUDA tensors and
:func:`ropes_shoot_plain` — the same walk, lockstep over the active rays —
for CPU tensors.  At an inner node a ray descends one level by comparing
its position with the split, ties to the direction's sign; at a leaf it
tests the window run, takes the exit face by the three-slab min (x, then
y, then z on ties), snaps the exit coordinate onto the face plane and
follows the rope; it stops off the tree or once the next leaf's entry t
exceeds its best hit.  The JAX walk's candidate buffers, packed runs, tiers
and straggler rounds are not ported.

A rope walk has no closed-form step bound; the tree gives one: each leaf
is entered at most once per ray, and each entry descends at most
``max_depth`` levels, so ``max_steps = n_leaves * (max_depth + 1)``.  A ray
that reaches it raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..geom.intersect import MIN_T, ray_aabb
from ..geom.primitives import Ray
from ..kernels import build
from ..mesh.scene import Scene
from ..mesh.topology import Topology
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
)
from .kdtree import SPLITS, kd_split
from .octree import _extract, auto_depth

__all__ = [
    "KDRopes",
    "build_kdtree_ropes",
    "build_kdtree_ropes_tables",
    "ropes_shoot",
    "ropes_shoot_args",
    "ropes_shoot_plain",
    "shoot_kdtree_ropes",
]

# Row lanes of the JAX layout (32-wide):
#  0: (axis << 1) | is_leaf          (i32 bitcast)
#  1: split value                    (internal, f32)
#  2: child_lo   3: child_hi         (internal, i32 bitcast)
#  4-6: box min  7-9: box max        (leaf, f32)
# 10: win_start 11: n_wins           (leaf, i32 bitcast)
# 12-17: ropes[-x,+x,-y,+y,-z,+z]    (leaf, i32 bitcast; -1 = off tree)
ROW_W = 32
# Entry nudge past the root box, in units of char_step (ropes.py:329).
ENTRY_EPS = 1e-4


def build_kdtree_ropes_tables(
    source: Union[Topology, Sequence[Topology]],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    win: Optional[int] = None,
    split: str = "sah",
) -> dict:
    """The rope tree's host tables, bit-equal to the JAX
    ``build_kdtree_ropes`` fields (``node_rows``, ``win_data``,
    ``root_min``, ``root_max``, as NumPy; ``max_depth``, ``char_step``,
    ``max_leaf_wins``, ``n_tris`` as Python values).

    The JAX builder's checks on 256 window rows per leaf and 2^23 nodes or
    rows guard its packed (start, width) runs; the port's walks test a
    leaf's run in place and need neither, so no leaf size is refused."""
    if split not in SPLITS:
        raise ValueError(f"unknown split policy {split!r}")
    tri, tri_poly, tri_top = _extract(source)
    if max_depth is None:
        max_depth = auto_depth(len(tri), max_tris_per_node, 2, 2, 2, 22)
    lo = tri.min(axis=1)
    hi = tri.max(axis=1)
    centroid = tri.mean(axis=1)
    root_min = lo.min(axis=0) - pad
    root_max = hi.max(axis=0) + pad

    node_min, node_max = [root_min.copy()], [root_max.copy()]
    child_lo, child_hi = [-1], [-1]
    split_ax, split_val = [0], [0.0]
    leaf_lists: list = [np.zeros(0, np.int64)]

    stack = [(0, np.arange(len(tri)), 0)]
    while stack:
        nid, ids, depth = stack.pop()
        if depth >= max_depth or len(ids) <= max_tris_per_node:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        plane = kd_split(split, ids, depth, lo, hi, centroid, node_min[nid], node_max[nid])
        if plane is None:
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        ax, sv = plane
        go_left = lo[ids, ax] <= sv
        go_right = hi[ids, ax] >= sv
        lids, rids = ids[go_left], ids[go_right]
        if len(lids) == len(ids) and len(rids) == len(ids):
            leaf_lists[nid] = ids.astype(np.int64)
            continue
        split_ax[nid], split_val[nid] = ax, sv
        for side, cids in ((0, lids), (1, rids)):
            cmin = node_min[nid].copy()
            cmax = node_max[nid].copy()
            (cmax if side == 0 else cmin)[ax] = sv
            cid = len(node_min)
            node_min.append(cmin)
            node_max.append(cmax)
            child_lo.append(-1)
            child_hi.append(-1)
            split_ax.append(0)
            split_val.append(0.0)
            leaf_lists.append(np.zeros(0, np.int64))
            if side == 0:
                child_lo[nid] = cid
            else:
                child_hi[nid] = cid
            stack.append((cid, cids, depth + 1))

    n = len(node_min)
    c_lo = np.asarray(child_lo, np.int64)
    c_hi = np.asarray(child_hi, np.int64)
    s_ax = np.asarray(split_ax, np.int64)
    s_val = np.asarray(split_val, np.float32)
    is_leaf = c_lo < 0
    nmin = np.stack(node_min).astype(np.float32)
    nmax = np.stack(node_max).astype(np.float32)

    # ---- rope assignment: DFS handing each child its parent-side ropes,
    # with the split-plane sibling installed on the face it creates; at
    # leaves, each rope is pushed down to the deepest node fully
    # containing the shared face rectangle.
    def push_down(r: int, face_ax: int, face_side: int, fb_min, fb_max) -> int:
        while r >= 0 and not is_leaf[r]:
            ax, sv = int(s_ax[r]), float(s_val[r])
            if ax == face_ax:
                # Exiting through the leaf's HIGH face enters the target's
                # LOW side -> the lo child is face-adjacent (and vice versa).
                r = int(c_lo[r]) if face_side == 1 else int(c_hi[r])
            elif fb_max[ax] <= sv:
                r = int(c_lo[r])
            elif fb_min[ax] >= sv:
                r = int(c_hi[r])
            else:
                break
        return r

    ropes = np.full((n, 6), -1, np.int64)
    dfs = [(0, (-1, -1, -1, -1, -1, -1))]
    while dfs:
        nid, rp = dfs.pop()
        if is_leaf[nid]:
            for f in range(6):
                ropes[nid, f] = push_down(rp[f], f // 2, f & 1, nmin[nid], nmax[nid])
            continue
        ax = int(s_ax[nid])
        lo_rp = list(rp)
        hi_rp = list(rp)
        lo_rp[2 * ax + 1] = int(c_hi[nid])  # lo child's +ax neighbor
        hi_rp[2 * ax] = int(c_lo[nid])  # hi child's -ax neighbor
        dfs.append((int(c_lo[nid]), tuple(lo_rp)))
        dfs.append((int(c_hi[nid]), tuple(hi_rp)))

    # ---- pack leaf windows (groups = nodes; internal nodes count 0).
    counts = np.fromiter((len(l) for l in leaf_lists), np.int64, n)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    items = (
        np.concatenate([np.asarray(l, np.int64) for l in leaf_lists])
        if counts.sum()
        else np.zeros(0, np.int64)
    )
    win_data, win_start, n_wins = pack_windows(
        tri, tri_poly, tri_top, starts, counts, items,
        **({} if win is None else {"win": win}),
    )

    def i32f(a):
        return np.asarray(a, np.int32).view(np.float32)

    rows = np.zeros((n + 1, ROW_W), np.float32)
    rows[:n, 0] = i32f((s_ax << 1) | is_leaf)
    rows[:n, 1] = s_val
    rows[:n, 2] = i32f(np.maximum(c_lo, -1))
    rows[:n, 3] = i32f(np.maximum(c_hi, -1))
    rows[:n, 4:7] = nmin
    rows[:n, 7:10] = nmax
    rows[:n, 10] = i32f(win_start)
    rows[:n, 11] = i32f(n_wins)
    rows[:n, 12:18] = i32f(ropes).reshape(n, 6)
    # Terminal row: a leaf with no windows, an unbounded box and all ropes -1.
    rows[n, 0] = i32f(np.array(1))
    rows[n, 4:7] = -np.inf
    rows[n, 7:10] = np.inf
    rows[n, 10] = i32f(np.array(0))
    rows[n, 11] = i32f(np.array(0))
    rows[n, 12:18] = i32f(np.full(6, -1))

    ext = (root_max - root_min).min()
    return dict(
        node_rows=rows,
        win_data=win_data,
        root_min=np.asarray(root_min, np.float32),
        root_max=np.asarray(root_max, np.float32),
        max_depth=int(max_depth),
        char_step=float(ext) / (2 ** min(max_depth, 16)),
        max_leaf_wins=int(n_wins.max(initial=0)),
        n_tris=len(tri),
    )


class KDRopes(NamedTuple):
    """Device KD-tree with per-leaf ropes; the root is node 0."""

    node: torch.Tensor  # (n+1, 4) i32 axis | is_leaf | child_lo | child_hi
    split: torch.Tensor  # (n+1,) f32
    box: torch.Tensor  # (n+1, 8) f32 min.xyz, 0, max.xyz, 0
    leaf_win: torch.Tensor  # (n+1, 2) i32 win_start | n_wins
    ropes: torch.Tensor  # (n+1, 8) i32 -x|+x|-y|+y|-z|+z|-1|-1
    win_geom: torch.Tensor  # (R, win, 12) f32
    win_ids: torch.Tensor  # (R, win, 4) i32
    root_min: torch.Tensor  # (3,) f32
    root_max: torch.Tensor  # (3,) f32
    max_depth: int
    char_step: float
    max_steps: int  # per-ray step bound n_leaves * (max_depth + 1)
    # root_min and root_max (3 each) as Python floats of their f32 values,
    # so B3 and its plain version enter the tree on identical constants.
    host_params: Tuple[float, ...]

    @property
    def n_nodes(self) -> int:
        """Rows without the terminal row, as the JAX ``KDRopes.n_nodes``."""
        return self.node.shape[0] - 1

    @classmethod
    def from_numpy(
        cls, node_rows, win_data, root_min, root_max, max_depth, char_step,
        device="cuda", **_,
    ) -> "KDRopes":
        """From the JAX ``KDRopes`` fields (as NumPy): split the 32-lane
        rows into typed arrays and repack the window rows.  The remaining
        keyword fields (``max_leaf_wins``, ``n_tris``) size the JAX walk's
        buffers, which the port does not have."""
        rows = np.ascontiguousarray(node_rows, np.float32)
        irows = rows.view(np.int32)
        node = np.stack(
            [irows[:, 0] >> 1, irows[:, 0] & 1, irows[:, 2], irows[:, 3]], axis=1
        ).astype(np.int32)
        box = np.zeros((len(rows), 8), np.float32)
        box[:, 0:3] = rows[:, 4:7]
        box[:, 4:7] = rows[:, 7:10]
        ropes = np.full((len(rows), 8), -1, np.int32)
        ropes[:, 0:6] = irows[:, 12:18]
        geom, ids = repack_windows(win_data)
        n_leaves = int(node[:-1, 1].sum())
        rmin = np.asarray(root_min, np.float32)
        rmax = np.asarray(root_max, np.float32)

        def dev(a):
            return torch.from_numpy(np.array(a)).to(device)  # a writable copy

        return cls(
            node=dev(node),
            split=dev(rows[:, 1]),
            box=dev(box),
            leaf_win=dev(irows[:, 10:12]),
            ropes=dev(ropes),
            win_geom=dev(geom),
            win_ids=dev(ids),
            root_min=dev(rmin),
            root_max=dev(rmax),
            max_depth=int(max_depth),
            char_step=float(char_step),
            max_steps=max(1, n_leaves) * (int(max_depth) + 1),
            host_params=tuple(float(x) for x in np.concatenate([rmin, rmax])),
        )


def build_kdtree_ropes(
    source: Union[Topology, Sequence[Topology]],
    max_depth: Optional[int] = None,
    max_tris_per_node: int = 12,
    pad: float = 1e-3,
    win: Optional[int] = None,
    split: str = "sah",
    device="cuda",
) -> KDRopes:
    """Build the rope tree on the host (:func:`build_kdtree_ropes_tables`)
    and put it on ``device``."""
    tables = build_kdtree_ropes_tables(source, max_depth, max_tris_per_node, pad, win, split)
    return KDRopes.from_numpy(**tables, device=device)


def _step_overflow(tree: KDRopes) -> RuntimeError:
    return RuntimeError(
        f"ropes_shoot: a ray took more than {tree.max_steps} steps, the "
        "bound of n_leaves * (max_depth + 1); the rope walk did not end"
    )


def ropes_shoot(
    rays: Ray,
    tree: KDRopes,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """B3: nearest accepted hit ``(best_t (N,) f32 — inf on miss, best_tri
    (N,) i32 — -1 on miss)``, plus each ray's node steps (N,) i32 with
    ``with_stats``.

    CUDA tensors launch ``kernels/csrc/ropes_shoot.cu``; CPU tensors take
    :func:`ropes_shoot_plain`.  Raises if a ray reaches ``tree.max_steps``.
    Reading the kernel's bound flag waits for the launch.
    """
    check_kernel(kernel)
    check_rays(rays)
    rays = detach_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    kind = check_device(o, d, ex, tree.node, tree.win_geom)
    if kind == "cpu":
        return ropes_shoot_plain(rays, tree, kernel, min_t, top_index, with_stats)
    n, dev = o.shape[0], o.device
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    best_tri = torch.empty(n, dtype=torch.int32, device=dev)
    steps = torch.empty(n, dtype=torch.int32, device=dev) if with_stats else None
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    args = ropes_shoot_args(rays, tree, best_t, best_tri, steps, err, kernel, min_t, top_index)
    ropes_shoot.launches += 1
    build.launch("hare_ropes_shoot", *args, ray_counter(dev))
    if int(err.item()):
        raise _step_overflow(tree)
    return (best_t, best_tri, steps) if with_stats else (best_t, best_tri)


ropes_shoot.launches = 0


def ropes_shoot_args(
    rays: Ray,
    tree: KDRopes,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    steps: Optional[torch.Tensor],
    err: torch.Tensor,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> tuple:
    """The arguments of the C entry point ``hare_ropes_shoot`` up to the
    outputs and the error flag (tensors as tensors, for
    :func:`~..kernels.build.launch`; ``steps`` may be None); the ray counter
    (:func:`~.common.ray_counter`) and the stream follow."""
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    fparams = (ctypes.c_float * 8)(*tree.host_params, ENTRY_EPS * tree.char_step, min_t)
    iparams = (ctypes.c_int * 4)(
        tree.win_geom.shape[1], tree.max_steps,
        -1 if top_index is None else int(top_index), int(kernel == "mt"),
    )
    return (o.contiguous(), d.contiguous(), ex.contiguous(), o.shape[0],
            tree.node, tree.split, tree.box, tree.leaf_win, tree.ropes,
            tree.win_geom, tree.win_ids, fparams, iparams, best_t, best_tri, steps, err)


def ropes_shoot_plain(
    rays: Ray,
    tree: KDRopes,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """Plain version of B3: the kernel's rope walk, lockstep over the active
    rays — one masked step per iteration (inner: descend one level; leaf:
    window run, exit face, snap, rope), with the kernel's float conventions:
    ``where(d == 0, 1, d)`` for the reciprocal and ``t = inf`` for a zero
    component (``ropes.py:325-326,396-398``), positions as ``o + t * d``
    rounded after the product and after the sum.  The rows it reads as the
    kernel does (every step a ``"node"`` row, an inner step its ``"split"``,
    a leaf step its ``"leaf_win"``, ``"box"`` and ``"ropes"`` rows) go to an
    open :func:`~.common.tally_rows` block."""
    check_kernel(kernel)
    check_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    dev, n = o.device, o.shape[0]
    inf = float("inf")
    hp = torch.tensor(tree.host_params, dtype=torch.float32, device=dev)
    rmin, rmax = hp[0:3], hp[3:6]

    # ---- entry (ropes.py:312-331).
    inside = ((o >= rmin) & (o <= rmax)).all(dim=-1)
    bhit, t_near, _ = ray_aabb(o, d, rmin, rmax)
    entry = torch.clamp(t_near, min=0.0) + ENTRY_EPS * tree.char_step
    t0 = torch.where(inside, 0.0, torch.where(bhit, entry, inf))
    best_key = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)

    idx = torch.nonzero(torch.isfinite(t0)).squeeze(1)
    o, d, ex = o[idx], d[idx], ex[idx]
    inv_sd = 1.0 / torch.where(d == 0, 1.0, d)
    pos = o + t0[idx][:, None] * d
    node = torch.zeros(idx.numel(), dtype=torch.int64, device=dev)

    for _ in range(tree.max_steps):
        if idx.numel() == 0:
            break
        steps[idx] += 1
        nd = tree.node[node]
        leaf = nd[:, 1] == 1
        note_rows("node", node)
        note_rows("split", node[~leaf])
        for table in ("leaf_win", "box", "ropes"):
            note_rows(table, node[leaf])

        # ---- inner nodes: one-level descent, ties to the direction's sign.
        ax = nd[:, 0:1].long()
        pa, da = pos.gather(1, ax)[:, 0], d.gather(1, ax)[:, 0]
        sv = tree.split[node]
        go_lo = (pa < sv) | ((pa == sv) & (da < 0))
        child = torch.where(go_lo, nd[:, 2], nd[:, 3])

        # ---- leaves: the window run, then the exit face and its rope.
        lw = tree.leaf_win[node]
        q = torch.nonzero(leaf & (lw[:, 1] > 0)).squeeze(1)
        if q.numel():
            keys = test_runs(
                tree.win_geom, tree.win_ids, lw[q, 0], lw[q, 1], o[q], d[q], ex[q],
                min_t, top_index, kernel,
            )
            best_key.scatter_reduce_(0, idx[q], keys, reduce="amin")
        box = tree.box[node]
        far = torch.where(d > 0, box[:, 4:7], box[:, 0:3])
        t_ax = torch.where(d == 0, inf, (far - o) * inv_sd)
        t_exit = torch.minimum(torch.minimum(t_ax[:, 0], t_ax[:, 1]), t_ax[:, 2])
        ex0 = t_ax[:, 0] <= t_exit
        ex1 = ~ex0 & (t_ax[:, 1] <= t_exit)
        ex2 = ~ex0 & ~ex1
        pos_d = (d > 0).long()
        face = torch.where(ex0, pos_d[:, 0], torch.where(ex1, 2 + pos_d[:, 1], 4 + pos_d[:, 2]))
        rope = tree.ropes[node].gather(1, face[:, None])[:, 0]
        snap = torch.stack([ex0, ex1, ex2], dim=1)
        new_pos = torch.where(snap, far, o + t_exit[:, None] * d)

        best_t, _ = key_to_hit(best_key[idx])
        keep = ~leaf | ((rope >= 0) & (t_exit <= best_t))
        node = torch.where(leaf, rope, child).long()
        pos = torch.where(leaf[:, None], new_pos, pos)
        k = torch.nonzero(keep).squeeze(1)
        idx, o, d, ex, inv_sd, pos, node = (a[k] for a in (idx, o, d, ex, inv_sd, pos, node))
    else:
        if idx.numel():
            raise _step_overflow(tree)
    best_t, best_tri = key_to_hit(best_key)
    return (best_t, best_tri, steps) if with_stats else (best_t, best_tri)


def shoot_kdtree_ropes(
    scene: Scene,
    rays: Ray,
    tree: KDRopes,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    with_stats: bool = False,
):
    """Nearest-hit query via the rope walk: B3 then K2 (``finalize_hits``).
    ``with_stats=True`` returns ``(HitRecord, steps)``: each ray's node
    steps, the port's own count (not the JAX lockstep iterations)."""
    out = ropes_shoot(rays, tree, kernel, min_t, top_index, with_stats)
    hits = finalize_hits(scene, rays, out[0], out[1], kernel)
    return (hits, out[2]) if with_stats else hits
