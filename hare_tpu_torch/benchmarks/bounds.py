"""The least time an H100 could take for each kernel's work: its bound.

A bound is the larger of two times: the operations the work needs over the
card's peak FP32 rate, and the bytes it must move (each input read once,
each output written once) over the card's memory rate.  Where the work
depends on the data, it is counted on the run's own inputs: K1's from
:func:`~..accel.voxel.grid_work`, B2's and B3's from the runs their plain
versions hand :func:`~..accel.common.test_runs` and the node rows they read
(:func:`~..accel.common.tally_rows`).  ``chip_smoke.py`` puts
each kernel's time beside its bound; the CPU tests check the counts.

Operations are counted by hand from ``kernels/csrc``, at the fewest a test
needs (where the code forms a value in more steps, the count takes the
shorter way): FP32 adds, subtracts, multiplies and reciprocals, one each (a
contracted FMA counts as the two it replaces); compares, selects, min/max,
absolute values and sign flips are not counted.  Bytes are those the
function needs: of a window slot, its 9 geometry floats and 3 ids, not the
padding of its 16-byte loads.  A tree's node rows count the same way, the
fields the walk reads (B2: ``TREE_CHILD_BYTES`` a child; B3:
``ROPE_ROW_BYTES`` a table row), each distinct row once.  So the bound is a
floor, not a count of issued instructions or of bytes loaded.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

__all__ = [
    "EXIT_OPS",
    "PEAK_BYTES",
    "PEAK_FP32",
    "ROPE_ROW_BYTES",
    "SLAB_OPS",
    "TREE_CHILD_BYTES",
    "TRI_TEST_OPS",
    "bound",
    "brute_shoot_bound",
    "column_sum_bound",
    "finalize_hits_bound",
    "finalize_hits_bwd_bound",
    "gather_sum_bound",
    "grid_shoot_bound",
    "histogram_bound",
    "rows_work",
    "runs_work",
    "scatter_bound",
    "soft_histogram_bwd_bound",
    "walk_bound",
]

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet): FP32
# outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12  # operations / s
PEAK_BYTES = 3.35e12  # bytes / s

# One masked triangle test of csrc/intersect.cuh, as the traversals call it
# (t only; u and v are not used and not counted):
#   watertight: the corners relative to the origin, a = v0 - o (3), b = a + e1
#     and c = a + e2 (3 each), each sheared (2 x 2 = 4 each, 12); u, v, w
#     (3 x 3 = 9); det (2); the band (2 adds, 1 mul = 3); 1 / det (1);
#     t = sz (u az + v bz + w cz) / det (7) -> 43 (intersect.cuh:60-90).
#   Möller-Trumbore: p = d x e2 (9), det (5), s = o - v0 (3), q (9),
#     u, v, t (3 x 5), u + v (1), 1 / det (1), t / det (1) -> 44
#     (intersect.cuh:93-116; its sign scaling of the bounds is a compare).
TRI_TEST_OPS = {"watertight": 43, "mt": 44}
# K2 per ray: one unmasked test with u and v (+2), the normal e1 x e2 (9)
# and the point o + t d (6).
FINALIZE_EXTRA_OPS = 2 + 9 + 6
# One ray-box slab test (tree_shoot.cu, a pop tests K child boxes): per axis
# (lo - o) / d and (hi - o) / d as a subtract and a multiply each.
SLAB_OPS = 12
# One rope step's exit face (ropes_shoot.cu): per axis (far - o) / d.
EXIT_OPS = 6
# K3 per hit lane, hard: time / bin_dt (1), the add into the bin (1); soft:
# pos = time / bin_dt - 0.5 (2), x = pos - i0 (1), e_hi = e frac (1),
# e_lo = e - e_hi (1), the adds into two bins (2).
HISTOGRAM_OPS = {False: 2, True: 7}
# The soft backward per hit lane: pos (2), x (1), G[hi] - G[lo] (1), times
# frac (1), plus G[lo] (1), times e (1), over bin_dt (1).
SOFT_BWD_OPS = 8
# A3 per ray (finalize_bwd.cu), at the fewest: e1, e2 (6) and the normal's
# two crosses (18) on every ray; on a hit ray also t's cotangent with the
# point's (6), t d's (3), s (3), six crosses P, Q, e1 x e2, e1 x d, e2 x s,
# d x s (54), det (5), 1 / det (1), t, u, v (18), their and det's scaled
# cotangents (3 + 6), the three-term sums of s, d, e1, e2 (15 + 3 x 18),
# d(origin) (3) and the first corner (6).
FINALIZE_BWD_OPS = {False: 6 + 18, True: 201}
# A3 per ray: best_tri, the forward t, hit, origin, direction and the
# cotangents of t, u, v, point, normal in; d(origin), d(direction), three
# vertex ids and three corner cotangents out.
FINALIZE_BWD_RAY_BYTES = (4 + 4 + 1 + 24 + 12 + 24) + (24 + 12 + 36)
VERTEX_BYTES = 12  # one (3,) f32 vertex
TRI_V_BYTES = 12  # tri_meta lanes 4-6: a triangle's vertex ids

RAY_BYTES = 12 + 12 + 8  # origin, direction (f32), exclusions (2 x i32)
NEAREST_BYTES = 4 + 4  # best_t (f32), best_tri (i32)
SLOT_BYTES = 36 + 12  # one window slot: v0 | e1 | e2 (9 f32), tri | poly | top (3 i32)
CELL_META_BYTES = 8  # one cell_meta entry (2 x i32)
# One child of a B2 node row: its box (min.xyz, max.xyz: 6 f32 of 2 float4)
# and its info (id, window start, window count: 3 i32 of 1 int4); a row is K
# of them.
TREE_CHILD_BYTES = 24 + 12
# B3's node tables, bytes a row: node (axis, is_leaf, lo, hi), split, box
# (min.xyz, max.xyz of 2 float4), leaf window (start, count), ropes (six
# faces of 2 int4).
ROPE_ROW_BYTES = {"node": 16, "split": 4, "box": 24, "leaf_win": 8, "ropes": 24}
TRI_GEOM_BYTES = 36  # scene.tri_geom row (9 f32)
TRI_META_BYTES = 32  # scene.tri_meta row (8 i32)
# K2's hit record per ray: hit (bool), t, u, v, point (3), poly, tri,
# normal (3), edge_nbr (3).
HIT_RECORD_BYTES = 1 + 4 * 3 + 12 + 4 * 2 + 12 + 12


def bound(ops: float, nbytes: float) -> Dict[str, object]:
    """``{"ops", "bytes", "bound_ms", "bound_by"}``: the larger of
    ``ops / PEAK_FP32`` and ``nbytes / PEAK_BYTES``, and which it was
    (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return dict(ops=float(ops), bytes=float(nbytes), bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def grid_shoot_bound(work, kernel: str = "watertight") -> Dict[str, object]:
    """K1 on the rays :func:`~..accel.voxel.grid_work` counted ``work`` on:
    one triangle test per non-null slot tested; the rays, the cell_meta
    entries and non-null window slots touched (once each) and the outputs."""
    n = work.cells.shape[0]
    ops = int(work.slots.sum()) * TRI_TEST_OPS[kernel]
    nbytes = (n * (RAY_BYTES + NEAREST_BYTES) + work.cells_touched * CELL_META_BYTES
              + work.slots_touched * SLOT_BYTES)
    return bound(ops, nbytes)


def runs_work(runs: Iterable[Tuple[torch.Tensor, torch.Tensor]],
              win_ids: torch.Tensor) -> Tuple[int, int]:
    """``(non-null slots tested, distinct non-null slots)`` of the ``(start,
    count)`` runs a plain traversal handed :func:`~..accel.common.test_runs`
    (:func:`~..accel.common.tally_runs`), over the window table ``win_ids``
    (R, win, 4): the first counts a slot once per run that holds it."""
    live = (win_ids[..., 0] >= 0).sum(dim=1)
    live_before = torch.cat([live.new_zeros(1), torch.cumsum(live, 0)])
    edge = torch.zeros(win_ids.shape[0] + 1, dtype=torch.int64, device=win_ids.device)
    slots = 0
    for start, count in runs:
        start, count = start.to(win_ids.device), count.to(win_ids.device)
        slots += int((live_before[start + count] - live_before[start]).sum())
        edge.index_add_(0, start, torch.ones_like(start))
        edge.index_add_(0, start + count, -torch.ones_like(start))
    covered = torch.cumsum(edge, 0)[:-1] > 0
    return slots, int(live[covered].sum())


def rows_work(rows: Iterable[Tuple[str, torch.Tensor]],
              row_bytes: Dict[str, int]) -> Tuple[Dict[str, int], int]:
    """``({table: rows read}, bytes of the distinct rows)`` of the node rows
    a plain walk read (:func:`~..accel.common.tally_rows`): a row counts once
    per read in the first, once at ``row_bytes[table]`` in the second."""
    by_table: Dict[str, list] = {}
    for table, idx in rows:
        by_table.setdefault(table, []).append(idx)
    reads = {table: sum(int(i.numel()) for i in idx) for table, idx in by_table.items()}
    nbytes = sum(int(torch.unique(torch.cat(idx)).numel()) * row_bytes[table]
                 for table, idx in by_table.items())
    return reads, nbytes


def walk_bound(n_rays: int, runs, rows, win_ids: torch.Tensor, branch: Optional[int],
               kernel: str = "watertight") -> Dict[str, object]:
    """B2 (``branch`` = K) or B3 (``branch`` None) on the work a plain walk
    tallied (:func:`~..accel.common.tally_runs`, :func:`~..accel.common.
    tally_rows`): the ``slots`` triangle tests of ``slots_touched`` distinct
    non-null slots (:func:`runs_work`); ``node_visits`` node visits (B2: the
    rows read, ``K * SLAB_OPS`` operations each; B3: the leaf steps,
    ``EXIT_OPS`` each); the ``node_bytes`` of the distinct node rows read
    (:func:`rows_work`); rays in, nearest hits out.  Returns the bound with
    those four counts."""
    slots, touched = runs_work(runs, win_ids)
    if branch is None:
        reads, node_bytes = rows_work(rows, ROPE_ROW_BYTES)
        visits, visit_ops = reads.get("box", 0), EXIT_OPS
    else:
        reads, node_bytes = rows_work(rows, {"child": branch * TREE_CHILD_BYTES})
        visits, visit_ops = reads.get("child", 0), branch * SLAB_OPS
    ops = slots * TRI_TEST_OPS[kernel] + visits * visit_ops
    nbytes = n_rays * (RAY_BYTES + NEAREST_BYTES) + touched * SLOT_BYTES + node_bytes
    out = bound(ops, nbytes)
    out.update(slots=slots, slots_touched=touched, node_visits=visits, node_bytes=node_bytes)
    return out


def brute_shoot_bound(n_rays: int, n_tris: int, kernel: str = "watertight") -> Dict[str, object]:
    """B1: every ray against every triangle; the rays, each triangle's
    geometry and its polygon and topology ids (8 bytes of tri_meta)."""
    ops = n_rays * n_tris * TRI_TEST_OPS[kernel]
    nbytes = n_rays * (RAY_BYTES + NEAREST_BYTES) + n_tris * (TRI_GEOM_BYTES + 8)
    return bound(ops, nbytes)


def finalize_hits_bound(best_tri: torch.Tensor, kernel: str = "watertight") -> Dict[str, object]:
    """K2: per ray the winner, origin and direction in and the hit record
    out; each distinct winning triangle's tri_geom and tri_meta rows."""
    n = best_tri.shape[0]
    hit = best_tri[best_tri >= 0]
    rows = int(torch.unique(hit).numel())
    ops = int(hit.numel()) * (TRI_TEST_OPS[kernel] + FINALIZE_EXTRA_OPS)
    nbytes = n * (NEAREST_BYTES + 24 + HIT_RECORD_BYTES) + rows * (TRI_GEOM_BYTES + TRI_META_BYTES)
    return bound(ops, nbytes)


def histogram_bound(hit: torch.Tensor, n_bins: int, soft: bool = False) -> Dict[str, object]:
    """K3: energy, time (f32) and hit (bool) of every lane in, the bins out;
    ``HISTOGRAM_OPS[soft]`` operations a hit lane."""
    n = hit.numel()
    return bound(int(hit.sum()) * HISTOGRAM_OPS[soft], n * (4 + 4 + 1) + n_bins * 4)


def soft_histogram_bwd_bound(hit: torch.Tensor, n_bins: int) -> Dict[str, object]:
    """The soft backward: every lane's energy, time and hit and the bins'
    gradient in, d(energy) and d(time) out."""
    n = hit.numel()
    return bound(int(hit.sum()) * SOFT_BWD_OPS, n * (9 + 8) + n_bins * 4)


def finalize_hits_bwd_bound(best_tri: torch.Tensor, hit: torch.Tensor,
                            tri_meta: torch.Tensor) -> Dict[str, object]:
    """A3 on one shoot's winners: ``FINALIZE_BWD_RAY_BYTES`` a ray, the
    vertex ids of each distinct triangle read (misses read triangle 0) and
    each distinct vertex of them once; ``FINALIZE_BWD_OPS`` a hit or a miss
    ray."""
    n, hits = best_tri.shape[0], int(hit.sum())
    tris = torch.unique(torch.clamp(best_tri, min=0).long())
    verts = int(torch.unique(tri_meta[tris, 4:7]).numel())
    nbytes = n * FINALIZE_BWD_RAY_BYTES + tris.numel() * TRI_V_BYTES + verts * VERTEX_BYTES
    ops = hits * FINALIZE_BWD_OPS[True] + (n - hits) * FINALIZE_BWD_OPS[False]
    return bound(ops, nbytes)


def scatter_bound(keys: torch.Tensor, cols: int, n_keys: int) -> Dict[str, object]:
    """The scatter-add's function: each key (i32) and value (``cols`` f32)
    read once, the ``n_keys`` sums written once; one add a value."""
    m = keys.numel()
    return bound(m * cols, m * (4 + 4 * cols) + n_keys * 4 * cols)


def column_sum_bound(rows: int, cols: int) -> Dict[str, object]:
    """P1: the (rows, cols) f32 table read once, one add an element."""
    return bound(rows * cols, (rows + 1) * cols * 4)


def gather_sum_bound(tab: torch.Tensor, idx: torch.Tensor, iters: int,
                     out_dtype: torch.dtype) -> Dict[str, object]:
    """P2-P4: the distinct table rows the ``iters`` wrapped gathers reach,
    read once, the indices in and the sums out; one add an element."""
    n, width = tab.shape
    reach = (idx.to(torch.int64)[:, None] + torch.arange(iters, device=idx.device)) % n
    rows = int(torch.unique(reach).numel())
    out_size = torch.empty(0, dtype=out_dtype).element_size()
    nbytes = rows * width * tab.element_size() + idx.numel() * (4 + out_size)
    return bound(idx.numel() * iters * width, nbytes)
