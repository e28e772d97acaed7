"""The least time an H100 could take for each kernel's work: its bound.

A bound is the larger of two times: the operations the work needs over the
card's peak FP32 rate, and the bytes it must move (each input read once,
each output written once) over the card's memory rate.  Where the work
depends on the data, it is counted on the run's own inputs: K1's from
:func:`~..accel.voxel.grid_work`, B2's and B3's from the runs their plain
versions hand :func:`~..accel.common.test_runs`.  ``chip_smoke.py`` puts
each kernel's time beside its bound; the CPU tests check the counts.

Operations are counted by hand from ``kernels/csrc``, at the fewest a test
needs (where the code forms a value in more steps, the count takes the
shorter way): FP32 adds, subtracts, multiplies and reciprocals, one each (a
contracted FMA counts as the two it replaces); compares, selects, min/max,
absolute values and sign flips are not counted.  Bytes are those the
function needs: of a window slot, its 9 geometry floats and 3 ids, not the
padding of its 16-byte loads.  So the bound is a floor, not a count of
issued instructions or of bytes loaded.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

__all__ = [
    "EXIT_OPS",
    "PEAK_BYTES",
    "PEAK_FP32",
    "SLAB_OPS",
    "TRI_TEST_OPS",
    "bound",
    "brute_shoot_bound",
    "column_sum_bound",
    "finalize_hits_bound",
    "gather_sum_bound",
    "grid_shoot_bound",
    "histogram_bound",
    "runs_work",
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
# K3 per hit lane: time / bin_dt (1), the add into the bin (1).
HISTOGRAM_OPS = 2

RAY_BYTES = 12 + 12 + 8  # origin, direction (f32), exclusions (2 x i32)
NEAREST_BYTES = 4 + 4  # best_t (f32), best_tri (i32)
SLOT_BYTES = 36 + 12  # one window slot: v0 | e1 | e2 (9 f32), tri | poly | top (3 i32)
CELL_META_BYTES = 8  # one cell_meta entry (2 x i32)
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


def walk_bound(n_rays: int, slots: int, slots_touched: int, node_visits: int,
               visit_ops: int, kernel: str = "watertight") -> Dict[str, object]:
    """B2 or B3: ``slots`` triangle tests of ``slots_touched`` distinct
    non-null slots (:func:`runs_work`), ``node_visits`` node pops or rope
    steps of ``visit_ops`` operations each (``K * SLAB_OPS`` a pop,
    ``EXIT_OPS`` a rope step); rays in, nearest hits out.  The node rows are
    not counted in the bytes: their distinct count is not recorded, so this
    bound is a floor below the tree's own."""
    ops = slots * TRI_TEST_OPS[kernel] + node_visits * visit_ops
    nbytes = n_rays * (RAY_BYTES + NEAREST_BYTES) + slots_touched * SLOT_BYTES
    return bound(ops, nbytes)


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


def histogram_bound(hit: torch.Tensor, n_bins: int) -> Dict[str, object]:
    """K3: energy, time (f32) and hit (bool) of every lane in, the bins out;
    two operations a hit lane."""
    n = hit.numel()
    return bound(int(hit.sum()) * HISTOGRAM_OPS, n * (4 + 4 + 1) + n_bins * 4)


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
