"""Shared accel helpers: window packing, the plain window test, hit finalize.

Counterpart of ``hare_tpu/accel/common.py``.  ``pack_windows`` is a NumPy copy
(bit-equal tables; the tests check it).  ``test_windows`` is the plain
PyTorch statement of the candidate test that K1 (``kernels/csrc/
grid_shoot.cu``) fuses into its march.  ``finalize_hits`` is K2's wrapper
and, where a gradient is wanted, the ``_hit_vals`` custom VJP's counterpart:
its backward is A3 (``finalize_hits_bwd``), whose vertex cotangents
``accel.scatter.scatter_add_ordered`` sums onto the vertices.  Each runs its
CUDA kernel for CUDA tensors, its plain version for CPU tensors.

Nearest-hit reductions use one int64 *hit key* per candidate,
``float_bits(t) << 32 | tri_id``: for the positive t of an accepted hit the
float bits order like t, so ``amin`` over keys picks the nearest t and, on
equal t, the lowest triangle id — the JAX tie rule (``common.py:224-242``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..geom.intersect import kernel_components
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..kernels import build
from ..mesh.scene import Scene

__all__ = [
    "NO_HIT_KEY",
    "WIN",
    "check_device",
    "check_kernel",
    "check_rays",
    "detach_rays",
    "finalize_hits",
    "finalize_hits_bwd",
    "finalize_hits_bwd_plain",
    "finalize_hits_plain",
    "hit_key",
    "key_to_hit",
    "note_rows",
    "pack_windows",
    "ray_counter",
    "repack_windows",
    "tally_rows",
    "tally_runs",
    "test_runs",
    "test_windows",
]

# Default triangles per window row (the JAX package's WIN).
WIN = 16
# Hit key of "no accepted candidate": above every real key.
NO_HIT_KEY = (1 << 63) - 1
KERNELS = ("watertight", "mt")
# The list :func:`tally_runs` collects into, or None.
_tally: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
# The (table, rows) pairs :func:`tally_rows` collects into, or None.
_rows: Optional[List[Tuple[str, torch.Tensor]]] = None
# The persistent launches' ray counters, by (device index, raw stream).
_RAY_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def pack_windows(
    tri: np.ndarray,
    tri_poly: np.ndarray,
    tri_top: np.ndarray,
    start: np.ndarray,
    counts: np.ndarray,
    items: np.ndarray,
    win: int = WIN,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-group triangle lists into 128-lane window rows (host side).

    Shared device layout for every accel structure (grid cells, octree and
    KD-tree leaves): each row holds a WIN-triangle *window* of one group's
    list, geometry COMPONENT-MAJOR — lane ``c*WIN+k`` is component c
    (v0x..e2z) of instance k — so the test kernel consumes static WIN-lane
    slices with no cross-lane reshapes; triangle / polygon / topology ids
    ride bitcast in lanes 9*WIN:12*WIN.  Row ``n_windows`` is all-null.

    Args:
      tri: (T, 3, 3) triangle vertices. tri_poly/tri_top: (T,) ids.
      start/counts: (G,) CSR offsets into ``items`` per group.
      items: (total,) triangle ids, group-major.
    Returns:
      (win_data (NW+1, 12*win) f32, win_start (G,) i64, n_wins (G,) i64)
    """
    n_wins_per = -(-counts // win)
    win_start = np.concatenate([[0], np.cumsum(n_wins_per)]).astype(np.int64)
    n_windows = int(win_start[-1])
    win_data = np.zeros((n_windows + 1, 12 * win), np.float32)
    if n_windows:
        occ = np.nonzero(counts)[0]
        win_grp = np.repeat(occ, n_wins_per[occ])
        win_local = np.arange(n_windows) - win_start[win_grp]
        lane = np.arange(win)
        pos = start[win_grp][:, None] + (win_local[:, None] * win + lane)
        in_range = pos < (start[win_grp] + counts[win_grp])[:, None]
        pos_c = np.minimum(pos, len(items) - 1)
        t_ids = np.where(in_range, items[pos_c], -1)
        safe = np.maximum(t_ids, 0)
        g = tri[safe]  # (n_windows, win, 3, 3)
        v0 = g[:, :, 0, :]
        ops = np.concatenate(
            [v0, g[:, :, 1, :] - v0, g[:, :, 2, :] - v0], axis=-1
        )
        ops = np.where(in_range[:, :, None], ops, 0.0)
        win_data[:n_windows, 0 : 9 * win] = ops.transpose(0, 2, 1).reshape(
            n_windows, 9 * win
        )
        win_data[:n_windows, 9 * win : 10 * win] = np.where(
            in_range, t_ids, -1
        ).astype(np.int32).view(np.float32)
        win_data[:n_windows, 10 * win : 11 * win] = np.where(
            in_range, tri_poly[safe], -2
        ).astype(np.int32).view(np.float32)
        win_data[:n_windows, 11 * win : 12 * win] = np.where(
            in_range, tri_top[safe], -1
        ).astype(np.int32).view(np.float32)
    win_data[n_windows, 9 * win : 10 * win] = (
        np.full(win, -1, np.int32).view(np.float32)
    )
    win_data[n_windows, 10 * win : 11 * win] = (
        np.full(win, -2, np.int32).view(np.float32)
    )
    win_data[n_windows, 11 * win : 12 * win] = (
        np.full(win, -1, np.int32).view(np.float32)
    )
    return win_data, win_start[:-1], n_wins_per.astype(np.int64)


def repack_windows(win_data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Repack component-major window rows (lane ``c*win + k``, as
    :func:`pack_windows` and the JAX package make them) tri-major, the layout
    one GPU thread reads per candidate:

      - ``win_geom`` (R, win, 12) f32: per triangle slot v0 | e1 | e2 and
        three zero lanes, so a slot is three aligned float4 loads;
      - ``win_ids`` (R, win, 4) i32: triangle, polygon, topology id and a
        zero lane — split from the f32 lanes with ``.view(np.int32)``, so no
        id ever passes through float arithmetic.

    Same rows, same triangles in the same order, same ids."""
    win_data = np.ascontiguousarray(win_data, np.float32)
    rows, win = win_data.shape[0], win_data.shape[1] // 12
    geom = np.zeros((rows, win, 12), np.float32)
    geom[..., :9] = win_data[:, : 9 * win].reshape(rows, 9, win).transpose(0, 2, 1)
    ids = np.zeros((rows, win, 4), np.int32)
    ids[..., :3] = (
        win_data.view(np.int32)[:, 9 * win :].reshape(rows, 3, win).transpose(0, 2, 1)
    )
    return geom, ids


def check_device(*tensors: torch.Tensor) -> str:
    """The device type the tensors share: ``"cpu"`` (plain versions) or
    ``"cuda"`` (kernels).  Anything else raises — there is no fallback."""
    types = {t.device.type for t in tensors}
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    (kind,) = types
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device type {kind!r}")
    return kind


def check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {KERNELS}")


def check_rays(rays: Ray) -> None:
    """The ray batch as every traversal kernel reads it: (N, 3) f32 origins
    and directions, (N, 2) int32 exclusions."""
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or ex.shape != (n, 2):
        raise ValueError(
            f"rays must be (N, 3), (N, 3), (N, 2); got {tuple(o.shape)}, "
            f"{tuple(d.shape)}, {tuple(ex.shape)}"
        )
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("ray origin and direction must be float32")
    if ex.dtype != torch.int32:
        raise TypeError("rays.exclude_poly must be int32")


def detach_rays(rays: Ray) -> Ray:
    """The rays as a traversal takes them: outside the autograd graph, as
    the JAX package stops the gradient at every traversal's inputs
    (``voxel.py:489-490``, ``tree.py:278-279``, ``ropes.py:307-308``).  The
    gradient w.r.t. origins and directions comes from the finalize
    backward alone."""
    o, d = rays.origin, rays.direction
    if o.requires_grad or d.requires_grad:
        return Ray(o.detach(), d.detach(), rays.exclude_poly)
    return rays


def hit_key(t: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """int64 key ordering hits by (t, tri id); valid for t > 0."""
    return (t.contiguous().view(torch.int32).to(torch.int64) << 32) | tri.to(
        torch.int64
    )


def key_to_hit(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_t f32, best_tri i32) from hit keys; misses -> (inf, -1)."""
    miss = key == NO_HIT_KEY
    t = (key >> 32).to(torch.int32).view(torch.float32)
    tri = (key & 0xFFFFFFFF).to(torch.int32)
    return (
        torch.where(miss, float("inf"), t),
        torch.where(miss, -1, tri),
    )


def test_windows(
    win_geom: torch.Tensor,
    win_ids: torch.Tensor,
    rows: torch.Tensor,
    o: torch.Tensor,
    d: torch.Tensor,
    ex: torch.Tensor,
    min_t: float,
    top_index: Optional[int] = None,
    kernel: str = "watertight",
) -> torch.Tensor:
    """Plain candidate test: query q tests the ``win`` triangles of window
    row ``rows[q]`` against ray ``(o[q], d[q])`` with exclusions ``ex[q]``.

    Acceptance is the JAX rule (``common.py:251-263``): valid, t > min_t,
    tri id >= 0, poly not in ex (and top == top_index when given).
    Returns the (Q,) int64 hit key of each query's nearest accepted hit.
    """
    g = win_geom[rows]  # (Q, win, 12): v0 | e1 | e2 | 3 zero lanes
    ids = win_ids[rows]  # (Q, win, 4): tri, poly, top, 0
    o_cmp = tuple(o[:, c : c + 1] for c in range(3))
    d_cmp = tuple(d[:, c : c + 1] for c in range(3))
    valid, t, _, _ = kernel_components(
        kernel, o_cmp, d_cmp, tuple(g[..., c] for c in range(9))
    )
    tid, poly = ids[..., 0], ids[..., 1]
    acc = (
        valid
        & (t > min_t)
        & (tid >= 0)
        & (poly != ex[:, 0:1])
        & (poly != ex[:, 1:2])
    )
    if top_index is not None:
        acc &= ids[..., 2] == top_index
    key = torch.where(acc, hit_key(t, tid), NO_HIT_KEY)
    return key.amin(dim=1)


def test_runs(
    win_geom: torch.Tensor,
    win_ids: torch.Tensor,
    start: torch.Tensor,
    count: torch.Tensor,
    o: torch.Tensor,
    d: torch.Tensor,
    ex: torch.Tensor,
    min_t: float,
    top_index: Optional[int] = None,
    kernel: str = "watertight",
) -> torch.Tensor:
    """Plain window-run test: query q tests the ``count[q]`` window rows from
    row ``start[q]`` (a grid cell's or a tree leaf's run) with
    :func:`test_windows`.  Returns the (Q,) int64 hit key of each query's
    nearest accepted hit, ``NO_HIT_KEY`` where none — the plain statement of
    ``hare::test_run`` in ``kernels/csrc/windows.cuh``."""
    if _tally is not None:
        _tally.append((start.to(torch.int64), count.to(torch.int64)))
    n = count.shape[0]
    out = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=count.device)
    count = count.to(torch.int64)
    q = torch.repeat_interleave(torch.arange(n, device=count.device), count)
    if q.numel() == 0:
        return out
    first = torch.repeat_interleave(torch.cumsum(count, 0) - count, count)
    rows = torch.repeat_interleave(start.to(torch.int64), count) + (
        torch.arange(q.numel(), device=count.device) - first
    )
    keys = test_windows(
        win_geom, win_ids, rows, o[q], d[q], ex[q], min_t, top_index, kernel
    )
    return out.scatter_reduce_(0, q, keys, reduce="amin")


@contextmanager
def tally_runs() -> Iterator[List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Collect the runs that every :func:`test_runs` call is handed inside
    the block, as ``(start, count)`` pairs of int64 tensors: the triangle
    work of a plain traversal, from which ``benchmarks/bounds.py`` computes
    the kernel's bound."""
    global _tally
    outer, _tally = _tally, []
    try:
        yield _tally
    finally:
        _tally = outer


def note_rows(table: str, rows: torch.Tensor) -> None:
    """Record that a plain walk read ``rows`` of its table ``table``, when a
    :func:`tally_rows` block is open."""
    if _rows is not None:
        _rows.append((table, rows.to(torch.int64)))


@contextmanager
def tally_rows() -> Iterator[List[Tuple[str, torch.Tensor]]]:
    """Collect the node rows the plain tree and rope walks read inside the
    block, as ``(table name, row indices)`` pairs (a row once per read):
    with :func:`tally_runs`, the work ``benchmarks/bounds.py`` computes the
    walks' bounds from."""
    global _rows
    outer, _rows = _rows, []
    try:
        yield _rows
    finally:
        _rows = outer


def ray_counter(device: torch.device) -> torch.Tensor:
    """The ray counter of the persistent launches (K1, B2 and B3,
    ``kernels/csrc/persistent.cuh``) on ``device`` for the current stream:
    two zeroed ints, made once per (device, stream) and left at zero by
    every launch.  Launches on one stream run in turn, so the three kernels
    share it."""
    # The raw stream handle, without the Stream object that
    # torch.cuda.current_stream builds: that costs several microseconds of
    # host time a call, on a path the host already bounds.
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    counter = _RAY_COUNTERS.get(key)
    if counter is None:
        counter = _RAY_COUNTERS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return counter


def finalize_hits_plain(
    scene: Scene,
    rays: Ray,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    kernel: str = "watertight",
) -> HitRecord:
    """Plain version of K2: hit record of the winners, by direct indexing."""
    hit = torch.isfinite(best_t)
    tri = torch.clamp(best_tri, min=0)
    g = scene.tri_geom[tri.long()]
    meta = scene.tri_meta[tri.long()]
    o, d = rays.origin, rays.direction
    _, t, u, v = kernel_components(
        kernel,
        tuple(o[:, c] for c in range(3)),
        tuple(d[:, c] for c in range(3)),
        tuple(g[:, c] for c in range(9)),
        unmasked=True,
    )
    e1x, e1y, e1z, e2x, e2y, e2z = (g[:, c] for c in range(3, 9))
    normal = torch.stack(
        [e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z, e1x * e2y - e1y * e2x],
        dim=-1,
    )
    t = torch.where(hit, t, 0.0)  # keeps miss lanes finite
    point = o + t[:, None] * d
    return HitRecord(
        hit=hit,
        t=torch.where(hit, t, float("inf")),
        u=torch.where(hit, u, 0.0),
        v=torch.where(hit, v, 0.0),
        point=torch.where(hit[:, None], point, 0.0),
        poly_id=torch.where(hit, meta[:, 0], NO_POLY),
        tri_id=torch.where(hit, tri, NO_POLY),
        normal=normal,
        edge_nbr=meta[:, 1:4],
    )


def _finalize_kernel(
    scene: Scene,
    rays: Ray,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    kernel: str,
) -> HitRecord:
    """K2 on CUDA tensors (``kernels/csrc/finalize_hits.cu``)."""
    o, d = rays.origin, rays.direction
    n = o.shape[0]
    t_rows = scene.tri_geom.shape[0]
    if (o.shape != (n, 3) or d.shape != (n, 3) or best_t.shape != (n,)
            or best_tri.shape != (n,) or scene.tri_geom.shape != (t_rows, 9)
            or scene.tri_meta.shape != (t_rows, 8)):
        raise ValueError("finalize_hits: ray, winner or scene table shapes disagree")
    f = dict(dtype=torch.float32, device=o.device)
    i = dict(dtype=torch.int32, device=o.device)
    out = HitRecord(
        hit=torch.empty(n, dtype=torch.bool, device=o.device),
        t=torch.empty(n, **f),
        u=torch.empty(n, **f),
        v=torch.empty(n, **f),
        point=torch.empty(n, 3, **f),
        poly_id=torch.empty(n, **i),
        tri_id=torch.empty(n, **i),
        normal=torch.empty(n, 3, **f),
        edge_nbr=torch.empty(n, 3, **i),
    )
    finalize_hits.launches += 1
    build.launch(
        "hare_finalize_hits",
        _contig(scene.tri_geom, torch.float32), _contig(scene.tri_meta, torch.int32),
        _contig(best_t, torch.float32), _contig(best_tri, torch.int32),
        _contig(o, torch.float32), _contig(d, torch.float32), n,
        int(kernel == "mt"), *out,
    )
    return out


def _finalize_forward(scene, rays, best_t, best_tri, kernel) -> HitRecord:
    if check_device(scene.tri_geom, rays.origin, rays.direction, best_t, best_tri) == "cpu":
        return finalize_hits_plain(scene, rays, best_t, best_tri, kernel)
    return _finalize_kernel(scene, rays, best_t, best_tri, kernel)


def _vals_live_plain(kernel: str, corners: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The live recompute (``_vals_live``, ``common.py:387-397``): the
    unmasked (t, u, v) and the normal of triangles given by their corners
    ``(N, 3, 3)``."""
    v0, v1, v2 = corners[:, 0], corners[:, 1], corners[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    _, t, u, v = kernel_components(
        kernel,
        tuple(o[:, c] for c in range(3)),
        tuple(d[:, c] for c in range(3)),
        tuple(v0[:, c] for c in range(3)) + tuple(e1[:, c] for c in range(3))
        + tuple(e2[:, c] for c in range(3)),
        unmasked=True,
    )
    normal = torch.stack([
        e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
        e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
        e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0],
    ], dim=-1)
    return t, u, v, normal


def finalize_hits_bwd_plain(
    vertices: torch.Tensor,
    tri_meta: torch.Tensor,
    best_tri: torch.Tensor,
    t: torch.Tensor,
    hit: torch.Tensor,
    o: torch.Tensor,
    d: torch.Tensor,
    cotangents: Tuple[torch.Tensor, ...],
    kernel: str = "watertight",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of A3: autograd through :func:`_vals_live_plain` over
    the winners' live corners and the point ``o + where(hit, t, 0) d``, as
    ``jax.vjp`` of ``_vals_live`` (``common.py:424-431``) with the point
    around it (:460-462).  ``cotangents`` are those of t, u, v, point and
    normal.  Returns ``(d_origin (N, 3), d_direction (N, 3), keys (3N,)
    i32, d_corner (3N, 3))``: each corner's cotangent beside its vertex id.
    ``t`` is unused: the live t has the forward's bits where ``tri_geom``
    holds the live vertices (``Scene.with_vertices``)."""
    del t
    iv = tri_meta[torch.clamp(best_tri, min=0).long(), 4:7]
    with torch.enable_grad():
        corners = vertices.detach()[iv.long()].requires_grad_()
        oo, dd = o.detach().requires_grad_(), d.detach().requires_grad_()
        tl, ul, vl, normal = _vals_live_plain(kernel, corners, oo, dd)
        th = torch.where(hit, tl, 0.0)
        outs = (th, torch.where(hit, ul, 0.0), torch.where(hit, vl, 0.0),
                torch.where(hit[:, None], oo + th[:, None] * dd, 0.0), normal)
        g_corner, g_o, g_d = torch.autograd.grad(outs, (corners, oo, dd), cotangents)
    return g_o, g_d, iv.reshape(-1), g_corner.reshape(-1, 3)


def finalize_hits_bwd(
    vertices: torch.Tensor,
    tri_meta: torch.Tensor,
    best_tri: torch.Tensor,
    t: torch.Tensor,
    hit: torch.Tensor,
    o: torch.Tensor,
    d: torch.Tensor,
    cotangents: Tuple[torch.Tensor, ...],
    kernel: str = "watertight",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """A3: the finalize backward per ray, as :func:`finalize_hits_bwd_plain`
    returns it.  CUDA tensors launch ``kernels/csrc/finalize_bwd.cu``, whose
    closed form serves both triangle tests; CPU tensors take the plain
    version."""
    if check_device(vertices, tri_meta, best_tri, t, hit, o, d, *cotangents) == "cpu":
        return finalize_hits_bwd_plain(vertices, tri_meta, best_tri, t, hit, o, d,
                                       cotangents, kernel)
    n = o.shape[0]
    shapes = [(n,)] * 3 + [(n, 3)] * 2
    if (len(cotangents) != 5 or any(g.shape != sh for g, sh in zip(cotangents, shapes))
            or o.shape != (n, 3) or d.shape != (n, 3) or not best_tri.shape == t.shape
            == hit.shape == (n,) or vertices.shape[1:] != (3,) or tri_meta.shape[1:] != (8,)):
        raise ValueError("finalize_hits_bwd: ray, winner, table or cotangent (t, u, v, "
                         "point, normal) shapes disagree")
    f = dict(dtype=torch.float32, device=o.device)
    d_o, d_d = torch.empty(n, 3, **f), torch.empty(n, 3, **f)
    keys = torch.empty(3 * n, dtype=torch.int32, device=o.device)
    d_corner = torch.empty(3 * n, 3, **f)
    finalize_hits_bwd.launches += 1
    build.launch(
        "hare_finalize_hits_bwd", _contig(vertices, torch.float32),
        _contig(tri_meta, torch.int32), _contig(best_tri, torch.int32), _contig(t, torch.float32),
        _contig(hit, torch.bool), _contig(o, torch.float32), _contig(d, torch.float32),
        *(_contig(g, torch.float32) for g in cotangents), n, d_o, d_d, keys, d_corner,
    )
    return d_o, d_d, keys, d_corner


finalize_hits_bwd.launches = 0


class _FinalizeHits(torch.autograd.Function):
    """The hit record, differentiable in the vertices and the rays
    (``_hit_vals`` with its custom VJP, ``common.py:400-434``, and the
    point around it).  Forward: K2 from ``scene.tri_geom``; backward: A3 at
    the live ``vertices``, its corner cotangents summed onto them by
    :func:`~.scatter.scatter_add_ordered`.  ``tri_geom`` gets no cotangent,
    so the gradient reaches the vertices exactly once."""

    @staticmethod
    def forward(ctx, vertices, o, d, scene, exclude, best_t, best_tri, kernel):
        hr = _finalize_forward(scene, Ray(o, d, exclude), best_t, best_tri, kernel)
        ctx.mark_non_differentiable(hr.hit, hr.poly_id, hr.tri_id, hr.edge_nbr)
        ctx.save_for_backward(vertices, scene.tri_meta, best_tri, hr.t, hr.hit, o, d)
        ctx.kernel = kernel
        return tuple(hr)

    @staticmethod
    def backward(ctx, _hit, g_t, g_u, g_v, g_point, _poly, _tri, g_normal, _nbr):
        from .scatter import scatter_add_ordered  # scatter imports this module

        vertices, tri_meta, best_tri, t, hit, o, d = ctx.saved_tensors
        d_o, d_d, keys, d_corner = finalize_hits_bwd(
            vertices, tri_meta, best_tri, t, hit, o, d, (g_t, g_u, g_v, g_point, g_normal),
            ctx.kernel)
        d_v = None
        if ctx.needs_input_grad[0]:
            d_v = scatter_add_ordered(keys, d_corner, vertices.shape[0])
        return d_v, d_o, d_d, None, None, None, None, None


def finalize_hits(
    scene: Scene,
    rays: Ray,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    kernel: str = "watertight",
) -> HitRecord:
    """K2: the hit record of the traversal winners (``best_t`` decides the
    hit mask; t, u, v are re-solved on the winner's plane, unmasked).
    ``best_tri`` must hold -1 or a row of ``scene.tri_geom``, as
    :func:`~.voxel.grid_shoot` returns.

    CUDA tensors launch ``kernels/csrc/finalize_hits.cu``; CPU tensors take
    :func:`finalize_hits_plain`.  Where ``scene.vertices``, the origins or
    the directions require grad, the record is differentiable in them
    (t, u, v, point, normal): the backward is A3 (:func:`finalize_hits_bwd`)
    at the live vertices, as the JAX package's custom VJP.
    """
    check_kernel(kernel)
    o, d, v = rays.origin, rays.direction, scene.vertices
    if torch.is_grad_enabled() and (v.requires_grad or o.requires_grad or d.requires_grad):
        return HitRecord(*_FinalizeHits.apply(v, o, d, scene, rays.exclude_poly, best_t,
                                              best_tri, kernel))
    return _finalize_forward(scene, rays, best_t, best_tri, kernel)


finalize_hits.launches = 0


def _contig(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tensor as the kernels read it; raises on a wrong dtype."""
    if x.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {x.dtype}")
    return x.contiguous()
