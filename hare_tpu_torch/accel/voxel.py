"""Uniform voxel grid with 3-D DDA traversal — the main path's accel structure.

Counterpart of ``hare_tpu/accel/voxel.py``.  The build (``_fill``,
``_refine_fill``, ``_chebyshev_distance``, ``build_grid_tables``) is a NumPy
copy of the JAX builder and makes bit-equal tables; ``VoxelGrid.from_numpy``
then repacks the TPU's component-major window rows into the tri-major
layout one GPU thread reads per candidate (``common.repack_windows``:
``win_geom`` (R, win, 12) f32 v0 | e1 | e2, ``win_ids`` (R, win, 4) i32
tri | poly | top).  Same rows, same triangles in the same order, same ids;
the last row is the all-null row.  ``cell_meta`` is unchanged:
``[win_start, n_wins << 8 | dist]``.

Traversal: :func:`grid_shoot` is K1 (``kernels/csrc/grid_shoot.cu``, one
ray per group of lanes, march and test fused, early exit) for CUDA tensors,
and :func:`grid_shoot_plain` — a vectorised lockstep march over the active
rays — for CPU tensors; :func:`grid_work` replays that march and counts the
cells and triangle slots it visits.  Both return the nearest accepted hit over every
triangle of every cell the ray crosses, ties to the lowest triangle id:
the answer of the JAX collect-then-test rounds, without its candidate
buffers, resume rounds or straggler tiers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..geom.intersect import MIN_T, ray_aabb
from ..geom.primitives import HitRecord, Ray
from ..geom.tribox import tri_box_overlap
from ..kernels import build
from ..mesh.scene import Scene
from ..mesh.topology import Topology
from ..utils.tracing import count, span
from .common import (
    NO_HIT_KEY,
    check_device,
    check_kernel,
    check_rays,
    detach_rays,
    finalize_hits,
    key_to_hit,
    pack_windows,
    ray_counter,
    repack_windows,
    stream_buffer,
    test_runs,
    traversal_span,
)
from .octree import _extract

__all__ = [
    "VoxelGrid",
    "build_grid_tables",
    "build_voxel_grid",
    "grid_shoot",
    "grid_shoot_args",
    "grid_order_keys_plain",
    "grid_order_plain",
    "grid_shoot_plain",
    "grid_work",
    "order_engages",
    "shoot_grid",
]

# Voxel padding factor for the SAT fill (Voxel_Grid.cs:283-285: +-0.001 voxel).
FILL_PAD = 1.001
# Epsilon nudge (in units of char_step) applied when clipping an outside ray
# to the grid entry (Voxel_Grid.cs:367-377 uses 1e-6 absolute; we scale).
ENTRY_EPS = 1e-4
# Distance-field cap (cells); larger empty regions are crossed in several
# hops.  The cell_meta packing gives the field its full 8 bits.
DIST_CAP = 255

# K1's ray order (``kernels/csrc/grid_shoot.cu``, the ``grid_shoot_order_*``
# kernels): the shot's rays enter the march sorted by a key, so that the
# rays in flight together share cells and window rows in the caches.  A
# ray's key is the Morton code of its origin quantised to 2^b cells an axis
# over the grid's box, above the Morton code of its direction's octahedral
# map quantised to 2^c cells an axis (:func:`grid_order_keys_plain`).  (b,
# c) are the kernels' ``kOriginBits`` and ``kDirBits``, chosen by
# ``benchmarks/kernel_sweep.py --order`` (the numbers beside them there).
ORDER_BITS = (2, 7)
# The order engages where a shot holds at least this many times the rays
# the card runs at once (:func:`order_engages`).  K1 with the order against
# without on an H100 80GB HBM3 (8,448 rays at once), bounce by bounce:
# config 5 at 2^15 rays (3.9 times) +15.8% / -7.1%, 2^16 (7.8) -1.6% /
# +0.3%, 2^17 (15.5) -11.1% / -10.5%, 2^18 -21.8% / -18.7%; the bench
# scene's 48^3 grid, whose tables fit in L2, at 2^15 +35.9% / -2.6% /
# +10.9%, 2^16 +19.7% / +0.3% / +1.5%, 2^17 +5.4% / -8.7% / -7.0% (-5.2%
# over the three), 2^18 -1.3% / -13.1% / -11.2%, 2^20 -5.2% / -15.8% /
# -14.4% (PERF.md §6).
ORDER_MIN_WAVES = 12


def _fill(
    tri: np.ndarray, gmin: np.ndarray, vox: np.ndarray, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized voxel fill: CSR (cell_start, cell_tris).

    For each triangle, candidate voxels come from its AABB footprint; a
    single batched SAT call prunes to true overlaps.  O(sum of footprint
    sizes) work with no Python-per-voxel loops.
    """
    T = len(tri)
    nx, ny, nz = dims
    i_lo, i_hi = _footprint(tri, gmin, vox, dims)
    counts = np.prod(i_hi - i_lo + 1, axis=1)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(nx * ny * nz + 1, np.int32), np.zeros(0, np.int32)

    tri_ids = np.repeat(np.arange(T), counts)
    # Enumerate each triangle's (ix, iy, iz) footprint without Python loops:
    # local linear index within the footprint box, decomposed per triangle.
    ends = np.cumsum(counts)
    local = np.arange(total) - np.repeat(ends - counts, counts)
    span = i_hi - i_lo + 1  # (T, 3)
    sy = span[tri_ids, 1]
    sz = span[tri_ids, 2]
    iz = local % sz
    iy = (local // sz) % sy
    ix = local // (sz * sy)
    cell_ijk = np.stack(
        [i_lo[tri_ids, 0] + ix, i_lo[tri_ids, 1] + iy, i_lo[tri_ids, 2] + iz], axis=1
    )

    center = gmin + (cell_ijk + 0.5) * vox
    half = np.broadcast_to(0.5 * vox * FILL_PAD, center.shape)
    keep = tri_box_overlap(tri[tri_ids], center, half)

    tri_ids = tri_ids[keep]
    cell_ijk = cell_ijk[keep]
    return _pack_csr(tri_ids, cell_ijk, dims)


def _pack_csr(
    tri_ids: np.ndarray, cell_ijk: np.ndarray, dims: Tuple[int, int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    nx, ny, nz = dims
    lin = (cell_ijk[:, 0] * ny + cell_ijk[:, 1]) * nz + cell_ijk[:, 2]
    order = np.argsort(lin, kind="stable")
    lin, tri_ids = lin[order], tri_ids[order]
    cell_counts = np.bincount(lin, minlength=nx * ny * nz)
    cell_start = np.concatenate([[0], np.cumsum(cell_counts)]).astype(np.int32)
    return cell_start, tri_ids.astype(np.int32)


def _footprint(
    tri: np.ndarray, gmin: np.ndarray, vox: np.ndarray, dims
) -> Tuple[np.ndarray, np.ndarray]:
    lo = tri.min(axis=1)
    hi = tri.max(axis=1)
    i_lo = np.clip(
        np.floor((lo - gmin) / vox - 1e-9).astype(np.int64), 0, np.array(dims) - 1
    )
    i_hi = np.clip(
        np.floor((hi - gmin) / vox + 1e-9).astype(np.int64), 0, np.array(dims) - 1
    )
    return i_lo, i_hi


def _refine_fill(
    tri: np.ndarray,
    gmin: np.ndarray,
    vox: np.ndarray,
    dims: Tuple[int, int, int],
    p_start: np.ndarray,
    p_tris: np.ndarray,
    p_dims: Tuple[int, int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """Parent-membership-pruned fill for one 2x-per-axis doubling.

    Candidate (triangle, child-cell) pairs come only from the previous
    level's (triangle, parent-cell) members, each parent spawning its <= 8
    children intersected with the triangle's fine-level AABB footprint —
    the reference's adaptive ctor does exactly this (each child tested
    against the PARENT's member polys, ``Voxel_Grid.cs:208-215``); the r4
    build instead re-ran the full footprint fill per doubling, an
    O(doublings) constant-factor loss on big scenes.  Pruning is exact:
    the padded child box (pad 0.1% of the CHILD voxel) nests strictly
    inside the padded parent box (pad 0.1% of the 2x parent voxel), so
    SAT(child) implies SAT(parent) and no membership can appear at the
    fine level that was absent at the coarse one.  Each fine cell has
    exactly one parent, so no duplicate pairs arise.
    """
    i_lo, i_hi = _footprint(tri, gmin, vox, dims)
    p_counts = np.diff(p_start)
    par_lin = np.repeat(np.arange(len(p_counts), dtype=np.int64), p_counts)
    t_par = p_tris.astype(np.int64)
    pny, pnz = p_dims[1], p_dims[2]
    pc = np.stack(
        [par_lin // (pnz * pny), (par_lin // pnz) % pny, par_lin % pnz], axis=1
    )
    c_lo = np.maximum(i_lo[t_par], pc * 2)
    c_hi = np.minimum(i_hi[t_par], pc * 2 + 1)
    span = c_hi - c_lo + 1
    ok = (span > 0).all(axis=1)
    t_par, c_lo, span = t_par[ok], c_lo[ok], span[ok]
    counts = np.prod(span, axis=1)
    total = int(counts.sum())
    nx, ny, nz = dims
    if total == 0:
        return np.zeros(nx * ny * nz + 1, np.int32), np.zeros(0, np.int32)
    pair_ids = np.repeat(np.arange(len(counts)), counts)
    ends = np.cumsum(counts)
    local = np.arange(total) - np.repeat(ends - counts, counts)
    sy, sz = span[pair_ids, 1], span[pair_ids, 2]
    iz = local % sz
    iy = (local // sz) % sy
    ix = local // (sz * sy)
    cell_ijk = np.stack(
        [c_lo[pair_ids, 0] + ix, c_lo[pair_ids, 1] + iy, c_lo[pair_ids, 2] + iz],
        axis=1,
    )
    tri_ids = t_par[pair_ids]
    center = gmin + (cell_ijk + 0.5) * vox
    half = np.broadcast_to(0.5 * vox * FILL_PAD, center.shape)
    keep = tri_box_overlap(tri[tri_ids], center, half)
    return _pack_csr(tri_ids[keep], cell_ijk[keep], dims)


def _chebyshev_distance(occ: np.ndarray, cap: int = DIST_CAP) -> np.ndarray:
    """Chebyshev distance-to-occupied over a 3-D bool grid, capped.

    The skip rule is provably safe: from anywhere inside a cell with dist
    D, the ray crosses at least D-1 more cell boundaries before it can
    enter an occupied cell.  scipy's two-pass chamfer transform is exact
    for the chessboard metric and linear in cells.
    """
    if not occ.any():
        return np.full(occ.shape, cap, np.int32)
    from scipy import ndimage

    dist = ndimage.distance_transform_cdt(~occ, metric="chessboard")
    return np.minimum(dist, cap).astype(np.int32)


def build_grid_tables(
    source: Union[Topology, Sequence[Topology], Scene],
    domain: Optional[int] = None,
    max_doublings: int = 6,
    avg_polys: float = 10.0,
    pad: float = 1e-3,
    win: Optional[int] = None,
    only_top: Optional[int] = None,
) -> dict:
    """The grid's host tables, bit-equal to the JAX package's ``VoxelGrid``
    fields (same names, as NumPy; ``dims``/``char_step``/``max_cell_wins``/
    ``n_tris`` as Python values).  ``domain`` given -> fixed ``domain^3``
    resolution (``Voxel_Grid.cs:48``); ``domain=None`` -> adaptive doubling
    until the mean triangles per occupied voxel < ``avg_polys`` or
    ``max_doublings`` (``:128-254``).  A ``Scene`` source is read on the
    host (:func:`~.octree._extract`).

    ``only_top``: the grid over ONE topology's triangles, in that
    topology's own box, its rows holding the GLOBAL triangle, polygon and
    topology ids, so hits finalize against the shared multi-topology scene:
    the reference's 4-D ``Voxel_Inv`` per-topology lists
    (``Voxel_Grid.cs:83``).  A topology with no triangles raises
    ``ValueError``.
    """
    tri, tri_poly, tri_top = _extract(source)

    # Per-topology restriction: fill over the selected triangles only, but
    # keep GLOBAL ids in the packed rows (global_ids remap below).
    global_ids = None
    if only_top is not None:
        sel = tri_top == only_top
        if not sel.any():
            raise ValueError(f"topology {only_top} has no triangles")
        global_ids = np.nonzero(sel)[0].astype(np.int64)
        tri_all = tri
        tri = tri[sel]

    gmin = tri.reshape(-1, 3).min(axis=0) - pad
    gmax = tri.reshape(-1, 3).max(axis=0) + pad
    extent = gmax - gmin

    if domain is not None:
        dims = (domain, domain, domain)
        vox = extent / np.array(dims)
        cell_start, cell_tris = _fill(tri, gmin, vox, dims)
    else:
        dims = (1, 1, 1)
        cell_start, cell_tris = None, None
        prev = None
        for _ in range(max_doublings + 1):
            vox = extent / np.array(dims)
            if prev is None:
                cell_start, cell_tris = _fill(tri, gmin, vox, dims)
            else:
                # Parent-membership pruning (Voxel_Grid.cs:208-215): each
                # doubling tests only the previous level's member pairs.
                cell_start, cell_tris = _refine_fill(
                    tri, gmin, vox, dims, *prev
                )
            counts = np.diff(cell_start)
            occ = counts[counts > 0]
            if len(occ) and occ.mean() < avg_polys:
                break
            if np.prod(dims) >= 2 ** (3 * max_doublings):
                break
            prev = (cell_start, cell_tris, dims)
            dims = tuple(d * 2 for d in dims)
        vox = extent / np.array(dims)

    counts = np.diff(cell_start)
    n_cells = int(np.prod(dims))

    if global_ids is not None:
        # Remap local fill ids to global; pack against the FULL arrays so
        # the stored triangle/polygon/topology ids match the shared scene.
        cell_tris = global_ids[cell_tris]
        tri = tri_all

    # ---- pack per-cell lists into the shared 128-lane window-row layout.
    win_data, win_start, n_wins_per_cell = pack_windows(
        tri, tri_poly, tri_top, cell_start[:-1].astype(np.int64), counts,
        cell_tris, **({} if win is None else {"win": win}),
    )
    if n_wins_per_cell.max(initial=0) >= (1 << 8):
        raise ValueError(
            "a cell holds >=256 window rows — raise the grid resolution "
            "(domain/max_doublings) or avg_polys; the traversal packs "
            "(win_start, n_wins) runs into one i32 (8-bit width field)"
        )
    if len(win_data) - 1 >= (1 << 23):
        raise ValueError(
            "window table exceeds 2^23 rows; the traversal packs "
            "(win_start, n_wins) runs into one i32 (23-bit start field)"
        )

    dist = _chebyshev_distance((counts > 0).reshape(dims))
    cell_meta = np.empty((n_cells, 2), np.int32)
    cell_meta[:, 0] = win_start
    cell_meta[:, 1] = (n_wins_per_cell.astype(np.int64) << 8) | dist.ravel()

    return dict(
        cell_meta=cell_meta,
        win_data=win_data,
        grid_min=gmin.astype(np.float32),
        voxel_size=vox.astype(np.float32),
        dims=tuple(int(d) for d in dims),
        char_step=float(vox.min()),
        max_cell_wins=int(n_wins_per_cell.max(initial=0)),
        n_tris=len(tri),
    )


class VoxelGrid(NamedTuple):
    """Device voxel grid: per-cell meta + tri-major window tables."""

    cell_meta: torch.Tensor  # (nx*ny*nz, 2) i32 [win_start, n_wins<<8 | dist]
    win_geom: torch.Tensor  # (R, win, 12) f32 v0|e1|e2|0,0,0; last row null
    win_ids: torch.Tensor  # (R, win, 4) i32 tri|poly|top|0; null: -1|-2|-1
    grid_min: torch.Tensor  # (3,) f32
    voxel_size: torch.Tensor  # (3,) f32
    dims: Tuple[int, int, int]
    char_step: float  # min voxel dimension (Spatial_Partition.Char_Step)
    max_cell_wins: int  # max windows in any one cell
    n_tris: int
    # f32 values as Python floats: grid_min, grid_max, voxel_size and
    # 1/voxel_size (3 each).  Both K1 and its plain version read these, so
    # the two march on identical constants.
    host_params: Tuple[float, ...]

    @property
    def n_cells(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @classmethod
    def from_numpy(
        cls, cell_meta, win_data, grid_min, voxel_size, dims, char_step,
        max_cell_wins, n_tris, device="cuda",
    ) -> "VoxelGrid":
        """From the JAX ``VoxelGrid`` tables (as NumPy): repack the
        component-major ``win_data`` (lane ``c*win + k``) tri-major."""
        geom, ids = repack_windows(win_data)
        gmin = np.asarray(grid_min, np.float32)
        vox = np.asarray(voxel_size, np.float32)
        gmax = gmin + vox * np.asarray(dims, np.float32)
        inv_vox = np.float32(1.0) / vox
        params = tuple(float(x) for x in np.concatenate([gmin, gmax, vox, inv_vox]))

        def dev(a):
            return torch.from_numpy(np.array(a)).to(device)  # a writable copy

        return cls(
            cell_meta=dev(np.asarray(cell_meta, np.int32)),
            win_geom=dev(geom),
            win_ids=dev(ids),
            grid_min=dev(gmin),
            voxel_size=dev(vox),
            dims=tuple(int(x) for x in dims),
            char_step=float(char_step),
            max_cell_wins=int(max_cell_wins),
            n_tris=int(n_tris),
            host_params=params,
        )


def build_voxel_grid(
    source: Union[Topology, Sequence[Topology], Scene],
    domain: Optional[int] = None,
    max_doublings: int = 6,
    avg_polys: float = 10.0,
    pad: float = 1e-3,
    win: Optional[int] = None,
    only_top: Optional[int] = None,
    device="cuda",
) -> VoxelGrid:
    """Build the grid on the host (:func:`build_grid_tables`) and put it on
    ``device``."""
    with span("hare.setup.structure", accel="grid"):
        with span("hare.setup.structure.tables"):
            tables = build_grid_tables(
                source, domain=domain, max_doublings=max_doublings,
                avg_polys=avg_polys, pad=pad, win=win, only_top=only_top,
            )
        with span("hare.setup.structure.upload"):
            return VoxelGrid.from_numpy(**tables, device=device)


def grid_shoot(
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: nearest accepted hit ``(best_t (N,) f32 — inf on miss,
    best_tri (N,) i32 — -1 on miss)``.

    CUDA tensors launch ``kernels/csrc/grid_shoot.cu``, the rays in the
    order of their keys where :func:`order_engages` (counted under
    ``rays.ordered``); CPU tensors take :func:`grid_shoot_plain`.  The order
    changes only which ray a group of lanes takes next: every ray's result
    is the same bits either way.
    """
    check_kernel(kernel)
    check_rays(rays)
    rays = detach_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    kind = check_device(o, d, ex, grid.cell_meta, grid.win_geom)
    if kind == "cpu":
        return grid_shoot_plain(rays, grid, kernel, min_t, top_index)
    return _grid_shoot_card(rays, grid, kernel, min_t, top_index)[:2]


class GridOrder(NamedTuple):
    """The order K1 took a shot's rays in: views of its scratch, valid until
    the next ordered shot on the stream."""

    keys: torch.Tensor  # (N,) i32 each ray's key
    order: torch.Tensor  # (N,) i32 the rays by key


def _grid_shoot_card(
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    ordered: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[GridOrder]]:
    """K1 on CUDA tensors: ``(best_t, best_tri, the order or None)``.
    ``ordered`` None leaves the order to :func:`order_engages`; True or
    False forces it (tests and ``benchmarks/kernel_sweep.py``)."""
    o = rays.origin
    n, dev = o.shape[0], o.device
    resident, fixed = card_capacity(dev, kernel)
    if ordered is None:
        ordered = order_engages(n, resident)
    # The order's counts and tile sums are zero between orders.
    scratch = stream_buffer("grid_order", dev, fixed + 3 * n, torch.int32, 0) if ordered else None
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    best_tri = torch.empty(n, dtype=torch.int32, device=dev)
    args = grid_shoot_args(rays, grid, best_t, best_tri, kernel, min_t, top_index, scratch)
    build.launch("hare_grid_shoot", *args, ray_counter(dev))
    if scratch is None:
        return best_t, best_tri, None
    count("rays.ordered", n)
    return best_t, best_tri, GridOrder(scratch[fixed:fixed + n], scratch[fixed + 2 * n:fixed + 3 * n])


def grid_shoot_args(
    rays: Ray,
    grid: VoxelGrid,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
    order: Optional[torch.Tensor] = None,
) -> tuple:
    """The arguments of the C entry point ``hare_grid_shoot`` up to the
    order's scratch ``order`` (None: the rays in index order; tensors as
    tensors, for :func:`~..kernels.build.launch`); the ray counter
    (:func:`~.common.ray_counter`) and the stream follow."""
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    fparams = (ctypes.c_float * 14)(
        *grid.host_params, ENTRY_EPS * grid.char_step, min_t
    )
    iparams = (ctypes.c_int * 6)(
        *grid.dims, grid.win_geom.shape[1],
        -1 if top_index is None else int(top_index), int(kernel == "mt"),
    )
    return (o.contiguous(), d.contiguous(), ex.contiguous(), o.shape[0],
            grid.cell_meta, grid.win_geom, grid.win_ids, fparams, iparams,
            best_t, best_tri, order)


def _quantise(u: torch.Tensor, cells: int) -> torch.Tensor:
    """``floor(u)`` clamped to ``[0, cells)``, NaN to 0: the kernels'
    ``quantise``."""
    inner = torch.where(u < cells, torch.floor(u), float(cells - 1))
    return torch.where(u >= 0, inner, 0.0).to(torch.int64)


def _morton(qs: Sequence[torch.Tensor], bits: int) -> torch.Tensor:
    """Bit k of ``qs[j]`` to bit ``k * m + (m - 1 - j)`` of the code (m =
    ``len(qs)``): the first axis highest."""
    m = len(qs)
    code = torch.zeros_like(qs[0])
    for k in range(bits):
        for j, q in enumerate(qs):
            code |= ((q >> k) & 1) << (k * m + m - 1 - j)
    return code


def grid_order_keys_plain(rays: Ray, grid: VoxelGrid,
                          bits: Tuple[int, int] = ORDER_BITS) -> torch.Tensor:
    """Plain version of the order's keys, ``(N,)`` int32, each operation
    rounded in f32 as the kernel rounds it: the Morton code of the origin's
    cell, 2^b an axis over the grid's box (``floor((o - grid_min) * 2^b /
    (grid_max - grid_min))``, clamped), shifted
    above the Morton code of the direction's octahedral map quantised to 2^c
    an axis.  The map: ``p = d / (|dx| + |dy| + |dz|)`` (0 for a zero
    direction), folded for ``dz < 0`` to ``((1 - |py|) sgn px, (1 - |px|) sgn
    py)`` with sgn 0 = 1, then ``(p + 1) * 2^c / 2``."""
    b, c = bits
    o, d = rays.origin, rays.direction
    hp = np.asarray(grid.host_params, np.float32)
    scale = np.float32(1 << b) / (hp[3:6] - hp[0:3])
    lo, scale = (torch.from_numpy(x).to(o.device) for x in (hp[0:3], scale))
    q = _quantise((o - lo) * scale, 1 << b)
    a = d.abs()
    s = (a[:, 0] + a[:, 1]) + a[:, 2]
    px = torch.where(s > 0, d[:, 0] / s, 0.0)
    py = torch.where(s > 0, d[:, 1] / s, 0.0)
    fx = (1 - py.abs()) * torch.where(px >= 0, 1.0, -1.0)
    fy = (1 - px.abs()) * torch.where(py >= 0, 1.0, -1.0)
    below = d[:, 2] < 0
    px, py = torch.where(below, fx, px), torch.where(below, fy, py)
    half = (1 << c) / 2.0
    qd = [_quantise((p + 1) * half, 1 << c) for p in (px, py)]
    key = (_morton([q[:, 0], q[:, 1], q[:, 2]], b) << (2 * c)) | _morton(qd, c)
    return key.to(torch.int32)


def grid_order_plain(rays: Ray, grid: VoxelGrid,
                     bits: Tuple[int, int] = ORDER_BITS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the order: ``(keys, order)``, the keys of
    :func:`grid_order_keys_plain` and their stable argsort (int32).  The
    kernels' order holds the rays of one key in another order; its keys,
    ``keys[order]``, are the same."""
    keys = grid_order_keys_plain(rays, grid, bits)
    return keys, torch.sort(keys, stable=True).indices.to(torch.int32)


# (device index, MT) -> hare_grid_shoot_capacity's two numbers.
_CAPACITY: Dict[Tuple[int, bool], Tuple[int, int]] = {}


def card_capacity(device: torch.device, kernel: str = "watertight") -> Tuple[int, int]:
    """K1's rays resident at once on ``device`` and the order scratch's
    words before its per-ray part (``hare_grid_shoot_capacity``, asked once
    per device and kernel)."""
    key = (device.index, kernel == "mt")
    got = _CAPACITY.get(key)
    if got is None:
        out = torch.zeros(2, dtype=torch.int32)
        build.launch("hare_grid_shoot_capacity", int(kernel == "mt"), out)
        got = _CAPACITY[key] = tuple(int(x) for x in out)
    return got


def order_engages(n: int, resident_rays: int) -> bool:
    """Whether K1 orders a shot of ``n`` rays on a card that runs
    ``resident_rays`` rays at once: only where the shot is many waves of
    rays (``ORDER_MIN_WAVES``).  Smaller shots would pay the order's
    launches for little reuse."""
    return n >= ORDER_MIN_WAVES * resident_rays


class GridWork(NamedTuple):
    """What K1's march does on a batch of rays (:func:`grid_work`)."""

    cells: torch.Tensor  # (N,) i64 cells each ray visits
    slots: torch.Tensor  # (N,) i64 non-null window slots each ray tests
    cells_touched: int  # distinct cells visited by any ray
    slots_touched: int  # distinct non-null slots tested by any ray


def grid_shoot_plain(
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: a vectorised lockstep DDA march.

    Every step gathers the active rays' cell meta, tests the window rows of
    the occupied cells through :func:`~.common.test_runs`, folds the hit
    keys into each ray's best with ``scatter_reduce(amin)``, then advances
    every active ray (masked DDA step, or distance-field jump) and drops the
    rays that left the grid or whose next cell starts beyond their best hit.
    The loop is bounded by ``nx + ny + nz + 3`` steps, as K1 is.
    """
    return _grid_march(rays, grid, kernel, min_t, top_index, False)[:2]


def grid_work(
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> GridWork:
    """The march of :func:`grid_shoot_plain`, replayed with counts: per ray
    the cells it visits (empty and jumped-from cells included) and the
    non-null window slots it tests (the triangle tests K1 must make; the
    null padding of a cell's last row is not counted), and the distinct
    cells and non-null window slots touched by the batch — what K1's bound
    is computed from (``benchmarks/bounds.py``)."""
    _, _, work = _grid_march(rays, grid, kernel, min_t, top_index, True)
    return work


def _grid_march(rays, grid, kernel, min_t, top_index, count):
    """(best_t, best_tri, GridWork or None): the plain march of K1."""
    check_kernel(kernel)
    check_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    dev, n = o.device, o.shape[0]
    hp = torch.tensor(grid.host_params, dtype=torch.float32, device=dev)
    gmin, gmax, vox, inv_vox = hp[0:3], hp[3:6], hp[6:9], hp[9:12]
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
    _, ny, nz = grid.dims
    inf = float("inf")
    if count:
        # Non-null slots of rows [0, r) and the rows a run starts and ends at.
        live = (grid.win_ids[..., 0] >= 0).sum(dim=1)
        live_before = torch.cat([live.new_zeros(1), torch.cumsum(live, 0)])
        cells = torch.zeros(n, dtype=torch.int64, device=dev)
        slots = torch.zeros(n, dtype=torch.int64, device=dev)
        cell_seen = torch.zeros(grid.n_cells, dtype=torch.bool, device=dev)
        row_edge = torch.zeros(grid.win_ids.shape[0] + 1, dtype=torch.int64, device=dev)

    # ---- grid entry (voxel.py:494-503).
    inside = ((o >= gmin) & (o <= gmax)).all(dim=-1)
    box_hit, t_near, _ = ray_aabb(o, d, gmin, gmax)
    entry = torch.clamp(t_near, min=0.0) + ENTRY_EPS * grid.char_step
    t0 = torch.where(inside, 0.0, torch.where(box_hit, entry, inf))
    best_key = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=dev)

    # ---- per-ray DDA constants of the rays that enter the grid.
    idx = torch.nonzero(torch.isfinite(t0)).squeeze(1)
    o, d, ex, t_enter = o[idx], d[idx], ex[idx], t0[idx]
    zero_d = d == 0
    inv_sd = 1.0 / torch.where(zero_d, 1.0, d)
    step = torch.sign(d).to(torch.int32)
    t_delta = torch.where(zero_d, inf, vox * torch.abs(inv_sd))
    min_delta = t_delta.amin(dim=-1)

    def boundary_t(cell):
        nxt = gmin + (cell + (d > 0)).to(torch.float32) * vox
        return torch.where(zero_d, inf, (nxt - o) * inv_sd)

    def locate(t):
        pos = o + t[:, None] * d
        return torch.floor((pos - gmin) * inv_vox).to(torch.int32)

    cell = torch.clamp(locate(t_enter), min=torch.zeros_like(dims), max=dims - 1)
    t_max = boundary_t(cell)

    for _ in range(sum(grid.dims) + 3):
        if idx.numel() == 0:
            break
        lin = ((cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]).long()
        meta = grid.cell_meta[lin]
        n_wins = (meta[:, 1].to(torch.int64) & 0xFFFFFFFF) >> 8  # logical shift
        dist = meta[:, 1] & 0xFF

        # ---- test the window rows of the occupied cells.
        occ = torch.nonzero(n_wins > 0).squeeze(1)
        if count:
            cells[idx] += 1
            cell_seen[lin] = True
            first = meta[occ, 0].to(torch.int64)
            last = first + n_wins[occ]
            slots[idx[occ]] += live_before[last] - live_before[first]
            row_edge.index_add_(0, first, torch.ones_like(first))
            row_edge.index_add_(0, last, -torch.ones_like(last))
        if occ.numel():
            keys = test_runs(
                grid.win_geom, grid.win_ids, meta[occ, 0], n_wins[occ],
                o[occ], d[occ], ex[occ], min_t, top_index, kernel,
            )
            best_key.scatter_reduce_(0, idx[occ], keys, reduce="amin")
        best_t, _ = key_to_hit(best_key[idx])

        # ---- advance: masked DDA step or distance-field jump (:641-676).
        t_exit = t_max.amin(dim=-1)
        jump = dist >= 2
        t_jump = t_exit + (dist.to(torch.float32) - 1.0) * min_delta
        t_land = t_jump + 1e-4 * min_delta
        adv = t_max <= t_exit[:, None]
        cell_s = cell + torch.where(adv, step, 0)
        t_max_s = t_max + torch.where(adv, t_delta, 0.0)
        new_cell = torch.where(jump[:, None], locate(t_land), cell_s)
        off = ((new_cell < 0) | (new_cell >= dims)).any(dim=-1)
        new_cell = torch.clamp(new_cell, min=torch.zeros_like(dims), max=dims - 1)
        t_max = torch.where(jump[:, None], boundary_t(new_cell), t_max_s)
        t_enter = torch.where(jump, t_jump, t_exit)
        keep = torch.nonzero(~off & (t_enter <= best_t)).squeeze(1)
        idx, o, d, ex, zero_d, inv_sd, step, t_delta, min_delta = (
            a[keep] for a in (idx, o, d, ex, zero_d, inv_sd, step, t_delta, min_delta)
        )
        cell, t_max, t_enter = new_cell[keep], t_max[keep], t_enter[keep]
    best_t, best_tri = key_to_hit(best_key)
    work = None
    if count:
        covered = torch.cumsum(row_edge, 0)[:-1] > 0
        work = GridWork(cells, slots, int(cell_seen.sum()), int(live[covered].sum()))
    return best_t, best_tri, work


def shoot_grid(
    scene: Scene,
    rays: Ray,
    grid: VoxelGrid,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> HitRecord:
    """Nearest-hit query through the grid: K1 then K2 (``finalize_hits``)."""
    with traversal_span("grid", rays):
        best_t, best_tri = grid_shoot(rays, grid, kernel, min_t, top_index)
    return finalize_hits(scene, rays, best_t, best_tri, kernel)
