"""The flagship workload and the ray-parallel dry run, on the port.

Counterpart of ``__graft_entry__.py`` (the JAX package's two functions of
the same names):

- :func:`entry` builds the forward pass of the main path on the concert
  hall: ``concert_hall()`` (1,608 triangles) on a voxel grid with
  ``avg_polys=12.0``, 1,024 rays from a seeded NumPy draw, 4 bounces at
  absorption 0.2, reduced to a 512-bin impulse-response histogram of 1 ms
  bins.  It returns ``(forward, args)``, with the scene and structure as
  arguments, as the JAX function returns them for ``jit``.
- :func:`dryrun_multichip` runs one full ray-parallel training step (a
  target from :func:`~.dist.sharded_histogram`, then one
  :func:`~.dist.make_train_step` Adam step from zeros) on the 4 x 5 x 3
  shoebox, 16 rays a rank.  The JAX function builds its device mesh with
  ``make_ray_mesh(n_devices)``; here a ``torch.distributed`` process group
  takes the mesh's place (``hare_tpu_torch.dist``), so the port has no
  ``make_ray_mesh``: the caller joins a group (``dist.init_distributed``)
  and passes it, or leaves ``group`` as the default group.

Both place their tensors on ``device``, the card unless the caller asks
for another.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import dist as hd
from .accel.partition import SpatialPartition
from .geom.primitives import Ray
from .mesh import shapes
from .mesh.topology import Topology
from .trace.bounce import TraceResult, energy_histogram, trace_rays
from .trace.sampler import uniform_sphere

__all__ = ["DryRun", "compare_traces", "dryrun_multichip", "dryrun_reference", "dryrun_setup",
           "entry", "entry_rays"]

# The forward workload (``__graft_entry__.py:17-35``).
N_RAYS, N_BOUNCES, N_BINS, BIN_DT, ABSORPTION, AVG_POLYS = 1024, 4, 512, 1e-3, 0.2, 12.0
# Ray origins are drawn uniform in this box, inside the hall.
ORIGIN_LO, ORIGIN_HI = (2, 2, 1), (28, 48, 16)
# The dry run (``__graft_entry__.py:53-70``): rays a rank, their source,
# bounces, bins, the target's absorption and Adam's step size.
DRY_RAYS, DRY_SOURCE, DRY_BOUNCES, DRY_BINS = 16, (2.0, 2.5, 1.5), 3, 64
DRY_ABSORPTION, DRY_LR = 0.3, 0.05
# compare_traces: energies and times of rays on one path within RTOL and
# ATOL; t and hit points within RTOL of themselves or RTOL of the scene's
# extent (a hit point rounds at the ulps of its coordinates, and so does
# the next bounce's origin).  Two paths may part only where the geometry
# ties: both hit with t within TIE_T * max(1, t) and points within
# TIE_POINT, or one re-hits, at t <= TIE_POINT, a polygon coincident with
# the one it left.  At most MAX_PARTED of the rays part.
RTOL = ATOL = 1e-5
TIE_T, TIE_POINT, MAX_PARTED = 1e-5, 1e-4, 0.01


def entry_rays():
    """The forward workload's rays as NumPy float32 ``(origins,
    directions)``, each ``(N_RAYS, 3)``: origins uniform in the box
    ``ORIGIN_LO``-``ORIGIN_HI``, directions normalised normal draws, both
    from ``np.random.default_rng(0)`` in that order, in float64 and then
    rounded, as ``__graft_entry__.py:26-33`` draws them."""
    rng = np.random.default_rng(0)
    o = rng.uniform(ORIGIN_LO, ORIGIN_HI, (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def entry(device="cuda"):
    """``(forward, args)``: the main path's forward step on the concert hall.

    ``forward(scene, aux, origins, directions, absorption)`` traces the
    rays ``N_BOUNCES`` bounces through the grid (``trace_rays``) and returns
    their ``energy_histogram`` (``N_BINS`` bins of ``BIN_DT``); ``args`` are
    the grid partition's scene and structure, :func:`entry_rays`' rays and
    absorption ``ABSORPTION`` on every polygon, all on ``device``.
    ``forward.trace`` is the same trace without the histogram, and
    ``forward.partition`` the ``SpatialPartition``.
    """
    top = Topology.build(shapes.concert_hall())
    sp = SpatialPartition(top, accel="grid", avg_polys=AVG_POLYS, device=device)
    shoot_fn = sp.shoot_fn

    def trace(scene, aux, origins, directions, absorption) -> TraceResult:
        return trace_rays(scene, Ray.make(origins, directions), absorption, N_BOUNCES, shoot_fn,
                          aux=aux)

    def forward(scene, aux, origins, directions, absorption) -> torch.Tensor:
        res = trace(scene, aux, origins, directions, absorption)
        return energy_histogram(res, n_bins=N_BINS, bin_dt=BIN_DT)

    forward.trace, forward.partition = trace, sp
    o, d = (torch.from_numpy(x).to(device) for x in entry_rays())
    a = torch.full((top.n_polys,), ABSORPTION, dtype=torch.float32, device=device)
    return forward, (sp.scene, sp.aux, o, d, a)


def dryrun_setup(n_rays: int, device="cuda", directions: Optional[torch.Tensor] = None):
    """The dry run's ``(topology, partition, rays)``: the shoebox on a grid
    of ``domain=4``, ``n_rays`` rays from ``DRY_SOURCE`` with ``directions``,
    or unit directions drawn by ``uniform_sphere`` from a generator seeded
    with 0 where none are given."""
    top = Topology.build(shapes.shoebox(4, 5, 3))
    sp = SpatialPartition(top, accel="grid", domain=4, device=device)
    if directions is None:
        directions = uniform_sphere(n_rays, torch.Generator().manual_seed(0), device=device)
    if directions.shape != (n_rays, 3):
        raise ValueError(f"directions of shape {tuple(directions.shape)}, not ({n_rays}, 3)")
    origins = torch.tensor(DRY_SOURCE, dtype=torch.float32, device=device).expand(n_rays, 3)
    return top, sp, Ray.make(origins.contiguous(), directions.to(device))


class DryRun(NamedTuple):
    """What :func:`dryrun_multichip` computed: the target histogram, the
    step's loss and the absorption parameters after the step."""

    target: torch.Tensor
    loss: torch.Tensor
    absorption: torch.Tensor


def dryrun_multichip(group=None, device="cuda",
                     directions: Optional[torch.Tensor] = None) -> DryRun:
    """One full ray-parallel training step over ``group`` (the default
    process group where None), ``__graft_entry__.py:39-77``.

    ``DRY_RAYS`` rays a rank (:func:`dryrun_setup`; ``directions`` for all
    of them, else drawn from seed 0) trace their blocks; the target is the
    ``sharded_histogram`` (``DRY_BOUNCES`` bounces, ``DRY_BINS`` bins) at
    absorption ``DRY_ABSORPTION``; then one ``make_train_step`` step with
    ``torch.optim.Adam(lr=DRY_LR)`` from raw absorption zeros.  Raises
    ``FloatingPointError`` where the loss or the parameters are not finite.
    """
    n_rays = DRY_RAYS * torch.distributed.get_world_size(group)
    top, sp, rays = dryrun_setup(n_rays, device, directions)
    a_true = torch.full((top.n_polys,), DRY_ABSORPTION, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = hd.sharded_histogram(sp.shoot_fn, DRY_BOUNCES, DRY_BINS, group=group)(
            sp.scene, rays, a_true, sp.aux)
    params = {"absorption": torch.zeros(top.n_polys, device=device, requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=DRY_LR)
    step = hd.make_train_step(sp.shoot_fn, opt, DRY_BOUNCES, DRY_BINS, group=group)
    loss = step(params, sp.scene, rays, target, sp.aux)
    absorption = params["absorption"].detach()
    if not (bool(torch.isfinite(loss)) and bool(torch.isfinite(absorption).all())):
        raise FloatingPointError(f"the dry run's step is not finite: loss {float(loss)}")
    return DryRun(target, loss, absorption)


def dryrun_reference(n_rays: int = DRY_RAYS, device="cuda",
                     directions: Optional[torch.Tensor] = None) -> DryRun:
    """The dry run's target and step on ``n_rays`` rays in one process,
    without a process group: ``trace_rays`` and ``energy_histogram`` for the
    target, then the loss ``sum((hist - target)^2) / DRY_BINS`` of the
    histogram at ``sigmoid`` of the raw absorption, ``backward`` and one
    Adam step from zeros.  On one rank :func:`dryrun_multichip` computes
    the same bits."""
    top, sp, rays = dryrun_setup(n_rays, device, directions)
    a_true = torch.full((top.n_polys,), DRY_ABSORPTION, dtype=torch.float32, device=device)
    with torch.no_grad():
        target = energy_histogram(trace_rays(sp.scene, rays, a_true, DRY_BOUNCES, sp.shoot_fn,
                                             aux=sp.aux), DRY_BINS)
    p = torch.zeros(top.n_polys, device=device, requires_grad=True)
    opt = torch.optim.Adam([p], lr=DRY_LR)
    res = trace_rays(sp.scene, rays, torch.sigmoid(p), DRY_BOUNCES, sp.shoot_fn, aux=sp.aux)
    loss = torch.sum((energy_histogram(res, DRY_BINS) - target) ** 2) / DRY_BINS
    loss.backward()
    opt.step()
    return DryRun(target, loss.detach(), p.detach())


def compare_traces(res: TraceResult, ref: TraceResult, extent: float) -> dict:
    """Hold one trace of a batch against another of the same rays, ray by
    ray, both on the CPU (``extent``: the scene's largest extent).

    A ray's paths part at the first bounce whose hit or polygon differs.
    Where the scene has coincident polygons (the hall's stage and floor) an
    ulp of rounding decides an equal-``t`` tie, or puts a hit point on the
    other side of a shared plane, and the paths part there.  So: on rays
    that never part, hits and polygons are equal on every bounce, t and
    points agree within ``RTOL`` or ``RTOL * extent``, energies and times
    within ``RTOL`` / ``ATOL``; each parted ray parts at a tie (both hit, t
    within ``TIE_T * max(1, t)``, points within ``TIE_POINT``) or at a hop
    of ``t <= TIE_POINT`` from the previous hit point onto a coincident
    polygon, on either side; at most ``MAX_PARTED`` of the rays part.
    Raises ``AssertionError`` otherwise.  Returns ``{"parted": ray ids,
    "bounce": each one's first differing bounce (1-based), "kind": "tie"
    or "hop", "same": (N,) bool mask of the rays that never part}``.
    """
    differ = (res.hit != ref.hit) | (res.poly_id != ref.poly_id)  # (B, N)
    parted = differ.any(0)
    first = differ.int().argmax(0)
    n = res.hit.shape[1]
    ids = torch.nonzero(parted).squeeze(1).tolist()
    if len(ids) > MAX_PARTED * n:
        raise AssertionError(f"{len(ids)} of {n} rays take other paths: {ids}")
    same = ~parted
    hit = ref.hit[:, same]
    for what in ("t", "point", "energy", "time"):
        x, y = getattr(res, what)[:, same], getattr(ref, what)[:, same]
        atol = ATOL
        if what in ("t", "point"):  # defined on hit lanes only
            x, y, atol = x[hit], y[hit], RTOL * extent
        bad = (x - y).abs() > atol + RTOL * y.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what} differs on rays that keep one path: max |diff| "
                                 f"{float((x - y).abs().max()):.3e}")
    kinds = []
    for i in ids:
        b = int(first[i])
        where = f"ray {i} bounce {b + 1}"
        if not (bool(res.hit[b, i]) and bool(ref.hit[b, i])):
            raise AssertionError(f"{where}: one trace hits, the other misses")
        t, t_ref = float(res.t[b, i]), float(ref.t[b, i])
        p, p_ref = res.point[b, i], ref.point[b, i]
        if abs(t - t_ref) <= TIE_T * max(1.0, abs(t_ref)) and float(
                (p - p_ref).abs().max()) <= TIE_POINT:
            kinds.append("tie")
            continue
        if not any(b > 0 and float(tr.t[b, i]) <= TIE_POINT and float(
                (tr.point[b, i] - tr.point[b - 1, i]).abs().max()) <= TIE_POINT
                for tr in (res, ref)):
            raise AssertionError(f"{where}: parts at neither a tie nor a hop onto a coincident "
                                 f"polygon (t {t} against {t_ref})")
        kinds.append("hop")
    return {"parted": ids, "bounce": [int(first[i]) + 1 for i in ids], "kind": kinds,
            "same": same}
