"""Differentiable multi-bounce tracing and the energy histogram.

Counterpart of ``hare_tpu/trace/bounce.py`` (specular tracing and the hard
histogram).  The bounce loop is a Python loop: each bounce shoots (K1 + K2),
then the bounce step — reflect, the absorption gather, the energy product
and the coplanar second exclusion — runs as torch glue, so autograd sees
``energy * (1 - absorption[poly])``.  :func:`energy_histogram` is K3 (CUDA)
inside a ``torch.autograd.Function`` whose backward is plain indexing.

Scattering, per-bounce remat and the soft tent histogram are later ports:
asking for them raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..accel.common import check_device
from ..geom.math import dot, normalize
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..kernels import build
from ..mesh.scene import Scene

__all__ = [
    "SOUND_SPEED",
    "TraceResult",
    "energy_histogram",
    "histogram_plain",
    "reflect",
    "trace_rays",
]

SOUND_SPEED = 343.0  # m/s, for time binning
# Barycentric proximity below which a hit counts as "on an edge" for the
# second origin-exclusion slot (poly_origin2).
EDGE_EPS = 1e-4


def reflect(direction: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Specular reflection about ``normal`` (invariant to its sign)."""
    return direction - 2.0 * dot(direction, normal)[..., None] * normal


class TraceResult(NamedTuple):
    """Per-bounce trace record, all shaped ``(n_bounces, n_rays, ...)``."""

    hit: torch.Tensor  # (B, N) bool — ray was alive and hit at this bounce
    energy: torch.Tensor  # (B, N) energy AFTER this bounce's absorption
    time: torch.Tensor  # (B, N) cumulative path time at the hit (seconds)
    poly_id: torch.Tensor  # (B, N) i32
    point: torch.Tensor  # (B, N, 3)
    t: torch.Tensor  # (B, N) hit parameter of each bounce


def trace_rays(
    scene: Scene,
    rays: Ray,
    absorption: torch.Tensor,
    n_bounces: int,
    shoot_fn: Callable[..., HitRecord],
    aux=None,
    scattering: Optional[torch.Tensor] = None,
    sound_speed: float = SOUND_SPEED,
    remat: bool = False,
) -> TraceResult:
    """Trace ``rays`` for up to ``n_bounces`` specular reflections.

    Args:
      scene: compiled Scene.
      rays: ray batch ``(N,)``; directions need not be unit.
      absorption: ``(P,)`` per-polygon absorption in [0, 1] — gradients
        flow to it through the energy product.
      n_bounces: bounce count.
      shoot_fn: ``(scene, rays[, aux]) -> HitRecord`` (``SpatialPartition.
        shoot_fn``).
      aux: accel structure passed through to ``shoot_fn``.
      scattering, remat: not ported yet; raise when used.
    """
    if scattering is not None:
        raise NotImplementedError("scattering is not ported yet (specular only)")
    if remat:
        raise NotImplementedError("remat=True is not ported yet")
    o = rays.origin
    n = o.shape[0]
    direction = normalize(rays.direction)
    origin, exclude = o, rays.exclude_poly
    energy = torch.ones(n, dtype=o.dtype, device=o.device)
    dist = torch.zeros(n, dtype=o.dtype, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    outs = []
    for _ in range(n_bounces):
        r = Ray(origin, direction, exclude)
        hr = shoot_fn(scene, r) if aux is None else shoot_fn(scene, r, aux)
        live_hit = hr.hit & alive
        n_hat = normalize(hr.normal)
        pid = torch.clamp(hr.poly_id, min=0)
        # index_select, not absorption[pid]: its backward is one atomic
        # scatter-add, where advanced indexing's sorts the indices first.
        a = absorption.index_select(0, pid)
        new_energy = torch.where(live_hit, energy * (1.0 - a), energy)
        dist = dist + torch.where(live_hit, hr.t, 0.0)
        outs.append((
            live_hit,
            torch.where(live_hit, new_energy, 0.0),
            dist / sound_speed,
            torch.where(live_hit, hr.poly_id, NO_POLY),
            hr.point,
            torch.where(live_hit, hr.t, float("inf")),
        ))

        # Second exclusion slot (poly_origin2, Spatial_Partition.cs:33): a
        # reflection point on an edge shared with a COPLANAR polygon also
        # excludes that polygon.  Edge k joins corners (k, k+1); its
        # barycentric distance is the weight of the opposite corner.
        nbr = hr.edge_nbr
        w_b = 1.0 - hr.u - hr.v
        b0, b1, b2 = hr.v, w_b, hr.u
        n01 = torch.where(b0 <= b1, nbr[:, 0], nbr[:, 1])
        d01 = torch.minimum(b0, b1)
        nb = torch.where(d01 <= b2, n01, nbr[:, 2])
        on_edge = torch.minimum(d01, b2) < EDGE_EPS
        ex2 = torch.where(live_hit & on_edge & (nb >= 0), nb, NO_POLY)
        exclude = torch.stack(
            [torch.where(live_hit, hr.poly_id, NO_POLY), ex2], dim=-1
        )
        origin = torch.where(live_hit[:, None], hr.point, origin)
        direction = torch.where(live_hit[:, None], reflect(direction, n_hat), direction)
        energy, alive = new_energy, live_hit
    return TraceResult(*(torch.stack(x) for x in zip(*outs)))


def _bins(time: torch.Tensor, n_bins: int, bin_dt: float) -> torch.Tensor:
    """clip(int(time / bin_dt), 0, n_bins - 1), as K3 computes it.

    Clamping before the truncating conversion gives the same bin and keeps
    the conversion in range; the divisor is a tensor, not a scalar, so the
    division is a true one on every device (as in K3), never a multiply by
    a rounded reciprocal.
    """
    q = time / torch.full((1,), bin_dt, dtype=time.dtype, device=time.device)
    return torch.clamp(q, 0.0, float(n_bins - 1)).to(torch.int64)


def histogram_plain(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, n_bins: int,
    bin_dt: float,
) -> torch.Tensor:
    """Plain version of K3: ``index_add_`` with dead lanes dropped."""
    bins = torch.where(hit, _bins(time, n_bins, bin_dt), n_bins).reshape(-1)
    hist = torch.zeros(n_bins + 1, dtype=energy.dtype, device=energy.device)
    return hist.index_add_(0, bins, energy.reshape(-1))[:n_bins]


def histogram_kernel(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, n_bins: int,
    bin_dt: float,
) -> torch.Tensor:
    """K3 forward on CUDA tensors (``kernels/csrc/energy_histogram.cu``)."""
    if energy.dtype != torch.float32 or time.dtype != torch.float32:
        raise TypeError("energy and time must be float32")
    if hit.dtype != torch.bool:
        raise TypeError("hit must be bool")
    if not energy.shape == time.shape == hit.shape:
        raise ValueError("energy, time and hit must share one shape")
    hist = torch.zeros(n_bins, dtype=torch.float32, device=energy.device)
    energy_histogram.launches += 1
    build.launch(
        "hare_energy_histogram", energy.contiguous(), time.contiguous(),
        hit.contiguous(), energy.numel(), n_bins, bin_dt, hist,
    )
    return hist


class _HardHistogram(torch.autograd.Function):
    """hist[bin(time)] += energy over hit lanes; d/d(energy) is the bin's
    incoming gradient on hit lanes and 0 elsewhere."""

    @staticmethod
    def forward(ctx, energy, time, hit, n_bins, bin_dt):
        ctx.save_for_backward(time, hit)
        ctx.n_bins, ctx.bin_dt = n_bins, bin_dt
        if check_device(energy, time, hit) == "cpu":
            return histogram_plain(energy, time, hit, n_bins, bin_dt)
        return histogram_kernel(energy, time, hit, n_bins, bin_dt)

    @staticmethod
    def backward(ctx, grad_hist):
        time, hit = ctx.saved_tensors
        g = grad_hist[_bins(time, ctx.n_bins, ctx.bin_dt)]
        return torch.where(hit, g, 0.0), None, None, None, None


def energy_histogram(
    result: TraceResult, n_bins: int, bin_dt: float = 1e-3, soft: bool = False
) -> torch.Tensor:
    """Time-binned impulse-response energy histogram, ``(n_bins,)``.

    Every bounce's post-absorption energy goes to bin
    ``clip(int(time / bin_dt), 0, n_bins - 1)``; energies beyond the window
    land in the last bin, so totals are conserved.  K3 on CUDA tensors, its
    plain version on CPU tensors; differentiable in the energies.
    """
    if soft:
        raise NotImplementedError("soft=True (tent binning) is not ported yet")
    return _HardHistogram.apply(result.energy, result.time, result.hit, n_bins, bin_dt)


energy_histogram.launches = 0
