"""Differentiable multi-bounce tracing and the energy histogram.

Counterpart of ``hare_tpu/trace/bounce.py`` (specular tracing, the hard and
the soft histogram).  The bounce loop is a Python loop: each bounce shoots
(a traversal + K2), then the bounce step — reflect, the absorption gather,
the energy product and the coplanar second exclusion — runs as torch glue,
so autograd sees ``energy * (1 - absorption[poly])``; the gather's backward
is the fixed-order scatter (``accel.scatter``), and the hit record's is A3
(``accel.common.finalize_hits``), so gradients w.r.t. absorption, vertices
and rays are bitwise-repeatable.  :func:`energy_histogram` is K3 (CUDA,
deterministic) inside ``torch.autograd.Function``s: the hard one's backward
is plain indexing, the soft one's the soft backward kernel.

Scattering and per-bounce remat are later ports: asking for them raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..accel.common import check_device
from ..accel.scatter import gather_rows
from ..geom.math import dot, normalize
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..kernels import build
from ..mesh.scene import Scene

__all__ = [
    "SOUND_SPEED",
    "TraceResult",
    "energy_histogram",
    "histogram_kernel",
    "histogram_plain",
    "reflect",
    "soft_histogram_bwd",
    "soft_histogram_bwd_plain",
    "soft_histogram_plain",
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
        flow to it through the energy product.  Gradients w.r.t. the scene's
        vertices (``scene.with_vertices``) and the rays flow through each
        bounce's hit record.
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
        a = gather_rows(absorption, pid)
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
    """Plain version of K3, hard bins: ``index_add_`` with dead lanes
    dropped."""
    bins = torch.where(hit, _bins(time, n_bins, bin_dt), n_bins).reshape(-1)
    hist = torch.zeros(n_bins + 1, dtype=energy.dtype, device=energy.device)
    return hist.index_add_(0, bins, energy.reshape(-1))[:n_bins]


def soft_histogram_plain(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, n_bins: int,
    bin_dt: float,
) -> torch.Tensor:
    """Plain version of K3, soft bins (``bounce.py:280-293``): each energy
    split between the two bins whose centres bracket ``time / bin_dt``, in
    proportion to proximity, the edge halves clamped into the end bins; one
    ``index_add_`` over the low and high halves, as the JAX package's one
    ``segment_sum``.  Differentiable in energy and time: ``frac`` is
    ``min(max(x, 0), 1)``, the JAX package's clip, whose gradient is 1/2 at
    either bound (a time at a bin centre), where ``torch.clamp``'s is 1."""
    dt = torch.full((1,), bin_dt, dtype=time.dtype, device=time.device)
    pos = time / dt - 0.5  # bin i's centre at (i + 0.5) bin_dt
    i0 = torch.clamp(torch.floor(pos.detach()), -1.0, float(n_bins - 1))
    zero, one = pos.new_zeros(()), pos.new_ones(())
    frac = torch.minimum(torch.maximum(pos - i0, zero), one)
    i0 = i0.to(torch.int64)
    b_lo = torch.where(hit, torch.clamp(i0, min=0), n_bins)
    b_hi = torch.where(hit, torch.clamp(i0 + 1, max=n_bins - 1), n_bins)
    e_hi = energy * frac
    e_lo = energy - e_hi
    hist = torch.zeros(n_bins + 1, dtype=energy.dtype, device=energy.device)
    return hist.index_add(
        0, torch.cat([b_lo.reshape(-1), b_hi.reshape(-1)]),
        torch.cat([e_lo.reshape(-1), e_hi.reshape(-1)]),
    )[:n_bins]


# K3's most blocks (energy_histogram.cu's kMaxBlocks): its scratch holds one
# row of bins for each; the kernel checks that the rows suffice.
HIST_MAX_BLOCKS = 264


def _check_lanes(energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor) -> None:
    if energy.dtype != torch.float32 or time.dtype != torch.float32:
        raise TypeError("energy and time must be float32")
    if hit.dtype != torch.bool:
        raise TypeError("hit must be bool")
    if not energy.shape == time.shape == hit.shape:
        raise ValueError("energy, time and hit must share one shape")


def histogram_kernel(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, n_bins: int,
    bin_dt: float, soft: bool = False,
) -> torch.Tensor:
    """K3 forward on CUDA tensors (``kernels/csrc/energy_histogram.cu``),
    hard or soft bins, summed in an order fixed by the lane count."""
    _check_lanes(energy, time, hit)
    n = energy.numel()
    partials = torch.empty(max(HIST_MAX_BLOCKS * n_bins, 1), dtype=torch.float32,
                           device=energy.device)
    hist = torch.empty(n_bins, dtype=torch.float32, device=energy.device)
    energy_histogram.launches += 1
    build.launch(
        "hare_energy_histogram", energy.contiguous(), time.contiguous(),
        hit.contiguous(), n, n_bins, bin_dt, int(soft), partials, partials.numel(), hist,
    )
    return hist


def soft_histogram_bwd_plain(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor,
    n_bins: int, bin_dt: float,
):
    """Plain version of the soft backward: autograd through
    :func:`soft_histogram_plain`.  Returns ``(d_energy, d_time)``."""
    with torch.enable_grad():
        e = energy.detach().requires_grad_()
        t = time.detach().requires_grad_()
        hist = soft_histogram_plain(e, t, hit, n_bins, bin_dt)
        return torch.autograd.grad(hist, (e, t), grad_hist)


def soft_histogram_bwd(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor,
    n_bins: int, bin_dt: float,
):
    """The soft histogram's backward, ``(d_energy, d_time)`` shaped like
    ``energy``.  CUDA tensors launch ``kernels/csrc/energy_histogram.cu``'s
    soft backward; CPU tensors take :func:`soft_histogram_bwd_plain`."""
    if check_device(energy, time, hit, grad_hist) == "cpu":
        return soft_histogram_bwd_plain(energy, time, hit, grad_hist, n_bins, bin_dt)
    _check_lanes(energy, time, hit)
    if grad_hist.shape != (n_bins,) or grad_hist.dtype != torch.float32:
        raise ValueError("grad_hist must be (n_bins,) float32")
    d_energy = torch.empty(energy.shape, dtype=torch.float32, device=energy.device)
    d_time = torch.empty(energy.shape, dtype=torch.float32, device=energy.device)
    soft_histogram_bwd.launches += 1
    build.launch(
        "hare_soft_histogram_bwd", energy.contiguous(), time.contiguous(), hit.contiguous(),
        grad_hist.contiguous(), energy.numel(), n_bins, bin_dt, d_energy, d_time,
    )
    return d_energy, d_time


soft_histogram_bwd.launches = 0


class _HardHistogram(torch.autograd.Function):
    """hist[bin(time)] += energy over hit lanes; d/d(energy) is the bin's
    incoming gradient on hit lanes and 0 elsewhere; d/d(time) is 0."""

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


class _SoftHistogram(torch.autograd.Function):
    """The tent histogram; its backward gives d/d(energy) and d/d(time)
    (:func:`soft_histogram_bwd`)."""

    @staticmethod
    def forward(ctx, energy, time, hit, n_bins, bin_dt):
        ctx.save_for_backward(energy, time, hit)
        ctx.n_bins, ctx.bin_dt = n_bins, bin_dt
        if check_device(energy, time, hit) == "cpu":
            return soft_histogram_plain(energy, time, hit, n_bins, bin_dt)
        return histogram_kernel(energy, time, hit, n_bins, bin_dt, soft=True)

    @staticmethod
    def backward(ctx, grad_hist):
        energy, time, hit = ctx.saved_tensors
        d_energy, d_time = soft_histogram_bwd(energy, time, hit, grad_hist, ctx.n_bins,
                                              ctx.bin_dt)
        return d_energy, d_time, None, None, None


def energy_histogram(
    result: TraceResult, n_bins: int, bin_dt: float = 1e-3, soft: bool = False
) -> torch.Tensor:
    """Time-binned impulse-response energy histogram, ``(n_bins,)``.

    Hard (default): every bounce's post-absorption energy goes to bin
    ``clip(int(time / bin_dt), 0, n_bins - 1)``; energies beyond the window
    land in the last bin, so totals are conserved; differentiable in the
    energies.  ``soft=True``: tent binning (:func:`soft_histogram_plain`),
    which also conserves totals and is differentiable in the arrival times
    too, hence in the vertex positions — what vertex fitting descends on.
    K3 on CUDA tensors, its plain version on CPU tensors.
    """
    fn = _SoftHistogram if soft else _HardHistogram
    return fn.apply(result.energy, result.time, result.hit, n_bins, bin_dt)


energy_histogram.launches = 0
