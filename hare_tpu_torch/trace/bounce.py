"""Differentiable multi-bounce tracing and the energy histogram.

Counterpart of ``hare_tpu/trace/bounce.py`` (specular and scattering
tracing, per-bounce remat, the hard and the soft histogram).  The bounce
loop is a Python loop: each bounce shoots (a traversal + K2), then
:func:`bounce_step` — reflect, the absorption gather, the energy product,
the scattering coin and lobe, and the coplanar second exclusion — runs as
torch glue, so autograd sees ``energy * (1 - absorption[poly])``; the
gathers' backward is the fixed-order scatter (``accel.scatter``), and the
hit record's is A3 (``accel.common.finalize_hits``), so gradients w.r.t.
absorption, scattering, vertices and rays are bitwise-repeatable.
:func:`energy_histogram` is K3 (CUDA, deterministic) inside
``torch.autograd.Function``s, whose backwards, hard and soft, are K3's
backward kernel.

Scattering follows the JAX package's estimator: a fair coin, independent of
the scattering coefficient ``s``, picks the cosine lobe or the specular
direction, and the energy is reweighted by ``2 s`` or ``2 (1 - s)``, so the
estimate is unbiased and pathwise differentiable in ``s``.  Every bounce's
coin and lobe uniforms are drawn before the loop (:func:`scatter_draws`),
as JAX splits its key before its scan: the draws are then inputs of each
bounce, which is what lets ``remat`` recompute a bounce exactly
(``torch.utils.checkpoint`` restores the default generators' states, not an
explicit ``torch.Generator``'s).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..accel.common import check_device
from ..accel.scatter import gather_rows
from ..geom.math import dot, normalize
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..kernels import build
from ..mesh.scene import Scene

__all__ = [
    "SOUND_SPEED",
    "BounceState",
    "TraceResult",
    "bounce_step",
    "cosine_lobe",
    "energy_histogram",
    "hard_histogram_bwd",
    "hard_histogram_bwd_plain",
    "histogram_kernel",
    "histogram_plain",
    "reflect",
    "scatter_draws",
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


def cosine_lobe(
    normal: torch.Tensor, incoming: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor
) -> torch.Tensor:
    """Cosine-weighted hemisphere sample about ``normal`` from the uniforms
    ``r1``, ``r2`` (``hare_tpu/trace/bounce.py:60-90``, which draws them from
    its key).  ``normal`` need not have a consistent sign: it is oriented
    against ``incoming``, the reflection side (Lambert's law)."""
    n = normal * -torch.sign(dot(incoming, normal))[..., None]
    cz = torch.sqrt(r1)  # cos(theta) ~ sqrt(u): pdf = cos / pi
    rr = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    phi = 2.0 * math.pi * r2
    # Orthonormal tangent frame (branchless Duff et al. construction).
    nz = n[..., 2]
    sg = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sg + nz)
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + sg * n[..., 0] ** 2 * a, sg * b, -sg * n[..., 0]], dim=-1)
    t2 = torch.stack([b, sg + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return (
        (rr * torch.cos(phi))[..., None] * t1
        + (rr * torch.sin(phi))[..., None] * t2
        + cz[..., None] * n
    )


class TraceResult(NamedTuple):
    """Per-bounce trace record, all shaped ``(n_bounces, n_rays, ...)``."""

    hit: torch.Tensor  # (B, N) bool — ray was alive and hit at this bounce
    energy: torch.Tensor  # (B, N) energy AFTER this bounce's absorption
    time: torch.Tensor  # (B, N) cumulative path time at the hit (seconds)
    poly_id: torch.Tensor  # (B, N) i32
    point: torch.Tensor  # (B, N, 3)
    t: torch.Tensor  # (B, N) hit parameter of each bounce


class BounceState(NamedTuple):
    """What one bounce carries to the next, all ``(N, ...)``."""

    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3) unit
    exclude: torch.Tensor  # (N, 2) i32
    energy: torch.Tensor  # (N,)
    dist: torch.Tensor  # (N,) path length so far
    alive: torch.Tensor  # (N,) bool


def scatter_draws(
    generator: torch.Generator, n_bounces: int, n: int, dtype: torch.dtype, device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every bounce's scattering draws for ``n`` rays: ``(diffuse, r1, r2)``,
    each ``(n_bounces, n)`` — the fair coin (``u < 0.5``, drawn for every
    ray, dead or alive, as the JAX package's ``bernoulli(kb, 0.5, (n,))``)
    and :func:`cosine_lobe`'s two uniforms.

    The numbers are drawn ray-major, ``(n, n_bounces, 3)``, on the
    generator's device and then moved to ``device``: a generator on the CPU
    draws in sequence, so the first ``m`` rays of a batch get the draws a
    batch of ``m`` rays gets from the same seed."""
    u = torch.rand((n, n_bounces, 3), generator=generator, device=generator.device, dtype=dtype)
    u = u.to(device).permute(1, 2, 0).contiguous()
    return u[:, 0] < 0.5, u[:, 1], u[:, 2]


def bounce_step(
    state: BounceState,
    hr: HitRecord,
    absorption: torch.Tensor,
    scattering: Optional[torch.Tensor] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    sound_speed: float = SOUND_SPEED,
):
    """One bounce after its shoot (``hare_tpu/trace/bounce.py:175-247``):
    the hit record ``hr`` (``edge_nbr`` filled) applied to ``state``.

    ``scattering`` (``(P,)``) with this bounce's ``draws`` ``(diffuse, r1,
    r2)``, each ``(N,)``, takes the diffuse branch; without them the step
    is specular.  Returns the next state and the bounce's six outputs, the
    fields of :class:`TraceResult` for this bounce.
    """
    live_hit = hr.hit & state.alive
    n_hat = normalize(hr.normal)
    pid = torch.clamp(hr.poly_id, min=0)
    a = gather_rows(absorption, pid)
    energy = state.energy * (1.0 - a)
    new_dir = reflect(state.direction, n_hat)
    if scattering is not None:
        diffuse, r1, r2 = draws
        sc = gather_rows(scattering, pid)
        energy = energy * torch.where(diffuse, 2.0 * sc, 2.0 * (1.0 - sc))
        lobe = cosine_lobe(n_hat, state.direction, r1, r2)
        new_dir = torch.where(diffuse[:, None], lobe, new_dir)
    energy = torch.where(live_hit, energy, state.energy)
    dist = state.dist + torch.where(live_hit, hr.t, 0.0)
    outs = (
        live_hit,
        torch.where(live_hit, energy, 0.0),
        dist / sound_speed,
        torch.where(live_hit, hr.poly_id, NO_POLY),
        hr.point,
        torch.where(live_hit, hr.t, float("inf")),
    )

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
    nxt = BounceState(
        origin=torch.where(live_hit[:, None], hr.point, state.origin),
        direction=torch.where(live_hit[:, None], new_dir, state.direction),
        exclude=torch.stack([torch.where(live_hit, hr.poly_id, NO_POLY), ex2], dim=-1),
        energy=energy,
        dist=dist,
        alive=live_hit,
    )
    return nxt, outs


def trace_rays(
    scene: Scene,
    rays: Ray,
    absorption: torch.Tensor,
    n_bounces: int,
    shoot_fn: Callable[..., HitRecord],
    aux=None,
    scattering: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    sound_speed: float = SOUND_SPEED,
    remat: bool = False,
) -> TraceResult:
    """Trace ``rays`` for up to ``n_bounces`` reflections.

    Args:
      scene: compiled Scene.
      rays: ray batch ``(N,)``; directions need not be unit.
      absorption: ``(P,)`` per-polygon absorption in [0, 1] — gradients
        flow to it through the energy product.  Gradients w.r.t. the scene's
        vertices (``scene.with_vertices``) and the rays flow through each
        bounce's hit record.
      n_bounces: bounce count.
      shoot_fn: ``(scene, rays[, aux]) -> HitRecord`` (``SpatialPartition.
        shoot_fn``).  A record without ``edge_nbr`` takes the hit triangle's
        coplanar neighbours from ``scene.tri_meta``.
      aux: accel structure passed through to ``shoot_fn``.
      scattering: optional ``(P,)`` per-polygon scattering coefficients in
        [0, 1]: at each hit a fair coin picks the cosine lobe or the
        specular direction, the energy reweighted ``2 s`` / ``2 (1 - s)``
        (module docstring); differentiable in ``scattering``.
      generator: the ``torch.Generator`` the scattering draws come from
        (:func:`scatter_draws`); required with ``scattering``.  One seed
        gives a bitwise-identical trace.
      remat: recompute each bounce, its shoot included, in the backward
        (``torch.utils.checkpoint``).  Each bounce's input state is kept
        and its activations are recomputed one bounce at a time, so the
        peak falls only where the backward would otherwise save more a
        bounce than that state, as the geometry of a loss w.r.t. the
        vertices; w.r.t. the absorption alone it can rise.  Values and
        gradients are unchanged.
    """
    if scattering is not None and generator is None:
        raise ValueError("scattering requires a torch.Generator (generator=)")
    o = rays.origin
    n = o.shape[0]
    state = BounceState(
        origin=o,
        direction=normalize(rays.direction),
        exclude=rays.exclude_poly,
        energy=torch.ones(n, dtype=o.dtype, device=o.device),
        dist=torch.zeros(n, dtype=o.dtype, device=o.device),
        alive=torch.ones(n, dtype=torch.bool, device=o.device),
    )
    draws = None
    if scattering is not None:
        draws = scatter_draws(generator, n_bounces, n, o.dtype, o.device)

    def bounce(state, draws_b):
        r = Ray(state.origin, state.direction, state.exclude)
        hr = shoot_fn(scene, r) if aux is None else shoot_fn(scene, r, aux)
        if hr.edge_nbr is None:
            tri = torch.clamp(hr.tri_id, min=0).long()
            hr = hr._replace(edge_nbr=scene.tri_meta[tri, 1:4])
        return bounce_step(state, hr, absorption, scattering, draws_b, sound_speed)

    outs = []
    for b in range(n_bounces):
        draws_b = None if draws is None else tuple(x[b] for x in draws)
        if remat and torch.is_grad_enabled():
            # The draws are inputs, never drawn inside: the recompute sees
            # the forward's numbers without restoring any generator.
            state, out = checkpoint(bounce, state, draws_b, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            state, out = bounce(state, draws_b)
        outs.append(out)
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


# energy_histogram.cu's layout, which sizes K3's scratch (the kernel checks
# that it suffices): a row of bins for each of at most HIST_MAX_BLOCKS
# blocks along the lanes (its kMaxBlocks), bins in tiles of HIST_TILE
# (kTile).
HIST_MAX_BLOCKS, HIST_TILE = 528, 1024


def _check_lanes(energy: Optional[torch.Tensor], time: torch.Tensor, hit: torch.Tensor) -> None:
    """The lanes as K3 reads them; ``energy`` None where it is not read."""
    floats = (time,) if energy is None else (energy, time)
    if any(x.dtype != torch.float32 for x in floats):
        raise TypeError("energy and time must be float32")
    if hit.dtype != torch.bool:
        raise TypeError("hit must be bool")
    if any(x.shape != hit.shape for x in floats):
        raise ValueError("energy, time and hit must share one shape")


def histogram_kernel(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, n_bins: int,
    bin_dt: float, soft: bool = False,
) -> torch.Tensor:
    """K3 forward on CUDA tensors (``kernels/csrc/energy_histogram.cu``),
    hard or soft bins, summed in an order fixed by the lane count."""
    _check_lanes(energy, time, hit)
    n = energy.numel()
    tiles = -(-n_bins // HIST_TILE)
    partials = torch.empty(max(tiles * HIST_MAX_BLOCKS * HIST_TILE, 1), dtype=torch.float32,
                           device=energy.device)
    hist = torch.empty(n_bins, dtype=torch.float32, device=energy.device)
    energy_histogram.launches += 1
    build.launch(
        "hare_energy_histogram", energy.contiguous(), time.contiguous(),
        hit.contiguous(), n, n_bins, bin_dt, int(soft), partials, partials.numel(), hist,
    )
    return hist


def hard_histogram_bwd_plain(
    time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor, n_bins: int, bin_dt: float,
) -> torch.Tensor:
    """Plain version of the hard backward: d(energy), each hit lane's bin's
    incoming gradient and 0 on dead lanes — the gather that transposes the
    JAX package's ``segment_sum`` (``bounce.py:294-300``).  The bins are
    piecewise constant in time, which gets no cotangent."""
    return torch.where(hit, grad_hist[_bins(time, n_bins, bin_dt)], 0.0)


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


def _histogram_bwd_kernel(energy, time, hit, grad_hist, n_bins, bin_dt, soft):
    """K3's backward on CUDA tensors (``kernels/csrc/energy_histogram.cu``
    ``hare_histogram_bwd``), hard or soft: ``(d_energy, d_time)``, d_time
    None where hard.  ``grad_hist`` is read at its stride, so a broadcast
    gradient (a sum's, stride 0) is not copied."""
    _check_lanes(energy, time, hit)
    if grad_hist.shape != (n_bins,) or grad_hist.dtype != torch.float32:
        raise ValueError("grad_hist must be (n_bins,) float32")
    d_energy = torch.empty(time.shape, dtype=torch.float32, device=time.device)
    d_time = torch.empty_like(d_energy) if soft else None
    build.launch(
        "hare_histogram_bwd", None if energy is None else energy.contiguous(),
        time.contiguous(), hit.contiguous(), grad_hist, grad_hist.stride(0), time.numel(), n_bins,
        bin_dt, int(soft), d_energy, d_time,
    )
    return d_energy, d_time


def hard_histogram_bwd(
    time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor, n_bins: int, bin_dt: float,
) -> torch.Tensor:
    """The hard histogram's backward, d(energy) shaped like ``time``.  CUDA
    tensors launch K3's backward kernel in its hard mode; CPU tensors take
    :func:`hard_histogram_bwd_plain`."""
    if check_device(time, hit, grad_hist) == "cpu":
        return hard_histogram_bwd_plain(time, hit, grad_hist, n_bins, bin_dt)
    hard_histogram_bwd.launches += 1
    return _histogram_bwd_kernel(None, time, hit, grad_hist, n_bins, bin_dt, False)[0]


hard_histogram_bwd.launches = 0


def soft_histogram_bwd(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor,
    n_bins: int, bin_dt: float,
):
    """The soft histogram's backward, ``(d_energy, d_time)`` shaped like
    ``energy``.  CUDA tensors launch K3's backward kernel in its soft mode;
    CPU tensors take :func:`soft_histogram_bwd_plain`."""
    if check_device(energy, time, hit, grad_hist) == "cpu":
        return soft_histogram_bwd_plain(energy, time, hit, grad_hist, n_bins, bin_dt)
    soft_histogram_bwd.launches += 1
    return _histogram_bwd_kernel(energy, time, hit, grad_hist, n_bins, bin_dt, True)


soft_histogram_bwd.launches = 0


class _HardHistogram(torch.autograd.Function):
    """hist[bin(time)] += energy over hit lanes; d/d(energy) is the bin's
    incoming gradient on hit lanes and 0 elsewhere (:func:`hard_histogram_bwd`);
    d/d(time) is 0."""

    @staticmethod
    def forward(ctx, energy, time, hit, n_bins, bin_dt):
        ctx.save_for_backward(time, hit)
        ctx.n_bins, ctx.bin_dt = n_bins, bin_dt
        if check_device(energy, time, hit) == "cpu":
            return histogram_plain(energy, time, hit, n_bins, bin_dt)
        return histogram_kernel(energy, time, hit, n_bins, bin_dt)

    @staticmethod
    def backward(ctx, grad_hist):
        if not ctx.needs_input_grad[0]:  # a loss w.r.t. the vertices: time's alone
            return None, None, None, None, None
        time, hit = ctx.saved_tensors
        d_energy = hard_histogram_bwd(time, hit, grad_hist, ctx.n_bins, ctx.bin_dt)
        return d_energy, None, None, None, None


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
