"""Differentiable multi-bounce tracing and the energy histogram.

Counterpart of ``hare_tpu/trace/bounce.py`` (specular and scattering
tracing, per-bounce remat, the hard and the soft histogram).  The bounce
loop is a Python loop: each bounce shoots (a traversal + K2), then the
bounce step applies the hit record to the carried state — reflect, the
absorption gather, the energy product, the scattering coin and lobe, and
the coplanar second exclusion.  On CUDA tensors the step is K4
(``kernels/csrc/bounce_step.cu``), one launch forward and one backward
inside ``torch.autograd.Function`` :func:`fused_bounce_step`; its plain
version is :func:`bounce_step`, torch ops whose autograd is the plain
backward, which CPU tensors run.  The absorption and scattering gathers'
backward is the fixed-order scatter (``accel.scatter``), and the hit
record's is A3 (``accel.common.finalize_hits``), so gradients w.r.t.
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
from contextlib import contextmanager
from typing import Callable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..accel.common import check_device
from ..accel.scatter import gather_rows, scatter_add_ordered
from ..geom.math import dot, normalize
from ..geom.primitives import NO_POLY, HitRecord, Ray
from ..kernels import build
from ..mesh.scene import Scene
from ..utils.checks import check_finite
from ..utils.tracing import count, current_id, span, spanned

__all__ = [
    "SOUND_SPEED",
    "BounceState",
    "TraceResult",
    "bounce_bwd_kernel",
    "bounce_bwd_plain",
    "bounce_kernel",
    "bounce_step",
    "bounce_step_bwd",
    "cosine_lobe",
    "energy_histogram",
    "fused_bounce_step",
    "hard_histogram_bwd",
    "hard_histogram_bwd_plain",
    "histogram_kernel",
    "histogram_plain",
    "record_steps",
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


# The gradients K4's backward gives, in order: w.r.t. the state's energy,
# dist, origin and direction, the record's t, point and normal, and the two
# tables.  Its cotangents, in order, are those of the next state's origin,
# direction, energy and dist and of the outputs energy, time and t.
GRADS = ("energy", "dist", "origin", "direction", "t", "point", "normal", "absorption",
         "scattering")


def _reached(cotangents, wanted, scattering) -> Tuple[bool, ...]:
    """``wanted`` less the gradients no cotangent reaches (autograd gives
    None for those) and, without scattering, its table's."""
    g_o, g_d, g_e, g_dist, g_oe, g_time, g_t = (g is not None for g in cotangents)
    has_e, has_dist = g_e or g_oe, g_dist or g_time
    reach = (has_e, has_dist, g_o, g_d, has_dist or g_t, g_o, g_d, has_e,
             has_e and scattering is not None)
    return tuple(bool(w) and r for w, r in zip(wanted, reach))


def _inv_sound_speed(sound_speed: float) -> float:
    """``dist / sound_speed`` as torch computes it on the card: a multiply
    by the f32 reciprocal of the f32 divisor (its backward too)."""
    return float(np.float32(1.0) / np.float32(sound_speed))


def _f32(x: torch.Tensor, shape) -> torch.Tensor:
    return _as(x, torch.float32, shape)


def _as(x: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """``x`` as K4 reads it: contiguous, of ``dtype`` and ``shape``; raises
    otherwise."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"K4: expected {dtype} {tuple(shape)}, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _tables(absorption, scattering, draws, n):
    """The tables and the bounce's draws as K4 reads them (the backward
    may go without the uniforms: None)."""
    a = _f32(absorption, absorption.shape[:1])
    if scattering is None:
        return a, None, None, None, None
    if draws is None:
        raise ValueError("K4: scattering takes the bounce's draws (diffuse, r1, r2)")
    diffuse, r1, r2 = draws
    return (a, _f32(scattering, a.shape), _as(diffuse, torch.bool, (n,)), _opt(r1, (n,)),
            _opt(r2, (n,)))


def _opt(x: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    return None if x is None else _f32(x, shape)


def bounce_kernel(
    state: BounceState,
    hr: HitRecord,
    absorption: torch.Tensor,
    scattering: Optional[torch.Tensor] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    sound_speed: float = SOUND_SPEED,
    tri_meta: Optional[torch.Tensor] = None,
):
    """K4's forward on CUDA tensors (``kernels/csrc/bounce_step.cu``): what
    :func:`bounce_step` returns, in one launch.  A record without
    ``edge_nbr`` takes the neighbours from ``tri_meta`` lanes 1-3 of its
    ``tri_id``."""
    n = state.origin.shape[0]
    dev = state.origin.device
    vec, row = (n, 3), (n,)
    if hr.edge_nbr is None and tri_meta is None:
        raise ValueError("K4: a record without edge_nbr needs the scene's tri_meta")
    a, s, diffuse, r1, r2 = _tables(absorption, scattering, draws, n)
    f = dict(dtype=torch.float32, device=dev)
    out = dict(origin=torch.empty(vec, **f), direction=torch.empty(vec, **f),
               exclude=torch.empty(n, 2, dtype=torch.int32, device=dev),
               energy=torch.empty(row, **f), dist=torch.empty(row, **f),
               alive=torch.empty(row, dtype=torch.bool, device=dev))
    oe, time, poly, t = (torch.empty(row, **f), torch.empty(row, **f),
                         torch.empty(row, dtype=torch.int32, device=dev), torch.empty(row, **f))
    build.launch(
        "hare_bounce_step", _f32(state.energy, row), _f32(state.dist, row),
        _f32(state.origin, vec), _f32(state.direction, vec), _as(state.alive, torch.bool, row),
        _as(hr.hit, torch.bool, row), _f32(hr.t, row), _f32(hr.u, row), _f32(hr.v, row),
        _f32(hr.point, vec), _f32(hr.normal, vec), _as(hr.poly_id, torch.int32, row),
        _as(hr.tri_id, torch.int32, row),
        None if hr.edge_nbr is None else _as(hr.edge_nbr, torch.int32, vec),
        None if hr.edge_nbr is not None else _as(tri_meta, torch.int32, (tri_meta.shape[0], 8)),
        a, s, diffuse, r1, r2, n, _inv_sound_speed(sound_speed), out["origin"],
        out["direction"], out["exclude"], out["energy"], out["dist"], out["alive"], oe, time,
        poly, t,
    )
    return BounceState(**out), (out["alive"], oe, time, poly, hr.point, t)


def bounce_bwd_kernel(
    state: BounceState,
    hr: HitRecord,
    absorption: torch.Tensor,
    scattering: Optional[torch.Tensor],
    draws,
    cotangents: Tuple[Optional[torch.Tensor], ...],
    wanted: Tuple[bool, ...],
    sound_speed: float = SOUND_SPEED,
):
    """K4's backward on CUDA tensors, one launch: the gradients named by
    ``GRADS`` where ``wanted`` and some cotangent reaches them (the rest
    None) from the seven cotangents (None where absent, read as no term at
    all, as autograd adds none).  It reads the state's energy (the energy
    chain), direction (the direction's) and alive, the record's hit,
    poly_id and normal (the direction's), the tables and the draws (the
    uniforms: the direction's), each None where no chain asked for reads
    it; the tables' two gradients come per ray, before their sum by polygon
    (:func:`bounce_step_bwd` sums them)."""
    n = hr.hit.shape[0]
    dev = hr.hit.device
    vec, row = (n, 3), (n,)
    a, s, diffuse, r1, r2 = _tables(absorption, scattering, draws, n)
    shapes = (vec, vec, row, row, row, row, row)
    g = [None if x is None else _f32(x, sh) for x, sh in zip(cotangents, shapes)]
    wanted = _reached(cotangents, wanted, scattering)
    f = dict(dtype=torch.float32, device=dev)
    out = [torch.empty(sh, **f) if w else None
           for w, sh in zip(wanted, (row, row, vec, vec, row, vec, vec, row, row))]
    d_energy, d_dist, d_origin, d_direction, d_t, d_point, d_normal, d_a, d_s = out
    build.launch(
        "hare_bounce_step_bwd", _opt(state.energy, row), _opt(state.direction, vec),
        _opt(hr.normal, vec), _as(state.alive, torch.bool, row), _as(hr.hit, torch.bool, row),
        _as(hr.poly_id, torch.int32, row), a, s, diffuse, r1, r2, *g, n,
        _inv_sound_speed(sound_speed), d_energy, d_dist, d_origin, d_direction, d_normal,
        d_point, d_t, d_a, d_s,
    )
    return tuple(out)


def bounce_bwd_plain(state, hr, absorption, scattering, draws, cotangents, wanted,
                     sound_speed: float = SOUND_SPEED):
    """Plain version of K4's backward: autograd through :func:`bounce_step`
    on the same inputs, the gradients named by ``GRADS`` where ``wanted``
    and some cotangent reaches them (the tables' summed by polygon through
    ``gather_rows``' ordered scatter), the rest None."""
    wanted = _reached(cotangents, wanted, scattering)
    diff = (state.energy, state.dist, state.origin, state.direction, hr.t, hr.point, hr.normal,
            absorption, scattering)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() if w else (None if x is None else x.detach())
                  for x, w in zip(diff, wanted)]
        e, dist, o, d, t, point, normal, a, s = leaves
        st = state._replace(origin=o, direction=d, energy=e, dist=dist)
        rec = hr._replace(t=t, point=point, normal=normal)
        nxt, outs = bounce_step(st, rec, a, s, draws, sound_speed)
        ys = (nxt.origin, nxt.direction, nxt.energy, nxt.dist, outs[1], outs[2], outs[5])
        pairs = [(y, g) for y, g in zip(ys, cotangents) if g is not None and y.requires_grad]
        want = [x for x, w in zip(leaves, wanted) if w]
        got = iter(torch.autograd.grad([y for y, _ in pairs], want, [g for _, g in pairs],
                                       allow_unused=True) if pairs and want else ())
    return tuple(next(got) if w else None for w in wanted)


def bounce_step_bwd(state, hr, absorption, scattering, draws, cotangents, wanted,
                    sound_speed: float = SOUND_SPEED):
    """The bounce step's backward, as :func:`bounce_bwd_plain` returns it:
    K4's backward on CUDA tensors, the tables' per-ray gradients then
    summed by polygon with ``scatter_add_ordered`` (as ``gather_rows``'
    backward sums them); :func:`bounce_bwd_plain` on CPU tensors."""
    if check_device(hr.hit, hr.poly_id) == "cpu":
        return bounce_bwd_plain(state, hr, absorption, scattering, draws, cotangents, wanted,
                                sound_speed)
    out = list(bounce_bwd_kernel(state, hr, absorption, scattering, draws, cotangents, wanted,
                                 sound_speed))
    pid = torch.clamp(hr.poly_id, min=0)
    for k, table in ((7, absorption), (8, scattering)):
        if out[k] is not None:
            out[k] = scatter_add_ordered(pid, out[k], table.shape[0])
    return tuple(out)


class _BounceStep(torch.autograd.Function):
    """The bounce step: K4 on CUDA tensors, forward and backward;
    :func:`bounce_step` and autograd through it on CPU tensors.  Inputs:
    the differentiable ``GRADS`` tensors, then ``rest`` = (alive, exclude,
    hit, u, v, poly_id, tri_id, edge_nbr, tri_meta, draws, sound_speed).
    Each float output is differentiable only where an input it depends on
    requires grad, as the torch ops' outputs are; absent cotangents stay
    None (``set_materialize_grads(False)``), and the backward computes only
    the gradients ``needs_input_grad`` asks for that some cotangent
    reaches."""

    @staticmethod
    def forward(ctx, energy, dist, origin, direction, t, point, normal, absorption, scattering,
                rest):
        alive, exclude, hit, u, v, poly_id, tri_id, edge_nbr, tri_meta, draws, sound_speed = rest
        state = BounceState(origin, direction, exclude, energy, dist, alive)
        hr = HitRecord(hit, t, u, v, point, poly_id, tri_id, normal, edge_nbr)
        cpu = check_device(energy, origin, normal, absorption) == "cpu"
        if cpu:
            nxt, outs = bounce_step(state, hr, absorption, scattering, draws, sound_speed)
        else:
            nxt, outs = bounce_kernel(state, hr, absorption, scattering, draws, sound_speed,
                                      tri_meta)
        ctx.set_materialize_grads(False)
        need = dict(zip(GRADS, ctx.needs_input_grad))
        fixed = [nxt.exclude, nxt.alive, outs[3]]
        for y, deps in ((nxt.origin, ("origin", "point")), (nxt.direction, ("direction", "normal")),
                        (nxt.energy, ("energy", "absorption", "scattering")),
                        (outs[1], ("energy", "absorption", "scattering")),
                        (nxt.dist, ("dist", "t")), (outs[2], ("dist", "t")), (outs[5], ("t",))):
            if not any(need[k] for k in deps):
                fixed.append(y)
        ctx.mark_non_differentiable(*fixed)
        diffuse, r1, r2 = (None, None, None) if draws is None else draws
        ctx.cpu, ctx.sound_speed, ctx.trace_id = cpu, sound_speed, current_id()
        if cpu:  # the plain backward runs bounce_step again
            ctx.save_for_backward(energy, dist, origin, direction, t, point, normal, absorption,
                                  scattering, alive, exclude, hit, u, v, poly_id, tri_id,
                                  edge_nbr, diffuse, r1, r2)
        else:  # what K4's backward reads for the chains a loss may reach
            chain_e = need["energy"] or need["absorption"] or need["scattering"]
            geo = need["direction"] or need["normal"]
            ctx.save_for_backward(energy if chain_e else None, direction if geo else None,
                                  normal if geo else None, absorption, scattering, alive, hit,
                                  poly_id, diffuse, r1 if geo else None, r2 if geo else None)
        return (nxt.origin, nxt.direction, nxt.exclude, nxt.energy, nxt.dist, nxt.alive,
                outs[1], outs[2], outs[3], outs[5])

    @staticmethod
    def backward(ctx, g_origin, g_direction, _exclude, g_energy, g_dist, _alive, g_out_energy,
                 g_time, _poly, g_t):
        cot = (g_origin, g_direction, g_energy, g_dist, g_out_energy, g_time, g_t)
        if not any(_reached(cot, ctx.needs_input_grad[:len(GRADS)], True)):
            return (None,) * (len(GRADS) + 1)  # no cotangent reaches a gradient
        with span("hare.backward.bounce_step", id=ctx.trace_id):
            if ctx.cpu:
                (energy, dist, origin, direction, t, point, normal, absorption, scattering, alive,
                 exclude, hit, u, v, poly_id, tri_id, edge_nbr, diffuse, r1, r2) = ctx.saved_tensors
                state = BounceState(origin, direction, exclude, energy, dist, alive)
                hr = HitRecord(hit, t, u, v, point, poly_id, tri_id, normal, edge_nbr)
            else:
                (energy, direction, normal, absorption, scattering, alive, hit, poly_id, diffuse,
                 r1, r2) = ctx.saved_tensors
                state = BounceState(None, direction, None, energy, None, alive)
                hr = HitRecord(hit, None, None, None, None, poly_id, None, normal)
            draws = None if diffuse is None else (diffuse, r1, r2)
            grads = bounce_step_bwd(state, hr, absorption, scattering, draws, cot,
                                    ctx.needs_input_grad[:len(GRADS)], ctx.sound_speed)
        return (*grads, None)


# The list :func:`record_steps` collects into, or None.
_steps: Optional[List[tuple]] = None


@contextmanager
def record_steps() -> Iterator[List[tuple]]:
    """Collect what every :func:`fused_bounce_step` call inside the block
    receives, ``(state, record, draws, sound_speed, tri_meta)`` a call:
    the inputs ``chip_smoke.py`` and the card tests hold K4 against its
    plain version on (``benchmarks.bench_scene.bounce_inputs``)."""
    global _steps
    outer, _steps = _steps, []
    try:
        yield _steps
    finally:
        _steps = outer


def fused_bounce_step(
    state: BounceState,
    hr: HitRecord,
    absorption: torch.Tensor,
    scattering: Optional[torch.Tensor] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    sound_speed: float = SOUND_SPEED,
    tri_meta: Optional[torch.Tensor] = None,
):
    """The bounce step as :func:`trace_rays` runs it: what
    :func:`bounce_step` returns, differentiable in the state, the record's
    t, point and normal and the tables.  CUDA tensors launch K4 forward
    (:func:`bounce_kernel`) and, in the backward, K4's backward
    (:func:`bounce_step_bwd`); CPU tensors run :func:`bounce_step` and
    autograd through it.  A record without ``edge_nbr`` takes the
    neighbours from ``tri_meta`` (the scene's) by ``tri_id``."""
    if _steps is not None:
        _steps.append((state, hr, draws, sound_speed, tri_meta))
    if hr.edge_nbr is None and check_device(state.origin) == "cpu":
        if tri_meta is None:
            raise ValueError("a record without edge_nbr needs the scene's tri_meta")
        hr = hr._replace(edge_nbr=tri_meta[torch.clamp(hr.tri_id, min=0).long(), 1:4])
    rest = (state.alive, state.exclude, hr.hit, hr.u, hr.v, hr.poly_id, hr.tri_id, hr.edge_nbr,
            tri_meta, draws, sound_speed)
    origin, direction, exclude, energy, dist, live, out_energy, time, poly, t = _BounceStep.apply(
        state.energy, state.dist, state.origin, state.direction, hr.t, hr.point, hr.normal,
        absorption, scattering, rest)
    return (BounceState(origin, direction, exclude, energy, dist, live),
            (live, out_energy, time, poly, hr.point, t))


@spanned("hare.trace_rays")
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
    draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
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
        (:func:`scatter_draws`); required with ``scattering`` unless
        ``draws`` is given.  One seed gives a bitwise-identical trace.
      remat: recompute each bounce, its shoot included, in the backward
        (``torch.utils.checkpoint``).  Each bounce's input state is kept
        and its activations are recomputed one bounce at a time, so the
        peak falls only where the backward would otherwise save more a
        bounce than that state, as the geometry of a loss w.r.t. the
        vertices; w.r.t. the absorption alone it can rise.  Values and
        gradients are unchanged.
      draws: the trace's scattering draws ``(diffuse, r1, r2)``, each
        ``(n_bounces, N)`` as :func:`scatter_draws` returns them, in place
        of drawing from ``generator`` (the sharded path hands each rank its
        rays' columns of the whole batch's draws).

    Each bounce's step is :func:`fused_bounce_step`: K4 on CUDA tensors.
    With ``utils.enable_debug_checks`` on, a NaN in the energies or times
    raises ``FloatingPointError``.
    """
    if scattering is not None and generator is None and draws is None:
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
    if scattering is None:
        draws = None
    elif draws is None:
        draws = scatter_draws(generator, n_bounces, n, o.dtype, o.device)

    def bounce(state, draws_b, b, rid):
        # rid: the request's id, which a recompute under remat, on
        # autograd's thread, carries too.
        with span("hare.bounce", b=b, id=rid):
            r = Ray(state.origin, state.direction, state.exclude)
            with span("hare.shoot"):
                hr = shoot_fn(scene, r) if aux is None else shoot_fn(scene, r, aux)
            with span("hare.bounce_step"):
                return fused_bounce_step(state, hr, absorption, scattering, draws_b,
                                         sound_speed, scene.tri_meta)

    outs, rid = [], current_id()
    for b in range(n_bounces):
        draws_b = None if draws is None else tuple(x[b] for x in draws)
        if remat and torch.is_grad_enabled():
            # The draws are inputs, never drawn inside: the recompute sees
            # the forward's numbers without restoring any generator.
            state, out = checkpoint(bounce, state, draws_b, b, rid, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            state, out = bounce(state, draws_b, b, rid)
        outs.append(out)
    res = TraceResult(*(torch.stack(x) for x in zip(*outs)))
    check_finite("trace_rays", res.energy, res.time)
    return res


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
    count("histogram_bwd.soft" if soft else "histogram_bwd.hard")
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
    return _histogram_bwd_kernel(None, time, hit, grad_hist, n_bins, bin_dt, False)[0]


def soft_histogram_bwd(
    energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, grad_hist: torch.Tensor,
    n_bins: int, bin_dt: float,
):
    """The soft histogram's backward, ``(d_energy, d_time)`` shaped like
    ``energy``.  CUDA tensors launch K3's backward kernel in its soft mode;
    CPU tensors take :func:`soft_histogram_bwd_plain`."""
    if check_device(energy, time, hit, grad_hist) == "cpu":
        return soft_histogram_bwd_plain(energy, time, hit, grad_hist, n_bins, bin_dt)
    return _histogram_bwd_kernel(energy, time, hit, grad_hist, n_bins, bin_dt, True)


class _HardHistogram(torch.autograd.Function):
    """hist[bin(time)] += energy over hit lanes; d/d(energy) is the bin's
    incoming gradient on hit lanes and 0 elsewhere (:func:`hard_histogram_bwd`);
    d/d(time) is 0."""

    @staticmethod
    def forward(ctx, energy, time, hit, n_bins, bin_dt):
        ctx.save_for_backward(time, hit)
        ctx.n_bins, ctx.bin_dt, ctx.trace_id = n_bins, bin_dt, current_id()
        if check_device(energy, time, hit) == "cpu":
            return histogram_plain(energy, time, hit, n_bins, bin_dt)
        return histogram_kernel(energy, time, hit, n_bins, bin_dt)

    @staticmethod
    def backward(ctx, grad_hist):
        if not ctx.needs_input_grad[0]:  # a loss w.r.t. the vertices: time's alone
            return None, None, None, None, None
        with span("hare.backward.histogram", id=ctx.trace_id, soft=False):
            time, hit = ctx.saved_tensors
            d_energy = hard_histogram_bwd(time, hit, grad_hist, ctx.n_bins, ctx.bin_dt)
        return d_energy, None, None, None, None


class _SoftHistogram(torch.autograd.Function):
    """The tent histogram; its backward gives d/d(energy) and d/d(time)
    (:func:`soft_histogram_bwd`)."""

    @staticmethod
    def forward(ctx, energy, time, hit, n_bins, bin_dt):
        ctx.save_for_backward(energy, time, hit)
        ctx.n_bins, ctx.bin_dt, ctx.trace_id = n_bins, bin_dt, current_id()
        if check_device(energy, time, hit) == "cpu":
            return soft_histogram_plain(energy, time, hit, n_bins, bin_dt)
        return histogram_kernel(energy, time, hit, n_bins, bin_dt, soft=True)

    @staticmethod
    def backward(ctx, grad_hist):
        with span("hare.backward.histogram", id=ctx.trace_id, soft=True):
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
    K3 on CUDA tensors, its plain version on CPU tensors.  With
    ``utils.enable_debug_checks`` on, a NaN in the bins raises
    ``FloatingPointError``.
    """
    fn = _SoftHistogram if soft else _HardHistogram
    with span("hare.histogram", soft=soft):
        hist = fn.apply(result.energy, result.time, result.hit, n_bins, bin_dt)
        check_finite("energy_histogram", hist)
    return hist
