"""The comparison that decides ``correct``: the window's last step, as the
program produced it, against the plain reference (``reference.py``).

Two parts, each over what the timed step produced at the timed size:

- The rays sampled, end to end: ``check_rays`` rays of the step's batch,
  drawn from the seed, are traced again by the reference from the same
  origin and directions, independently of anything the program made, and
  their hits, energies, arrival times and histogram are compared with the
  program's.
- Everything after the traversal, over the whole batch: from the program's
  own hits (whether each bounce hit, the polygon, ``t``), the reference
  works out every lane's energy and arrival time, the histogram and the
  gradient w.r.t. the absorption, and compares the program's.  This part
  follows the program's hits, which the first part checks on its sample.
  Where the step is differentiated w.r.t. the vertices, the reference
  replays every lane from the program's hits (the polygon, the point) at
  its own welded vertices (``reference.replay``): the arrival times,
  the histogram and the gradient w.r.t. the vertices are its own.

The bins are those of the traffic's step (``cells.step_of``): hard, or
soft in both histograms compared.

The numbers compared, each against its limit (``limits/<cell>.json``):

``path_mismatch``
    share of the sampled rays whose hits (hit or miss, polygon) differ
    from the reference's on some bounce.
``time_gap``, ``energy_gap``
    widest relative gap of a sampled ray's arrival time, or of its
    energy, on every bounce both hit on the same polygon after the same
    earlier polygons.
``sample_hist_gap``
    widest gap of the cumulative histogram of the sampled rays' lanes, the
    program's against the reference's own trace, as a share of its total.
``lane_gap``
    widest relative gap of a hit lane's energy or arrival time; infinite
    where a ray hits after a miss.  W.r.t. the vertices, against the
    replayed times, over the rays that meet no triangle at a grazing angle
    (``GRAZING_COS``).
``hist_gap``
    widest gap of the cumulative histogram, as a share of its total.
``grad_gap``
    widest gap of the gradient, as a share of its largest entry.  W.r.t.
    the vertices, each vertex is held to its own size: the norm of its gap
    over its ``scale`` (``reference.vertex_loss_and_grad``: the sum, over
    the rays that hit a triangle of it, of each one's largest corner term,
    the size that the float32 rounding of what the ray brings to any of the
    triangle's corners goes with), the program's vertices matched to the
    reference's by position (infinite where the two sets do not match one
    to one, or where a vertex no ray touches has a gradient), less what
    grazing rays and rays with a lane within ``CENTRE_WINDOW`` of a bin
    centre may move it by (``comparable``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from . import reference
from .cells import step_of

NUMBERS = ("path_mismatch", "time_gap", "energy_gap", "sample_hist_gap", "lane_gap",
           "hist_gap", "grad_gap")
# W.r.t. the vertices, a ray that meets a triangle at |cos| below this
# (the angle to its plane under 1.7 degrees) is left out of lane_gap, and
# grad_gap allows the vertices of every triangle it hit its terms times
# GRAZING_COS / |cos|: float32 rounding of its origin and direction moves
# its crossing of that plane by about 1 / |cos| times as much, and the
# program's t and gradient with it (on the port's CPU path at c4's size,
# such rays at |cos| 0.011-0.03 move their vertices by at most 7e-3 of
# their terms).
GRAZING_COS = 3e-2
# W.r.t. the vertices, a lane whose reference bin position lies within this
# share of itself of a whole number (a bin centre, where the tent's clip
# gives a lane half its gradient if its float32 position falls exactly on
# it) has grad_gap allow its ray's vertices its terms.  Decided from the
# reference alone: six times the widest relative gap of a sound lane's time
# on the card (3.4e-6), so the program's position of a sound lane never
# reaches a centre the reference's is not near.
CENTRE_WINDOW = 2e-5


class StepOutputs(NamedTuple):
    """What one step of the window produced, as the judge reads it: the
    trace's per-bounce ``(B, N)`` hit, polygon, ``t``, energy and time, the
    histogram and the gradient; the hit points ``(B, N, 3)``, and w.r.t.
    the vertices the program's vertex positions ``(V, 3)``, whose order
    the gradient's rows follow."""

    hit: torch.Tensor
    poly: torch.Tensor
    t: torch.Tensor
    energy: torch.Tensor
    time: torch.Tensor
    hist: torch.Tensor
    grad: torch.Tensor
    point: Optional[torch.Tensor] = None
    vertices: Optional[torch.Tensor] = None


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-30)


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _cdf_gap(h: torch.Tensor, h_ref: torch.Tensor) -> float:
    """Widest gap of ``h``'s cumulative sum from ``h_ref``'s, as a share of
    ``h_ref``'s total."""
    cdf = torch.cumsum(h.double(), 0)
    cdf_r = torch.cumsum(h_ref.double(), 0)
    return _max((cdf - cdf_r).abs()) / (float(cdf_r[-1].abs()) or 1.0)


def traversal_numbers(prog: reference.Trace, ref: reference.Trace, bins: int,
                      bin_dt: float, soft: bool = False) -> Dict[str, float]:
    """``path_mismatch``, ``time_gap``, ``energy_gap`` and
    ``sample_hist_gap`` of sampled rays, ``(B, S)`` each; the histograms
    soft where ``soft``."""
    same = (prog.hit == ref.hit) & (~ref.hit | (prog.poly.long() == ref.poly))
    mismatch = 1.0 - float(same.all(dim=0).double().mean())
    # A bounce counts where it and every earlier bounce agree, and both hit.
    both = torch.cumprod(same.long(), dim=0).bool() & ref.hit
    t_gap = _rel(prog.time, ref.time)[both]
    e_gap = _rel(prog.energy, ref.energy)[both]
    hist = reference.soft_histogram if soft else reference.histogram
    h = hist(prog.energy.double(), prog.time.double(), prog.hit, bins, bin_dt)
    h_ref = hist(ref.energy.double(), ref.time.double(), ref.hit, bins, bin_dt)
    return {"path_mismatch": mismatch,
            "time_gap": _max(t_gap) if t_gap.numel() else float("inf"),
            "energy_gap": _max(e_gap) if e_gap.numel() else float("inf"),
            "sample_hist_gap": _cdf_gap(h, h_ref)}


def lane_numbers(out: StepOutputs, energy_r, time_r, hist_r, grad_r,
                 rays=None) -> Dict[str, float]:
    """``lane_gap``, ``hist_gap`` and ``grad_gap`` of the whole batch against
    the reference's lanes, histogram and gradient; ``lane_gap`` over the
    rays ``rays`` (``(N,)`` bool) where given."""
    hit = out.hit
    chain_ok = bool((hit[1:] <= hit[:-1]).all()) if hit.shape[0] > 1 else True
    lanes = hit if rays is None else hit & rays
    lane = torch.maximum(_rel(out.energy, energy_r), _rel(out.time, time_r))[lanes]
    scale = float(grad_r.double().abs().max()) or 1.0
    return {
        "lane_gap": _max(lane) if chain_ok else float("inf"),
        "hist_gap": _cdf_gap(out.hist, hist_r),
        "grad_gap": _max((out.grad.double() - grad_r.double()).abs()) / scale,
    }


def vertex_grad_gap(grad: torch.Tensor, grad_r: torch.Tensor, scale: torch.Tensor,
                    allowance: torch.Tensor) -> float:
    """Widest gap of a vertex's gradient row from the reference's, less its
    ``allowance`` (``comparable``), as a share of the vertex's ``scale``;
    infinite at a vertex of scale 0 whose rows differ."""
    gap = torch.linalg.vector_norm(grad.double() - grad_r.double(), dim=1)
    gap = torch.clamp(gap - allowance.double(), min=0.0)
    s = scale.double()
    rel = torch.where(s > 0, gap / torch.where(s > 0, s, 1.0),
                      torch.where(gap > 0, float("inf"), 0.0))
    return _max(rel)


def comparable(mesh: reference.Mesh, hit: torch.Tensor, time_r: torch.Tensor,
               rp: reference.Replay, bin_dt: float):
    """``(rays (N,), allowance (V,))``, decided from the reference's replay
    alone: the rays ``lane_gap`` holds the float32 program to, every hit of
    which meets its triangle at ``|cos| >= GRAZING_COS``; and by how much
    each vertex's gradient may stray for the rays that ``grad_gap`` cannot
    hold to their terms: a ray with a lane whose reference bin position lies
    within ``CENTRE_WINDOW`` of a bin centre (whose float32 position may fall
    on it, where the tent's clip halves the lane's gradient) its term
    (``rp.term``) at each triangle it hit, a grazing ray ``GRAZING_COS /
    |cos|`` times it at its least ``|cos|``."""
    least = torch.where(hit, rp.cos.double(), 1.0).amin(dim=0)
    grazing = least < GRAZING_COS
    pos = time_r.double() / bin_dt - 0.5
    centre = ((pos - torch.round(pos)).abs() <= CENTRE_WINDOW * pos.abs()) & hit
    weight = torch.where(grazing, GRAZING_COS / least.clamp_min(1e-300),
                         torch.where(centre.any(dim=0), 1.0, 0.0))
    term = torch.where(hit, rp.term.double() * weight, 0.0)[..., None].expand(-1, -1, 3)
    allowance = torch.zeros(mesh.vertices.shape[0], dtype=torch.float64,
                            device=hit.device).index_add_(0, mesh.tri_vid[rp.tri].reshape(-1),
                                                          term.reshape(-1))
    return ~grazing, allowance


def _lane_numbers(mesh, origin, directions, absorption, out: StepOutputs, cfg, traffic,
                  detail: Optional[Dict] = None, low=None) -> Dict[str, float]:
    """``lane_numbers`` of ``out`` against the float64 reference, or of the
    reference in the precision ``low`` put in ``out``'s place.  W.r.t. the
    vertices, the program's gradient rows are matched to the reference's
    vertices, and the rays and vertices it cannot be held to are left out
    (:func:`comparable`); ``detail`` gets ``lane_gap`` and ``grad_gap``
    with nothing left out, and what was."""
    step = step_of(traffic)
    args = (cfg["sound_speed"], traffic["bins"], traffic["bin_dt"], step.soft, step.first_moment)
    if not step.wrt_vertices:
        ref = reference.loss_and_grad(out.hit, out.poly, out.t, absorption.double(), *args)
        if low is not None:
            e_c, t_c, h_c, g_c = reference.loss_and_grad(out.hit, out.poly, out.t,
                                                         absorption.to(low), *args)
            out = out._replace(energy=e_c, time=t_c, hist=h_c, grad=g_c)
        return lane_numbers(out, *ref)
    lanes = (mesh, origin, directions, out.hit, out.poly, out.t, out.point, absorption) + args
    e_r, t_r, h_r, g_r, scale, rp = reference.vertex_loss_and_grad(*lanes)
    rays, allowance = comparable(mesh, out.hit, t_r, rp, traffic["bin_dt"])
    matched = True
    if low is not None:
        e_c, t_c, h_c, g_c, _, _ = reference.vertex_loss_and_grad(*lanes, dtype=low)
        out = out._replace(energy=e_c, time=t_c, hist=h_c, grad=g_c)
    else:
        perm = reference.match_vertices(mesh.vertices, out.vertices)
        matched = perm is not None
        out = out._replace(grad=out.grad[perm.to(out.grad.device)] if matched
                           else torch.zeros_like(g_r))
    got = lane_numbers(out, e_r, t_r, h_r, g_r, rays)
    got["grad_gap"] = (vertex_grad_gap(out.grad, g_r, scale, allowance) if matched
                       else float("inf"))
    if detail is not None:
        detail.update(lane_gap_all=lane_numbers(out, e_r, t_r, h_r, g_r)["lane_gap"],
                      grad_gap_all=vertex_grad_gap(out.grad, g_r, scale, torch.zeros_like(scale)),
                      rays_left_out=int((~rays).sum()),
                      vertices_with_allowance=int((allowance > 0).sum()),
                      vertices_compared=int(((scale > 0) & (allowance < scale)).sum()),
                      least_cos=float(rp.cos.min()))
    return got


def numbers(sc: reference.Scene, origin: torch.Tensor, directions: torch.Tensor,
            absorption: torch.Tensor, out: StepOutputs, sample: torch.Tensor, cfg: Dict,
            traffic: Dict, mesh: Optional[reference.Mesh] = None,
            detail: Optional[Dict] = None) -> Dict[str, float]:
    """Every number compared, for the step ``out`` on the batch
    ``directions`` from ``origin`` (``(N, 3)`` each); ``sc`` is the float64
    reference scene, ``sample`` the indices of the rays it re-traces and
    ``mesh`` the welded faces, which a step w.r.t. the vertices needs."""
    n_b, speed = traffic["bounces"], cfg["sound_speed"]
    idx = sample.to(directions.device)
    ref = reference.trace(sc, origin[idx], directions[idx], absorption.double(), n_b, speed)
    sampled = reference.Trace(out.hit[:, idx], out.poly[:, idx], out.t[:, idx],
                              out.energy[:, idx], out.time[:, idx])
    got = traversal_numbers(sampled, ref, traffic["bins"], traffic["bin_dt"],
                            step_of(traffic).soft)
    got.update(_lane_numbers(mesh, origin, directions, absorption, out, cfg, traffic, detail))
    return got


def control_numbers(sc64: reference.Scene, sc_low: reference.Scene, origin, directions,
                    absorption, out: StepOutputs, sample, cfg, traffic,
                    mesh: Optional[reference.Mesh] = None) -> Dict[str, float]:
    """The control: the reference computed in ``sc_low``'s precision put in
    the program's place, judged as the program is.  It re-traces the
    sampled rays in that precision; the lanes, histogram and gradient
    are worked out in that precision from the program's hits of the same
    step (w.r.t. the vertices, replayed at the mesh's vertices in that
    precision)."""
    n_b, speed = traffic["bounces"], cfg["sound_speed"]
    bins, bin_dt = traffic["bins"], traffic["bin_dt"]
    idx = sample.to(directions.device)
    o, d = origin[idx], directions[idx]
    low = sc_low.normal.dtype
    ref = reference.trace(sc64, o, d, absorption.double(), n_b, speed)
    sub = reference.trace(sc_low, o, d, absorption.to(low), n_b, speed)
    got = traversal_numbers(sub, ref, bins, bin_dt, step_of(traffic).soft)
    got.update(_lane_numbers(mesh, origin, directions, absorption, out, cfg, traffic, low=low))
    return got


def verdict(got: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number is at or under its limit."""
    return all(got[k] <= limits[k] for k in NUMBERS)
