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
    where a ray hits after a miss.
``hist_gap``
    widest gap of the cumulative histogram, as a share of its total.
``grad_gap``
    widest gap of the gradient, as a share of its largest entry.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from . import reference

NUMBERS = ("path_mismatch", "time_gap", "energy_gap", "sample_hist_gap", "lane_gap",
           "hist_gap", "grad_gap")


class StepOutputs(NamedTuple):
    """What one step of the window produced, as the judge reads it: the
    trace's per-bounce ``(B, N)`` hit, polygon, ``t``, energy and time, the
    histogram and the gradient."""

    hit: torch.Tensor
    poly: torch.Tensor
    t: torch.Tensor
    energy: torch.Tensor
    time: torch.Tensor
    hist: torch.Tensor
    grad: torch.Tensor


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
                      bin_dt: float) -> Dict[str, float]:
    """``path_mismatch``, ``time_gap``, ``energy_gap`` and
    ``sample_hist_gap`` of sampled rays, ``(B, S)`` each."""
    same = (prog.hit == ref.hit) & (~ref.hit | (prog.poly.long() == ref.poly))
    mismatch = 1.0 - float(same.all(dim=0).double().mean())
    # A bounce counts where it and every earlier bounce agree, and both hit.
    both = torch.cumprod(same.long(), dim=0).bool() & ref.hit
    t_gap = _rel(prog.time, ref.time)[both]
    e_gap = _rel(prog.energy, ref.energy)[both]
    h = reference.histogram(prog.energy.double(), prog.time.double(), prog.hit, bins, bin_dt)
    h_ref = reference.histogram(ref.energy.double(), ref.time.double(), ref.hit, bins, bin_dt)
    return {"path_mismatch": mismatch,
            "time_gap": _max(t_gap) if t_gap.numel() else float("inf"),
            "energy_gap": _max(e_gap) if e_gap.numel() else float("inf"),
            "sample_hist_gap": _cdf_gap(h, h_ref)}


def lane_numbers(out: StepOutputs, energy_r, time_r, hist_r, grad_r) -> Dict[str, float]:
    """``lane_gap``, ``hist_gap`` and ``grad_gap`` of the whole batch against
    the reference's lanes, histogram and gradient."""
    hit = out.hit
    chain_ok = bool((hit[1:] <= hit[:-1]).all()) if hit.shape[0] > 1 else True
    lane = torch.maximum(_rel(out.energy, energy_r), _rel(out.time, time_r))[hit]
    scale = float(grad_r.double().abs().max()) or 1.0
    return {
        "lane_gap": _max(lane) if chain_ok else float("inf"),
        "hist_gap": _cdf_gap(out.hist, hist_r),
        "grad_gap": _max((out.grad.double() - grad_r.double()).abs()) / scale,
    }


def numbers(sc: reference.Scene, origin: torch.Tensor, directions: torch.Tensor,
            absorption: torch.Tensor, out: StepOutputs, sample: torch.Tensor, cfg: Dict,
            traffic: Dict) -> Dict[str, float]:
    """Every number compared, for the step ``out`` on the batch
    ``directions`` from ``origin`` (``(N, 3)`` each); ``sc`` is the float64
    reference scene and ``sample`` the indices of the rays it re-traces."""
    n_b, speed = traffic["bounces"], cfg["sound_speed"]
    idx = sample.to(directions.device)
    ref = reference.trace(sc, origin[idx], directions[idx], absorption.double(), n_b, speed)
    sampled = reference.Trace(out.hit[:, idx], out.poly[:, idx], out.t[:, idx],
                              out.energy[:, idx], out.time[:, idx])
    got = traversal_numbers(sampled, ref, traffic["bins"], traffic["bin_dt"])
    got.update(lane_numbers(out, *reference.loss_and_grad(
        out.hit, out.poly, out.t, absorption.double(), speed, traffic["bins"],
        traffic["bin_dt"])))
    return got


def control_numbers(sc64: reference.Scene, sc_low: reference.Scene, origin, directions,
                    absorption, out: StepOutputs, sample, cfg, traffic) -> Dict[str, float]:
    """The control: the reference computed in ``sc_low``'s precision put in
    the program's place, judged as the program is.  It re-traces the
    sampled rays in that precision; the lanes, histogram and gradient
    are worked out in that precision from the program's hits of the same
    step."""
    n_b, speed = traffic["bounces"], cfg["sound_speed"]
    bins, bin_dt = traffic["bins"], traffic["bin_dt"]
    idx = sample.to(directions.device)
    o, d = origin[idx], directions[idx]
    low = sc_low.normal.dtype
    ref = reference.trace(sc64, o, d, absorption.double(), n_b, speed)
    sub = reference.trace(sc_low, o, d, absorption.to(low), n_b, speed)
    got = traversal_numbers(sub, ref, bins, bin_dt)
    e_r, t_r, h_r, g_r = reference.loss_and_grad(out.hit, out.poly, out.t, absorption.double(),
                                                 speed, bins, bin_dt)
    e_c, t_c, h_c, g_c = reference.loss_and_grad(out.hit, out.poly, out.t, absorption.to(low),
                                                 speed, bins, bin_dt)
    stand_in = out._replace(energy=e_c, time=t_c, hist=h_c, grad=g_c)
    got.update(lane_numbers(stand_in, e_r, t_r, h_r, g_r))
    return got


def verdict(got: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number is at or under its limit."""
    return all(got[k] <= limits[k] for k in NUMBERS)
