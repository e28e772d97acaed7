"""Inverse shape design, end to end: fit vertex POSITIONS to a target
impulse-response histogram (``examples/fit_vertices.py`` of the JAX package).

The reference's shape hook is ``Set_Vertex``
(``Hare_Geometry_Topology.cs:506-511``): it can move a vertex but cannot say
where to.  Here the bounce loop is differentiable in the vertex coordinates,
so the room's geometry is recovered by gradient descent from the impulse
response alone.  Two nested loops:

  inner — ``dist.make_train_step(fit_vertices=True)``: the traversal tables
    stay as built (the hit-triangle assignment is approximate under the
    move), while hit values and gradients come from the live vertices
    (``Scene.with_vertices``).  The histogram is soft (tent bins): vertex
    positions reach it only through arrival times, which hard bins do not
    differentiate.
  outer — every ``--inner`` steps the topology and the partition are
    REBUILT at the current estimate (``Topology.from_indexed``), and a new
    Adam starts over fresh leaf tensors; the absorption carries over.

Run:  python -m hare_tpu_torch.examples.fit_vertices [--steps 100]
          [--inner 25] [--metrics-path FILE] [--device cuda]
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as tdist

from .. import dist as hd
from ..accel import SpatialPartition
from ..geom import Ray
from ..mesh import Topology, shapes
from ..trace import uniform_sphere
from ..utils import HareConfig, MetricsLogger, timed
from ._group import join_group, leave_group, require_device

__all__ = ["A_FIXED", "LR", "ROOM", "SCALE", "SOURCE", "Problem", "extents", "fit", "main",
           "parse", "setup"]

ROOM = (4.0, 5.0, 3.0)  # the shoebox the fit starts from
SCALE = (1.08, 0.96, 1.04)  # the true room: the shoebox scaled anisotropically
SOURCE = (2.0, 2.5, 1.5)
A_FIXED = 0.2  # the true absorption of every wall, and the fit's start
LR = 2e-2  # Adam's learning rate
TIMED_STEPS = 5


class Problem(NamedTuple):
    """The starting shoebox's faces, the true room, the rays and the target."""

    faces0: list
    top_true: Topology
    rays: Ray
    target: torch.Tensor  # (n_bins,), soft bins


def extents(v: np.ndarray) -> np.ndarray:
    return v.max(axis=0) - v.min(axis=0)


def parse(argv=None):
    """``(HareConfig, steps, inner, device)`` from the command line."""
    p = HareConfig.parser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--inner", type=int, default=25,
                   help="train steps between accel/topology rebuilds")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    steps, inner, device = ns.pop("steps"), ns.pop("inner"), ns.pop("device")
    return HareConfig(**ns), steps, inner, device


def _partition(top: Topology, cfg: HareConfig, device) -> SpatialPartition:
    return SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel, device=device,
                            **cfg.accel_params())


def setup(cfg: HareConfig, device, rays: Optional[Ray] = None, world: int = 1) -> Problem:
    """The true room (the shoebox scaled by ``SCALE``, fully rebuilt), its
    soft-binned target at absorption ``A_FIXED`` on ``device``.  ``rays``
    default to ``cfg.n_rays`` (cut to a multiple of ``world``) directions
    from ``uniform_sphere`` with a CPU generator seeded ``cfg.seed``, from
    ``SOURCE``."""
    faces0 = shapes.shoebox(*ROOM)
    scale = np.array(SCALE, np.float32)
    top_true = Topology.build([f * scale for f in faces0])
    sp_true = _partition(top_true, cfg, device)
    a_fixed = torch.full((top_true.n_polys,), A_FIXED, device=device)
    if rays is None:
        n = (cfg.n_rays // world) * world
        d = uniform_sphere(n, torch.Generator().manual_seed(cfg.seed), device=device)
        rays = Ray.make(torch.tensor(SOURCE, device=device).expand(n, 3).contiguous(), d)
    hist_fn = hd.sharded_histogram(sp_true.shoot_fn, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                                   sound_speed=cfg.sound_speed, soft=True)
    with torch.no_grad():
        target = hist_fn(sp_true.scene, rays, a_fixed, sp_true.aux)
    return Problem(faces0, top_true, rays, target)


def fit(prob: Problem, cfg: HareConfig, steps: int, inner: int, device,
        log: Optional[MetricsLogger] = None, on_step: Optional[Callable[[int], None]] = None,
        time_iters: int = TIMED_STEPS) -> dict:
    """``steps`` steps from the unscaled shoebox, the topology and partition
    rebuilt every ``inner`` steps, each round a new Adam (lr ``LR``) over
    fresh leaves ``{"absorption", "vertices"}``.  ``on_step(i)`` runs before
    step ``i``.  Returns ``losses`` (each step's), ``reduction`` (the last
    loss over the first), ``ext_err`` (the largest extent error of the
    final topology, metres), ``top`` (that topology), the last round's
    parameters, ``step_s`` (seconds a step from ``timed`` over
    ``time_iters`` more steps of the last round, taken after the rest is
    read, or None) and ``step``, a callable that takes one more step of the
    last round.  The group of ``dist`` must exist."""
    lead = not tdist.is_initialized() or tdist.get_rank() == 0
    n = prob.rays.origin.shape[0]
    a_raw = torch.full((prob.top_true.n_polys,), float(np.log(A_FIXED / (1 - A_FIXED))),
                       device=device)
    top = Topology.build(prob.faces0)
    losses, i = [], 0
    while i < steps:
        sp = _partition(top, cfg, device)
        params = {"absorption": a_raw.detach().clone().requires_grad_(),
                  "vertices": sp.scene.vertices.detach().clone().requires_grad_()}
        opt = torch.optim.Adam(params.values(), lr=LR)
        step_fn = hd.make_train_step(sp.shoot_fn, opt, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                                     fit_vertices=True, sound_speed=cfg.sound_speed)

        def step(params=params, sp=sp, step_fn=step_fn):
            return step_fn(params, sp.scene, prob.rays, prob.target, sp.aux)

        for _ in range(min(inner, steps - i)):
            if on_step is not None:
                on_step(i)
            losses.append(step())
            i += 1
        # The absorption carries across the rebuild; the vertices carry
        # through the rebuilt topology (re-welded: its own vertex order).
        a_raw = params["absorption"].detach()
        v_est = params["vertices"].detach().cpu().numpy()
        ext_err = float(np.abs(extents(v_est) - extents(prob.top_true.vertices)).max())
        loss = float(losses[-1])
        if lead and log is not None:
            log.write(step=i, loss=loss, extent_err=ext_err, rays=n)
        print(f"step {i:4d}  loss {loss:12.6f}  max extent err {ext_err:.4f} m  (rebuild)")
        top = Topology.from_indexed(v_est, top.poly_verts)

    losses = [float(x) for x in losses]
    out = dict(losses=losses, reduction=losses[-1] / losses[0], top=top,
               ext_err=float(np.abs(extents(top.vertices)
                                    - extents(prob.top_true.vertices)).max()),
               params={k: v.detach().clone() for k, v in params.items()}, step=step,
               step_s=None)
    if time_iters:
        # The optimizer updates the parameters in place: everything above
        # is read before these steps move them further.
        out["step_s"], _ = timed(step, iters=time_iters)
    return out


def main(argv=None) -> float:
    """Run the program; returns the loss reduction (last over first)."""
    cfg, steps, inner, device = parse(argv)
    dev = require_device(device)
    made = join_group(dev)
    try:
        prob = setup(cfg, dev, world=tdist.get_world_size())
        log = MetricsLogger(cfg.metrics_path)
        try:
            out = fit(prob, cfg, steps, inner, dev, log)
        finally:
            log.close()
    finally:
        leave_group(made)
    first, last = out["losses"][0], out["losses"][-1]
    dt, n = out["step_s"], prob.rays.origin.shape[0]
    print(f"steady-state step: {dt * 1e3:.1f} ms  "
          f"({n * cfg.n_bounces / dt / 1e6:.2f} Mrays/s fwd+bwd)")
    print(f"loss: {first:.4f} -> {last:.4f} ({first / last:.0f}x reduction); "
          f"final max extent error {out['ext_err']:.4f} m (a diagnostic — the IR "
          f"constrains arrival-time combinations, not extents directly)")
    return out["reduction"]


if __name__ == "__main__":
    # Success = the IR match improved by >= 10x (the histogram is the
    # objective; extent recovery needs many more rays/bins than a demo run).
    sys.exit(0 if main() < 0.1 else 1)
