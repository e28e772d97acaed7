"""Inverse acoustic design, end to end: fit per-surface absorption to a
target impulse-response histogram (``examples/fit_absorption.py`` of the JAX
package).

The whole bounce loop is differentiable, so the absorption coefficients of
the concert hall's surfaces are recovered by gradient descent from the
impulse response alone.  One program drives the port's whole surface:
``HareConfig`` (CLI), ``SpatialPartition`` (the accel choice), the
ray-parallel train step over ``torch.distributed`` (a group of one, or
``torchrun``'s), JSONL metrics, checkpoint/resume and the timing helper.
With ``--fit-scattering`` it also fits per-surface scattering; every step
then draws from a fresh generator of one seed, so each step sees the
target's draws, as the JAX package's one key repeats its draws.

Run:  python -m hare_tpu_torch.examples.fit_absorption [--steps 60]
          [--fit-scattering] [--checkpoint-dir DIR] [--metrics-path FILE]
          [--device cuda]
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
from ..utils import HareConfig, MetricsLogger, latest_step, restore_state, save_state, timed
from ._group import join_group, leave_group, require_device

__all__ = ["LR", "SOURCE", "Problem", "fit", "main", "parse", "setup"]

SOURCE = (15.0, 24.0, 8.0)  # the source position in the hall
LR = 0.1  # Adam's learning rate
TIMED_STEPS = 5


class Problem(NamedTuple):
    """The hall, its partition, the rays, the hidden truth and its target."""

    top: Topology
    sp: SpatialPartition
    rays: Ray
    a_true: torch.Tensor  # (P,) absorption in [0.1, 0.7]
    s_true: Optional[torch.Tensor]  # (P,) scattering in [0.2, 0.8], with --fit-scattering
    draw_state: torch.Tensor  # the scattering draws' generator state
    target: torch.Tensor  # (n_bins,)


def parse(argv=None):
    """``(HareConfig, steps, fit_scattering, device)`` from the command line."""
    p = HareConfig.parser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--fit-scattering", action="store_true",
                   help="jointly recover per-surface scattering coefficients")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    steps, fit_scattering, device = ns.pop("steps"), ns.pop("fit_scattering"), ns.pop("device")
    return HareConfig(**ns), steps, fit_scattering, device


def _draw_generator(cfg: HareConfig, device, state: Optional[torch.Tensor] = None):
    """The scattering draws' generator on ``device``: seeded with
    ``cfg.seed``, or set to ``state``."""
    gen = torch.Generator(device=device)
    return gen.manual_seed(cfg.seed) if state is None else gen.set_state(state)


def setup(cfg: HareConfig, fit_scattering: bool, device, rays: Optional[Ray] = None,
          world: int = 1) -> Problem:
    """The concert hall with a hidden absorption pattern (and, with
    ``fit_scattering``, scattering), its partition on ``device`` and the
    target histogram.  ``rays`` default to ``cfg.n_rays`` (cut to a multiple
    of ``world``) directions from ``uniform_sphere`` with a CPU generator
    seeded ``cfg.seed``, from ``SOURCE``."""
    top = Topology.build(shapes.concert_hall())
    sp = SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel, device=device,
                          **cfg.accel_params())
    if rays is None:
        n = (cfg.n_rays // world) * world
        d = uniform_sphere(n, torch.Generator().manual_seed(cfg.seed), device=device)
        rays = Ray.make(torch.tensor(SOURCE, device=device).expand(n, 3).contiguous(), d)
    # Hidden truth: wall-dependent absorption in [0.1, 0.7] (and scattering
    # in [0.2, 0.8]), the JAX program's draws.
    rng = np.random.default_rng(cfg.seed)
    a_true = torch.tensor(rng.uniform(0.1, 0.7, top.n_polys), dtype=torch.float32, device=device)
    s_true = None
    if fit_scattering:
        s_true = torch.tensor(rng.uniform(0.2, 0.8, top.n_polys), dtype=torch.float32,
                              device=device)
    draw_state = _draw_generator(cfg, device).get_state()
    hist_fn = hd.sharded_histogram(sp.shoot_fn, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                                   sound_speed=cfg.sound_speed, use_scattering=fit_scattering)
    with torch.no_grad():
        gen = _draw_generator(cfg, device) if fit_scattering else None
        target = hist_fn(sp.scene, rays, a_true, sp.aux, s_true, gen)
    return Problem(top, sp, rays, a_true, s_true, draw_state, target)


def _prime(opt: torch.optim.Optimizer, params) -> None:
    """One step on zero gradients, so that ``opt.state_dict()`` holds every
    parameter's state (a restore's template); Adam leaves the parameters
    as they are, and the restore overwrites both."""
    for p in params.values():
        p.grad = torch.zeros_like(p)
    opt.step()
    opt.zero_grad(set_to_none=True)


def fit(prob: Problem, cfg: HareConfig, steps: int, device, log: Optional[MetricsLogger] = None,
        on_step: Optional[Callable[[int], None]] = None, time_iters: int = TIMED_STEPS) -> dict:
    """``steps`` Adam steps (lr ``LR``) of ``dist.make_train_step`` from
    sigmoid(0) = 0.5, resumed from ``cfg.checkpoint_dir`` where it holds a
    step; logs and saves at every tenth step and the last.  ``on_step(i)``
    runs before step ``i``.  Returns ``err`` (mean |a - a_true| after the
    steps; with scattering ``err_s`` and its start ``err_s0``), ``losses``,
    the parameters after the steps, ``start`` (the first step run),
    ``step_s`` (seconds a step from ``timed`` over ``time_iters`` more
    steps, taken after the rest is read, or None) and ``step``, a callable
    that takes one more step.  The group of ``dist`` must exist."""
    fit_scattering = prob.s_true is not None
    n_polys = prob.top.n_polys
    params = {"absorption": torch.zeros(n_polys, device=device, requires_grad=True)}
    if fit_scattering:
        params["scattering"] = torch.zeros(n_polys, device=device, requires_grad=True)
    opt = torch.optim.Adam(params.values(), lr=LR)
    draw_state, start = prob.draw_state, 0
    if cfg.checkpoint_dir and latest_step(cfg.checkpoint_dir) is not None:
        _prime(opt, params)
        template = {"params": {k: v.detach() for k, v in params.items()},
                    "opt_state": opt.state_dict(), "rng": draw_state, "cursor": 0}
        state = restore_state(cfg.checkpoint_dir, template)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(state["params"][k])
        opt.load_state_dict(state["opt_state"])
        draw_state, start = state["rng"], state["cursor"]
        print(f"resumed from step {start}")

    sp = prob.sp
    step_fn = hd.make_train_step(sp.shoot_fn, opt, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                                 use_scattering=fit_scattering, sound_speed=cfg.sound_speed)

    def step():
        gen = _draw_generator(cfg, device, draw_state) if fit_scattering else None
        return step_fn(params, sp.scene, prob.rays, prob.target, sp.aux, gen)

    def errors():
        with torch.no_grad():
            out = {"mean_abs_err": float((torch.sigmoid(params["absorption"])
                                          - prob.a_true).abs().mean())}
            if fit_scattering:
                out["mean_abs_err_s"] = float((torch.sigmoid(params["scattering"])
                                               - prob.s_true).abs().mean())
        return out

    lead = not tdist.is_initialized() or tdist.get_rank() == 0
    n = prob.rays.origin.shape[0]
    losses = []
    for i in range(start, steps):
        if on_step is not None:
            on_step(i)
        losses.append(step())
        if i % 10 == 0 or i == steps - 1:
            err = errors()
            loss = float(losses[-1])
            if lead and log is not None:
                log.write(step=i, loss=loss, rays=n, bounces=cfg.n_bounces, **err)
            print(f"step {i:4d}  loss {loss:10.4f}  mean |a-a*| {err['mean_abs_err']:.4f}"
                  + (f"  |s-s*| {err['mean_abs_err_s']:.4f}" if fit_scattering else ""))
            if lead and cfg.checkpoint_dir:
                save_state(cfg.checkpoint_dir, i, {
                    "params": {k: v.detach() for k, v in params.items()},
                    "opt_state": opt.state_dict(), "rng": draw_state, "cursor": i + 1})
    err = errors()
    out = dict(err=err["mean_abs_err"], losses=[float(x) for x in losses], start=start,
               params={k: v.detach().clone() for k, v in params.items()}, step=step,
               step_s=None)
    if fit_scattering:
        with torch.no_grad():
            out["err_s0"] = float((torch.sigmoid(torch.zeros_like(prob.s_true))
                                   - prob.s_true).abs().mean())
        out["err_s"] = err["mean_abs_err_s"]
    if time_iters:
        # The optimizer updates the parameters in place: everything above
        # is read before these steps move them further.
        out["step_s"], _ = timed(step, iters=time_iters)
    return out


def main(argv=None) -> float:
    """Run the program; returns the final mean |a - a_true|."""
    cfg, steps, fit_scattering, device = parse(argv)
    dev = require_device(device)
    made = join_group(dev)
    try:
        world = tdist.get_world_size()
        prob = setup(cfg, fit_scattering, dev, world=world)
        print(f"scene: {prob.top.n_tris} tris, accel={cfg.accel}, device={dev}, "
              f"{tdist.get_backend()} group of {world}")
        log = MetricsLogger(cfg.metrics_path)
        try:
            out = fit(prob, cfg, steps, dev, log)
        finally:
            log.close()
    finally:
        leave_group(made)
    n = prob.rays.origin.shape[0]
    dt = out["step_s"]
    print(f"steady-state step: {dt * 1e3:.1f} ms  "
          f"({n * cfg.n_bounces / dt / 1e6:.2f} Mrays/s fwd+bwd)")
    print(f"final mean |a - a_true| = {out['err']:.4f}")
    return out["err"]


if __name__ == "__main__":
    sys.exit(0 if main() < 0.1 else 1)
