"""The system under test, ``hare_tpu_torch``, as the window drives it: the
set-up a configuration asks for, and the step a traffic mix asks for."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .cells import step_of
from .devtrace import BACKWARD, FORWARD
from .judge import StepOutputs


class System:
    """A configuration's scene and structure, built by the program from the
    faces, and the leaf the step is differentiated in: the absorption, or
    a leaf copy of the scene's vertices (``cells.step_of``)."""

    def __init__(self, faces: Sequence[np.ndarray], cfg: Dict, traffic: Dict, device):
        import hare_tpu_torch as th

        if cfg["dtype"] != "float32":
            raise ValueError(f"the port traces float32 scenes, not {cfg['dtype']}")
        self.th = th
        self.spec = step_of(traffic)
        top = th.Topology.build(list(faces))
        self.partition = th.SpatialPartition(top, accel=cfg["accel"], kernel=cfg["kernel"],
                                             device=device, **cfg["accel_params"])
        wrt_v = self.spec.wrt_vertices
        self.absorption = torch.full((top.n_polys,), float(cfg["absorption"]),
                                     dtype=torch.float32, device=device, requires_grad=not wrt_v)
        self.vertices = (self.partition.scene.vertices.detach().clone().requires_grad_()
                         if wrt_v else None)
        self.weight = (torch.arange(traffic["bins"], dtype=torch.float32, device=device)
                       if self.spec.first_moment else None)
        self.bounces = traffic["bounces"]
        self.bins = traffic["bins"]
        self.bin_dt = traffic["bin_dt"]
        self.sound_speed = cfg["sound_speed"]

    def rays(self, origin: torch.Tensor, directions: List[torch.Tensor]) -> list:
        """The pool's batches as the program takes them."""
        return [self.th.Ray.make(origin, d) for d in directions]

    def step(self, rays) -> StepOutputs:
        """One step: trace (at the leaf vertices, where the step takes their
        gradient), the histogram, the loss, the gradient w.r.t. the leaf.
        Returns without waiting."""
        th, sp, spec, v = self.th, self.partition, self.spec, self.vertices
        with record_function(FORWARD):
            scene = sp.scene if v is None else sp.scene.with_vertices(v)
            res = th.trace_rays(scene, rays, self.absorption, self.bounces, sp.shoot_fn,
                                aux=sp.aux, sound_speed=self.sound_speed, remat=spec.remat)
            hist = th.energy_histogram(res, self.bins, self.bin_dt, soft=spec.soft)
            loss = hist.sum() if self.weight is None else (hist * self.weight).sum()
        with record_function(BACKWARD):
            (grad,) = torch.autograd.grad(loss, self.absorption if v is None else v)
        out = StepOutputs(res.hit, res.poly_id, res.t, res.energy.detach(), res.time.detach(),
                          hist.detach(), grad)
        # The hit points only where the judge replays them: held past the
        # step, they would raise the peak of every other cell.
        return out if v is None else out._replace(point=res.point.detach(), vertices=v.detach())
