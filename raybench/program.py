"""The system under test, ``hare_tpu_torch``, as the window drives it: the
set-up a configuration asks for, and the step a traffic mix asks for."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .devtrace import BACKWARD, FORWARD
from .judge import StepOutputs


class System:
    """A configuration's scene and structure, built by the program from the
    faces, and the absorption it is differentiated in."""

    def __init__(self, faces: Sequence[np.ndarray], cfg: Dict, traffic: Dict, device):
        import hare_tpu_torch as th

        if cfg["dtype"] != "float32":
            raise ValueError(f"the port traces float32 scenes, not {cfg['dtype']}")
        self.th = th
        top = th.Topology.build(list(faces))
        self.partition = th.SpatialPartition(top, accel=cfg["accel"], kernel=cfg["kernel"],
                                             device=device, **cfg["accel_params"])
        self.absorption = torch.full((top.n_polys,), float(cfg["absorption"]),
                                     dtype=torch.float32, device=device, requires_grad=True)
        self.bounces = traffic["bounces"]
        self.bins = traffic["bins"]
        self.bin_dt = traffic["bin_dt"]
        self.sound_speed = cfg["sound_speed"]

    def rays(self, origin: torch.Tensor, directions: List[torch.Tensor]) -> list:
        """The pool's batches as the program takes them."""
        return [self.th.Ray.make(origin, d) for d in directions]

    def step(self, rays) -> StepOutputs:
        """One step: trace, the hard histogram, its sum as the loss, the
        gradient w.r.t. the absorption.  Returns without waiting."""
        th, sp = self.th, self.partition
        with record_function(FORWARD):
            res = th.trace_rays(sp.scene, rays, self.absorption, self.bounces, sp.shoot_fn,
                                aux=sp.aux, sound_speed=self.sound_speed)
            hist = th.energy_histogram(res, self.bins, self.bin_dt)
            loss = hist.sum()
        with record_function(BACKWARD):
            (grad,) = torch.autograd.grad(loss, self.absorption)
        return StepOutputs(res.hit, res.poly_id, res.t, res.energy.detach(), res.time.detach(),
                           hist.detach(), grad)
