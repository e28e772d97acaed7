"""The JAX package's eval configurations (``benchmarks/configs.py``) on the
port: their scenes and structures from the same sources, their rays from
the same distributions.  The ray directions come from torch's generator
(seed 0), not JAX's ``PRNGKey(0)``: the same distribution, not the same
rays.

Copies, not imports: that file imports the JAX package.  Config 4 is here;
configs 1, 2, 3, 5 and ``deep`` are queued (``chip_smoke.py`` builds
configs 1 and 3 itself).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

__all__ = ["Config4", "big_scene", "config4_setup"]


def big_scene(n_target: str = "650k") -> List[np.ndarray]:
    """Procedural large scenes (``benchmarks/configs.py:44-65``): a
    ``shoebox(40, 40, 40)`` shell and icospheres, as stacked (F, 3, 3)
    chunks, one a shape."""
    from ..mesh import shapes

    faces = [np.stack(shapes.shoebox(40.0, 40.0, 40.0))]
    if n_target == "650k":
        specs = [((12, 12, 12), 6.0, 7), ((28, 12, 12), 5.0, 6),
                 ((12, 28, 12), 5.0, 6), ((12, 12, 28), 5.0, 6),
                 ((28, 28, 28), 5.0, 6)]
    elif n_target == "1.3M":
        specs = [((20, 20, 20), 8.0, 8)]
    else:  # "5M": 4 x subdiv-8 icospheres = 5.24M tris + shell
        specs = [((10, 10, 10), 6.0, 8), ((30, 10, 12), 6.0, 8),
                 ((10, 30, 14), 6.0, 8), ((28, 28, 28), 6.0, 8)]
    for c, r, sub in specs:
        faces.append(np.stack(shapes.icosphere(sub, radius=r, center=c)))
    return faces


class Config4(NamedTuple):
    topology: object
    partition: object
    rays: object
    absorption: torch.Tensor
    n_bounces: int
    n_bins: int
    topology_s: float  # host build seconds
    kdtree_s: float


def config4_setup(device="cuda") -> Config4:
    """Eval config 4 (``benchmarks/configs.py:138-158``): ``big_scene("650k")``
    (655,372 triangles), an SAH KD tree with ``max_tris_per_node=8``, 32,768
    uniform rays (torch's seed 0) from (20, 20, 20), absorption 0.3, 2
    bounces, 512 bins of 1 ms; its loss is the histogram's sum,
    differentiated w.r.t. the vertices through ``scene.with_vertices``.
    Host build times beside."""
    import hare_tpu_torch as th

    t0 = time.perf_counter()
    top = th.Topology.build(big_scene("650k"))
    topology_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = th.SpatialPartition(top, accel="kdtree", max_tris_per_node=8, device=device)
    kdtree_s = time.perf_counter() - t0
    n = 1 << 15
    d = th.uniform_sphere(n, torch.Generator().manual_seed(0), device=device)
    o = torch.tensor([20.0, 20.0, 20.0], device=d.device).expand(n, 3).contiguous()
    absorption = torch.full((top.n_polys,), 0.3, device=d.device)
    return Config4(top, sp, th.Ray.make(o, d), absorption, 2, 512, topology_s, kdtree_s)
