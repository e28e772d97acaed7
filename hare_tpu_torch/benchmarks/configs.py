"""The JAX package's eval configurations (``benchmarks/configs.py``) on the
port: their scenes and structures from the same sources, their rays from
the same distributions.  The ray directions come from torch's generator
(seed 0), not JAX's ``PRNGKey(0)``: the same distribution, not the same
rays.

Copies, not imports: that file imports the JAX package.  Every config
of it is here: 1 to 5 and ``deep``; and, for config 5's sustained run,
:func:`config5_batches`, its rays in batches.  Each setup defaults to
the card and raises without one.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch

__all__ = [
    "Config4",
    "Config5",
    "HallConfig",
    "big_scene",
    "config1_setup",
    "config2_setup",
    "config3_setup",
    "config4_setup",
    "config5_batches",
    "config5_setup",
    "deep_setup",
]

HALL_SOURCE = (15.0, 24.0, 8.0)
ROOM_SOURCE = (2.0, 2.5, 1.5)  # config 1's shoebox(4, 5, 3)
BIG_SOURCE = (20.0, 20.0, 20.0)  # the centre of big_scene's 40 m shell


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


class HallConfig(NamedTuple):
    """A config of one room and one structure: configs 1, 2, 3 and
    ``deep``."""

    topology: object
    partition: object
    rays: object
    absorption: torch.Tensor
    n_bounces: int
    n_bins: int
    build_s: float  # host build seconds: topology and structure


def _rays(source, n: int, generator: torch.Generator, device):
    """``n`` uniform directions from ``generator`` (drawn on its device),
    all from the point ``source``, on ``device``."""
    import hare_tpu_torch as th

    d = th.uniform_sphere(n, generator, device=device)
    o = torch.tensor(source, device=d.device).expand(n, 3).contiguous()
    return th.Ray.make(o, d)


def _room(faces, accel: str, source, n: int, absorption: float, n_bounces: int, n_bins: int,
          device) -> HallConfig:
    """``faces`` with ``accel`` at the builder's defaults, ``n`` uniform
    rays (torch's seed 0) from ``source``, uniform absorption."""
    import hare_tpu_torch as th

    t0 = time.perf_counter()
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel=accel, device=device)
    build_s = time.perf_counter() - t0
    rays = _rays(source, n, torch.Generator().manual_seed(0), device)
    a = torch.full((top.n_polys,), absorption, device=rays.origin.device)
    return HallConfig(top, sp, rays, a, n_bounces, n_bins, build_s)


def _hall(accel: str, n: int, absorption: float, n_bounces: int, n_bins: int,
          device) -> HallConfig:
    """``concert_hall()`` (1,608 triangles) as :func:`_room` sets it up,
    the rays from (15, 24, 8)."""
    from ..mesh import shapes

    return _room(shapes.concert_hall(), accel, HALL_SOURCE, n, absorption, n_bounces, n_bins,
                 device)


def config1_setup(device="cuda") -> HallConfig:
    """Eval config 1 (``benchmarks/configs.py:86-104``): ``shoebox(4, 5,
    3)`` (12 triangles), brute force, 10,000 rays from (2.0, 2.5, 1.5),
    absorption 0.3, 3 bounces, 256 bins of 1 ms; forward only."""
    from ..mesh import shapes

    return _room(shapes.shoebox(4, 5, 3), "brute", ROOM_SOURCE, 10_000, 0.3, 3, 256, device)


def config2_setup(device="cuda") -> HallConfig:
    """Eval config 2 (``benchmarks/configs.py:106-123``): the concert hall,
    a grid, 100,000 rays, absorption 0.3, 3 bounces, 1024 bins of 1 ms;
    forward only."""
    return _hall("grid", 100_000, 0.3, 3, 1024, device)


def config3_setup(device="cuda") -> HallConfig:
    """Eval config 3 (``benchmarks/configs.py:106-136``): the concert hall,
    an octree, 1,000,000 rays, absorption 0.3, 3 bounces, 1024 bins of 1
    ms; its loss is the histogram's sum, differentiated w.r.t. the
    absorption."""
    return _hall("octree", 1_000_000, 0.3, 3, 1024, device)


def deep_setup(device="cuda") -> HallConfig:
    """Eval config ``deep`` (``benchmarks/configs.py:220-242``): the concert
    hall, a grid, 16,384 rays, absorption 0.1, 32 bounces, 2048 bins of 1
    ms; the loss is the histogram's sum, differentiated w.r.t. the
    absorption, with and without per-bounce remat."""
    return _hall("grid", 1 << 14, 0.1, 32, 2048, device)


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
    rays = _rays(BIG_SOURCE, 1 << 15, torch.Generator().manual_seed(0), device)
    absorption = torch.full((top.n_polys,), 0.3, device=rays.origin.device)
    return Config4(top, sp, rays, absorption, 2, 512, topology_s, kdtree_s)


class Config5(NamedTuple):
    topology: object
    partition: object
    rays: object
    absorption: torch.Tensor
    n_bounces: int
    n_bins: int
    topology_s: float  # host build seconds
    grid_s: float

    def stats(self) -> Dict[str, object]:
        """What the reference's config-5 line prints about the grid
        (``benchmarks/configs.py:206-218``), and the bytes the scene and
        grid hold on the device."""
        g = self.partition.struct
        rows, win = g.win_geom.shape[:2]

        def mb(tensors):
            return sum(x.numel() * x.element_size() for x in tensors
                       if isinstance(x, torch.Tensor)) / 1e6

        return dict(
            grid_dims=g.dims, win_rows=rows, max_cell_wins=g.max_cell_wins,
            dup_slots_per_tri=(rows - 1) * win / self.topology.n_tris,
            # The reference's win_data is the port's win_geom: 12 f32 a slot.
            win_data_MB=mb([g.win_geom]), win_ids_MB=mb([g.win_ids]),
            meta_MB=mb([g.cell_meta]), scene_MB=mb(self.partition.scene), grid_MB=mb(g))


def _on(device) -> None:
    """Raise now where ``device`` cannot hold a tensor, before a long host
    build."""
    torch.empty(0, device=device)


def config5_setup(device="cuda") -> Config5:
    """Eval config 5 (``benchmarks/configs.py:176-218``): ``big_scene("5M")``
    (5,242,892 triangles), a ``domain=256`` grid, 2^20 uniform rays (torch's
    seed 0) from (20, 20, 20), absorption 0.3, 2 bounces, 1024 bins of 1 ms;
    forward (the reference's metric) and the histogram's sum differentiated
    w.r.t. the absorption.  Host build times beside."""
    import hare_tpu_torch as th

    _on(device)
    t0 = time.perf_counter()
    top = th.Topology.build(big_scene("5M"))
    topology_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sp = th.SpatialPartition(top, accel="grid", domain=256, device=device)
    grid_s = time.perf_counter() - t0
    rays = _rays(BIG_SOURCE, 1 << 20, torch.Generator().manual_seed(0), device)
    absorption = torch.full((top.n_polys,), 0.3, device=rays.origin.device)
    return Config5(top, sp, rays, absorption, 2, 1024, topology_s, grid_s)


def config5_batches(n_batches: int = 100, n: int = 1 << 20, device="cuda") -> Iterator:
    """Config 5's rays for a sustained run: ``n_batches`` batches of ``n``
    uniform rays from (20, 20, 20), batch ``b`` drawn on ``device`` from a
    generator there seeded with ``b`` (104,857,600 rays at the defaults,
    the reference's 100M-ray run): a benchmark's ray source."""
    _on(device)
    return (_rays(BIG_SOURCE, n, torch.Generator(device=device).manual_seed(b), device)
            for b in range(n_batches))

