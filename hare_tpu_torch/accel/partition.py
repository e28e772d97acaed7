"""The public query facade: ``SpatialPartition`` (reference L4 contract).

Counterpart of ``hare_tpu/accel/partition.py``: ``model`` (the topologies),
``char_step`` and ``shoot`` over ``brute | grid | octree | kdtree |
kdtree_ropes``, with origin-polygon exclusion riding on
``Ray.exclude_poly``.  The JAX package's shoot-time knobs (``cap``,
``soft``, ``tier``, ``cap_s``, ``march``) size its TPU candidate buffers
and traversal rounds; the port's one-thread-per-ray kernels have neither,
so they raise for every backend instead of being silently dropped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from ..mesh.topology import Topology, build_scene
from .brute import shoot_brute
from .common import check_kernel
from .kdtree import build_kdtree, shoot_kdtree
from .octree import build_octree, shoot_octree
from .ropes import build_kdtree_ropes, shoot_kdtree_ropes
from .voxel import build_voxel_grid, shoot_grid

__all__ = ["ACCELS", "SpatialPartition"]

# backend -> (builder, shoot function); brute has no structure.
_BACKENDS = {
    "brute": (None, shoot_brute),
    "grid": (build_voxel_grid, shoot_grid),
    "octree": (build_octree, shoot_octree),
    "kdtree": (build_kdtree, shoot_kdtree),
    "kdtree_ropes": (build_kdtree_ropes, shoot_kdtree_ropes),
}
ACCELS = tuple(_BACKENDS)


class SpatialPartition:
    """Scene + acceleration structure behind one ``shoot`` API.

    accel: one of :data:`ACCELS`; build parameters pass to the builder
    (``domain``/``avg_polys``/... for the grid, ``max_depth``/
    ``max_tris_per_node``/... for the trees; brute takes ``tri_tile``, the
    plain version's tile).  kernel: ``"watertight"`` (default) or ``"mt"``.
    device: where the scene and structure live, ``"cuda"`` unless the
    caller asks for another; CUDA devices run the kernels, the CPU runs
    their plain versions.
    """

    def __init__(
        self,
        model: Union[Topology, Sequence[Topology]],
        accel: str = "grid",
        kernel: str = "watertight",
        cap: Optional[int] = None,
        march: Optional[int] = None,
        soft: Optional[int] = None,
        tier: Optional[int] = None,
        cap_s: Optional[int] = None,
        device="cuda",
        **params,
    ):
        if accel not in _BACKENDS:
            raise ValueError(f"unknown accel {accel!r}; expected one of {ACCELS}")
        for name, val in (("cap", cap), ("march", march), ("soft", soft),
                          ("tier", tier), ("cap_s", cap_s)):
            if val is not None:
                raise ValueError(
                    f"{name}={val!r} is a TPU traversal knob (candidate "
                    "buffers and rounds); the port's kernels have none"
                )
        check_kernel(kernel)
        if isinstance(model, Topology):
            model = [model]
        self.model = list(model)
        self.kernel = kernel
        self.scene: Scene = build_scene(self.model, device=device)
        builder, self._raw = _BACKENDS[accel]
        if builder is None:  # brute: no structure; params are shoot params
            self.struct, self._params = None, params
            # Char_Step analog for brute force: smallest triangle edge.
            tri = np.concatenate([t.vertices[t.tri_v] for t in self.model])
            e = np.linalg.norm(tri - np.roll(tri, 1, axis=1), axis=2)
            self.char_step = float(e[e > 0].min()) if (e > 0).any() else 1.0
        else:
            self.struct, self._params = builder(self.model, device=device, **params), {}
            if accel in ("grid", "kdtree_ropes"):
                self.char_step = self.struct.char_step
            else:  # partition.py:93-104: ext / 2^depth, KD depth capped at 16
                ext = float((self.struct.root_max - self.struct.root_min).min())
                depth = self.struct.max_depth
                self.char_step = ext / (2 ** (depth if accel == "octree" else min(depth, 16)))
        self._shoot_fn = None

    def _run(self, scene, rays, struct, top_index=None) -> HitRecord:
        if self.struct is None:
            return self._raw(scene, rays, self.kernel, top_index=top_index, **self._params)
        return self._raw(scene, rays, struct, self.kernel, top_index=top_index)

    def shoot(self, rays: Ray, top_index: Optional[int] = None) -> HitRecord:
        """``Spatial_Partition.Shoot``; ``top_index`` filters candidates to
        one topology at test time (the same answer as the JAX package's
        per-topology grid)."""
        return self._run(self.scene, rays, self.struct, top_index)

    @property
    def aux(self):
        """The accel structure (None for brute), for ``trace_rays(...,
        aux=...)``."""
        return self.struct

    @property
    def shoot_fn(self) -> Callable[..., HitRecord]:
        """``(scene, rays[, aux]) -> HitRecord`` for :func:`trace_rays`;
        ``aux`` replaces the constructor-built structure when given (brute
        ignores it).  The same callable on every access."""
        if self._shoot_fn is None:
            run, struct = self._run, self.struct

            def fn(scene, rays, aux=None):
                return run(scene, rays, struct if aux is None else aux)

            self._shoot_fn = fn
        return self._shoot_fn
