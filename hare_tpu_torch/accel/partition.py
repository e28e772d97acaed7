"""The public query facade: ``SpatialPartition`` (reference L4 contract).

Counterpart of ``hare_tpu/accel/partition.py``: ``model`` (the topologies),
``char_step`` (min voxel dimension) and ``shoot`` with origin-polygon
exclusion riding on ``Ray.exclude_poly``.  Only the voxel grid is ported.
The JAX package's shoot-time knobs (``cap``, ``soft``, ``tier``, ``cap_s``,
``march``) size its TPU candidate buffers and traversal rounds; the port's
one-thread-per-ray kernel has neither, so they raise instead of being
silently dropped.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from ..mesh.topology import Topology, build_scene
from .common import check_kernel
from .voxel import VoxelGrid, build_voxel_grid, shoot_grid

__all__ = ["SpatialPartition"]

_NOT_PORTED = ("brute", "octree", "kdtree", "kdtree_ropes")


class SpatialPartition:
    """Scene + acceleration structure behind one ``shoot`` API.

    accel: ``"grid"`` (``domain``/``max_doublings``/``avg_polys``/``pad``/
    ``win`` pass to :func:`build_voxel_grid`).  kernel: ``"watertight"``
    (default) or ``"mt"``.  device: where the scene and grid live; CUDA
    devices run the kernels, the CPU runs their plain versions.
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
        device=None,
        **params,
    ):
        if accel in _NOT_PORTED:
            raise NotImplementedError(
                f"accel={accel!r} is not ported yet; the port has 'grid'"
            )
        if accel != "grid":
            raise ValueError(f"unknown accel {accel!r}")
        for name, val in (("cap", cap), ("march", march), ("soft", soft),
                          ("tier", tier), ("cap_s", cap_s)):
            if val is not None:
                raise ValueError(
                    f"{name}={val!r} is a TPU traversal knob (candidate "
                    "buffers and rounds); the port's kernel has none"
                )
        check_kernel(kernel)
        if isinstance(model, Topology):
            model = [model]
        self.model = list(model)
        self.kernel = kernel
        self.scene: Scene = build_scene(self.model, device=device)
        self.struct: VoxelGrid = build_voxel_grid(self.model, device=device, **params)
        self.char_step = self.struct.char_step
        self._shoot_fn = None

    def shoot(self, rays: Ray, top_index: Optional[int] = None) -> HitRecord:
        """``Spatial_Partition.Shoot``; ``top_index`` filters candidates to
        one topology at test time (the same answer as the JAX package's
        per-topology grid)."""
        return shoot_grid(
            self.scene, rays, self.struct, kernel=self.kernel, top_index=top_index
        )

    @property
    def aux(self) -> VoxelGrid:
        """The accel structure, for ``trace_rays(..., aux=...)``."""
        return self.struct

    @property
    def shoot_fn(self) -> Callable[..., HitRecord]:
        """``(scene, rays[, aux]) -> HitRecord`` for :func:`trace_rays`;
        ``aux`` replaces the constructor-built grid when given.  The same
        callable on every access."""
        if self._shoot_fn is None:
            kernel, struct = self.kernel, self.struct

            def fn(scene, rays, aux=None):
                return shoot_grid(
                    scene, rays, struct if aux is None else aux, kernel=kernel
                )

            self._shoot_fn = fn
        return self._shoot_fn
