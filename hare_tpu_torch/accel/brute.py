"""Brute-force ray casting: every ray against every triangle.

Counterpart of ``hare_tpu/accel/brute.py`` — the "no acceleration structure"
baseline (``BASELINE.json`` config 1) and the referee every accel structure
must agree with.  :func:`brute_shoot` is B1 (``kernels/csrc/brute_shoot.cu``,
one thread per ray, triangles staged in shared-memory tiles) for CUDA
tensors and :func:`brute_shoot_plain` — a tiled (rays x tris) test — for
CPU tensors.  The winner goes through K2 (``finalize_hits``) for its
``HitRecord``, as for every other backend.

Acceptance (``Voxel_Grid.cs:475-499``, JAX ``brute.py:106-119``): valid,
``t > min_t``, the polygon is in neither exclusion slot, ``tri_poly != -2``
(padding rows), ``tri_top == top_index`` when given; the nearest t wins and
on equal t the lowest triangle index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geom.intersect import MIN_T, ray_triangle_mt, ray_triangle_watertight
from ..geom.primitives import HitRecord, Ray
from ..kernels import build
from ..mesh.scene import PAD_POLY, Scene
from .common import (
    NO_HIT_KEY,
    check_device,
    check_kernel,
    check_rays,
    detach_rays,
    finalize_hits,
    hit_key,
    key_to_hit,
)

__all__ = ["brute_shoot", "brute_shoot_args", "brute_shoot_plain", "shoot_brute"]


def brute_shoot(
    scene: Scene,
    rays: Ray,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    tri_tile: int = 2048,
    top_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1: nearest accepted hit over all triangles, ``(best_t (N,) f32 — inf
    on miss, best_tri (N,) i32 — -1 on miss)``.

    CUDA tensors launch ``kernels/csrc/brute_shoot.cu``; CPU tensors take
    :func:`brute_shoot_plain`, whose tiles ``tri_tile`` sizes (the kernel's
    shared-memory tile is its own constant).
    """
    check_kernel(kernel)
    check_rays(rays)
    rays = detach_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    kind = check_device(o, d, ex, scene.tri_geom, scene.tri_meta)
    if kind == "cpu":
        return brute_shoot_plain(scene, rays, kernel, min_t, tri_tile, top_index)
    n, n_tris = o.shape[0], scene.tri_geom.shape[0]
    if scene.tri_geom.shape != (n_tris, 9) or scene.tri_meta.shape != (n_tris, 8):
        raise ValueError("brute_shoot: scene.tri_geom / tri_meta shapes disagree")
    best_t = torch.empty(n, dtype=torch.float32, device=o.device)
    best_tri = torch.empty(n, dtype=torch.int32, device=o.device)
    args = brute_shoot_args(scene, rays, best_t, best_tri, kernel, min_t, top_index)
    brute_shoot.launches += 1
    build.launch("hare_brute_shoot", *args)
    return best_t, best_tri


brute_shoot.launches = 0


def brute_shoot_args(
    scene: Scene,
    rays: Ray,
    best_t: torch.Tensor,
    best_tri: torch.Tensor,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    top_index: Optional[int] = None,
) -> tuple:
    """The arguments of the C entry point ``hare_brute_shoot`` up to the
    outputs (tensors as tensors, for :func:`~..kernels.build.launch`); the
    stream follows."""
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    return (o.contiguous(), d.contiguous(), ex.contiguous(), o.shape[0],
            scene.tri_geom.contiguous(), scene.tri_meta.contiguous(), scene.tri_geom.shape[0],
            float(min_t), -1 if top_index is None else int(top_index),
            int(kernel == "mt"), best_t, best_tri)


def brute_shoot_plain(
    scene: Scene,
    rays: Ray,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    tri_tile: int = 2048,
    top_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B1: ``tri_tile`` triangles at a time, an (N, tile)
    test through the vector wrappers, each tile folded into the rays' best
    hit keys.  ``tri_tile`` changes nothing but the tiling."""
    check_kernel(kernel)
    check_rays(rays)
    o, d, ex = rays.origin, rays.direction, rays.exclude_poly
    test = ray_triangle_mt if kernel == "mt" else ray_triangle_watertight
    v, tv = scene.vertices.detach(), scene.tri_v.long()
    poly, top = scene.tri_meta[:, 0], scene.tri_meta[:, 7]
    best = torch.full((o.shape[0],), NO_HIT_KEY, dtype=torch.int64, device=o.device)
    for s in range(0, tv.shape[0], tri_tile):
        tv_s, p = tv[s : s + tri_tile], poly[s : s + tri_tile]
        valid, t, _, _ = test(o[:, None], d[:, None], v[tv_s[:, 0]], v[tv_s[:, 1]], v[tv_s[:, 2]])
        acc = (
            valid
            & (t > min_t)
            & (p != ex[:, 0:1])
            & (p != ex[:, 1:2])
            & (p != PAD_POLY)
        )
        if top_index is not None:
            acc &= top[s : s + tri_tile] == top_index
        ids = torch.arange(s, s + tv_s.shape[0], dtype=torch.int32, device=o.device)
        key = torch.where(acc, hit_key(t, ids), NO_HIT_KEY)
        best = torch.minimum(best, key.amin(dim=1))
    return key_to_hit(best)


def shoot_brute(
    scene: Scene,
    rays: Ray,
    kernel: str = "watertight",
    min_t: float = MIN_T,
    tri_tile: int = 2048,
    top_index: Optional[int] = None,
) -> HitRecord:
    """Nearest-hit query over all triangles: B1 then K2 (``finalize_hits``)."""
    best_t, best_tri = brute_shoot(scene, rays, kernel, min_t, tri_tile, top_index)
    return finalize_hits(scene, rays, best_t, best_tri, kernel)
