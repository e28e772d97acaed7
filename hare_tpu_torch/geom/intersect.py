"""Branch-free intersection tests: ray-triangle and ray-AABB, in torch.

Counterpart of ``hare_tpu/geom/intersect.py``.  ``kernel_components`` is the
plain PyTorch statement of the ray/triangle test; the CUDA kernels carry the
same arithmetic in ``kernels/csrc/intersect.cuh`` (an epsilon-policy change
must be made in both, and the tests hold them together).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["DET_EPS", "MIN_T", "kernel_components", "ray_aabb"]

# Determinant cutoff: Hare_Geometry_Polygons.cs:406,417 (0.000001).
DET_EPS = 1e-6
# Minimum accepted hit distance: Voxel_Grid.cs:482 (t > 1e-10).
MIN_T = 1e-10


def _pick(idx, X, Y, Z):
    return torch.where(idx == 0, X, torch.where(idx == 1, Y, Z))


def kernel_components(kernel, o_cmp, d_cmp, tri_cmp, unmasked=False):
    """THE ray/triangle test on broadcastable component tensors.

    Args:
      kernel: ``"watertight"`` (Woop/Benthin/Wald 2013 with the FMA-robust
        band ``8 eps (|u|+|v|+|w|)``, det cutoff 0) or ``"mt"`` (two-sided
        Möller–Trumbore with the reference's det cutoff ``DET_EPS``).
      o_cmp, d_cmp: (ox, oy, oz), (dx, dy, dz).
      tri_cmp: (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z).
      unmasked: t/u/v are the raw ray/plane solution (guarded only against
        det == 0) instead of +inf where the bounds fail; ``valid`` is the
        in-bounds test either way.
    Returns: (valid, t, u, v) broadcast over the inputs.
    """
    ox, oy, oz = o_cmp
    dx, dy, dz = d_cmp
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_cmp
    inf = float("inf")
    if kernel == "watertight":
        adx, ady, adz = torch.abs(dx), torch.abs(dy), torch.abs(dz)
        zero = torch.zeros_like(adx, dtype=torch.int64)
        kz = torch.where(
            adx >= ady,
            torch.where(adx >= adz, zero, zero + 2),
            torch.where(ady >= adz, zero + 1, zero + 2),
        )
        kx = (kz + 1) % 3
        ky = (kx + 1) % 3
        dz_r = _pick(kz, dx, dy, dz)
        neg = dz_r < 0.0
        kx_, ky_ = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
        dx_r = _pick(kx_, dx, dy, dz)
        dy_r = _pick(ky_, dx, dy, dz)
        sz = 1.0 / dz_r
        sx = dx_r * sz
        sy = dy_r * sz

        def shear(pxc, pyc, pzc):
            rx, ry, rz = pxc - ox, pyc - oy, pzc - oz
            axp = _pick(kx_, rx, ry, rz)
            ayp = _pick(ky_, rx, ry, rz)
            azp = _pick(kz, rx, ry, rz)
            return axp - sx * azp, ayp - sy * azp, azp

        ax, ay, az = shear(v0x, v0y, v0z)
        bx, by, bz = shear(v0x + e1x, v0y + e1y, v0z + e1z)
        cx, cy, cz = shear(v0x + e2x, v0y + e2y, v0z + e2z)
        u_s = cx * by - cy * bx
        v_s = ax * cy - ay * cx
        w_s = bx * ay - by * ax
        det = u_s + v_s + w_s
        tol = 8.0 * torch.finfo(u_s.dtype).eps * (
            torch.abs(u_s) + torch.abs(v_s) + torch.abs(w_s)
        )
        same_sign = ((u_s >= -tol) & (v_s >= -tol) & (w_s >= -tol)) | (
            (u_s <= tol) & (v_s <= tol) & (w_s <= tol)
        )
        valid = same_sign & (torch.abs(det) > 0.0)
        ok = (det != 0.0) if unmasked else valid
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        t = torch.where(ok, sz * (u_s * az + v_s * bz + w_s * cz) * inv_det, inf)
        return valid, t, v_s * inv_det, w_s * inv_det

    if kernel != "mt":
        raise ValueError(f"unknown kernel {kernel!r}")
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    u_s = tx * px + ty * py + tz * pz
    v_s = dx * qx + dy * qy + dz * qz
    t_s = e2x * qx + e2y * qy + e2z * qz
    # Multiplying by sign(det) unifies the det > eps and det < -eps branches
    # (the det-scaled comparisons of Hare_Geometry_Polygons.cs:483-505).
    s = torch.sign(det)
    valid = (
        (s * u_s >= 0)
        & (s * v_s >= 0)
        & (s * (u_s + v_s) <= s * det)
        & (torch.abs(det) > DET_EPS)
    )
    ok = (det != 0.0) if unmasked else valid
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    t = torch.where(ok, t_s * inv_det, inf)
    return valid, t, u_s * inv_det, v_s * inv_det


def ray_aabb(
    origin: torch.Tensor,
    direction: torch.Tensor,
    box_min: torch.Tensor,
    box_max: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Branchless slab test (``AABB_Main.cs:86-171``).  Returns
    ``(hit, t_near, t_far)``; a zero direction component makes its slab
    "origin inside the slab" with (-inf, +inf) times, never 0 * inf."""
    par = direction == 0
    inv_d = 1.0 / torch.where(par, 1.0, direction)
    t1 = (box_min - origin) * inv_d
    t2 = (box_max - origin) * inv_d
    inf = float("inf")
    in_slab = (origin >= box_min) & (origin <= box_max)
    t_lo = torch.where(
        par, torch.where(in_slab, -inf, inf), torch.minimum(t1, t2)
    )
    t_hi = torch.where(
        par, torch.where(in_slab, inf, -inf), torch.maximum(t1, t2)
    )
    t_near = torch.amax(t_lo, dim=-1)
    t_far = torch.amin(t_hi, dim=-1)
    hit = (t_far >= torch.clamp(t_near, min=0.0)) & (t_far >= 0.0)
    return hit, t_near, t_far
