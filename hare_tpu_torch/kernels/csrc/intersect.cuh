// Ray/triangle and ray/box tests shared by the port's CUDA kernels.
//
// Device twin of hare_tpu_torch/geom/intersect.py (kernel_components,
// ray_aabb), itself the port of hare_tpu/geom/intersect.py:49-177 and
// :228-256.  The arithmetic follows the plain version term by term.  nvcc
// contracts a*b - c*d into FMAs (default -fmad=true); the watertight test's
// band 8*FLT_EPSILON*(|u|+|v|+|w|) exists for exactly that, so a ray through
// a shared edge is still accepted by at least one of its two triangles.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace hare {

// The MT determinant cutoff (Hare_Geometry_Polygons.cs:406,417).
constexpr float kDetEpsMT = 1e-6f;

// One triangle: v0 | e1 | e2, the JAX tri_cmp order.
struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ float pick3(int k, float x, float y, float z) {
  return k == 0 ? x : (k == 1 ? y : z);
}

// Per-ray constants: origin, direction, and the watertight shear
// (dominant axis kz, permuted kx/ky, shear sx/sy/sz).
struct RayC {
  float ox, oy, oz, dx, dy, dz;
  int kx, ky, kz;
  float sx, sy, sz;
};

__device__ __forceinline__ RayC ray_setup(float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  RayC r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const int kz = adx >= ady ? (adx >= adz ? 0 : 2) : (ady >= adz ? 1 : 2);
  int kx = (kz + 1) % 3;
  int ky = (kx + 1) % 3;
  if (pick3(kz, dx, dy, dz) < 0.f) {  // keep the winding: swap kx, ky
    const int tmp = kx; kx = ky; ky = tmp;
  }
  r.kx = kx; r.ky = ky; r.kz = kz;
  r.sz = 1.f / pick3(kz, dx, dy, dz);
  r.sx = pick3(kx, dx, dy, dz) * r.sz;
  r.sy = pick3(ky, dx, dy, dz) * r.sz;
  return r;
}

// Watertight test (Woop, Benthin & Wald 2013), two-sided, det_eps = 0.
// Returns valid; t is +inf where not ok (ok = valid, or det != 0 when
// UNMASKED — the plane solution finalize needs).
template <bool UNMASKED>
__device__ __forceinline__ bool watertight(const RayC& r, const Tri& g,
                                           float& t, float& u, float& v) {
  float px = g.v0x - r.ox, py = g.v0y - r.oy, pz = g.v0z - r.oz;
  const float az = pick3(r.kz, px, py, pz);
  const float ax = pick3(r.kx, px, py, pz) - r.sx * az;
  const float ay = pick3(r.ky, px, py, pz) - r.sy * az;
  px = (g.v0x + g.e1x) - r.ox; py = (g.v0y + g.e1y) - r.oy;
  pz = (g.v0z + g.e1z) - r.oz;
  const float bz = pick3(r.kz, px, py, pz);
  const float bx = pick3(r.kx, px, py, pz) - r.sx * bz;
  const float by = pick3(r.ky, px, py, pz) - r.sy * bz;
  px = (g.v0x + g.e2x) - r.ox; py = (g.v0y + g.e2y) - r.oy;
  pz = (g.v0z + g.e2z) - r.oz;
  const float cz = pick3(r.kz, px, py, pz);
  const float cx = pick3(r.kx, px, py, pz) - r.sx * cz;
  const float cy = pick3(r.ky, px, py, pz) - r.sy * cz;
  const float u_s = cx * by - cy * bx;
  const float v_s = ax * cy - ay * cx;
  const float w_s = bx * ay - by * ax;
  const float det = u_s + v_s + w_s;
  const float tol = 8.f * FLT_EPSILON * (fabsf(u_s) + fabsf(v_s) + fabsf(w_s));
  const bool same_sign = (u_s >= -tol && v_s >= -tol && w_s >= -tol) ||
                         (u_s <= tol && v_s <= tol && w_s <= tol);
  const bool valid = same_sign && fabsf(det) > 0.f;
  const bool ok = UNMASKED ? (det != 0.f) : valid;
  const float inv_det = ok ? 1.f / det : 0.f;
  t = ok ? r.sz * (u_s * az + v_s * bz + w_s * cz) * inv_det : CUDART_INF_F;
  u = v_s * inv_det;
  v = w_s * inv_det;
  return valid;
}

// Two-sided Möller–Trumbore with the reference's det cutoff.
template <bool UNMASKED>
__device__ __forceinline__ bool moller_trumbore(const RayC& r, const Tri& g,
                                                float& t, float& u, float& v) {
  const float px = r.dy * g.e2z - r.dz * g.e2y;
  const float py = r.dz * g.e2x - r.dx * g.e2z;
  const float pz = r.dx * g.e2y - r.dy * g.e2x;
  const float det = g.e1x * px + g.e1y * py + g.e1z * pz;
  const float tx = r.ox - g.v0x, ty = r.oy - g.v0y, tz = r.oz - g.v0z;
  const float qx = ty * g.e1z - tz * g.e1y;
  const float qy = tz * g.e1x - tx * g.e1z;
  const float qz = tx * g.e1y - ty * g.e1x;
  const float u_s = tx * px + ty * py + tz * pz;
  const float v_s = r.dx * qx + r.dy * qy + r.dz * qz;
  const float t_s = g.e2x * qx + g.e2y * qy + g.e2z * qz;
  const float s = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
  const bool valid = s * u_s >= 0.f && s * v_s >= 0.f &&
                     s * (u_s + v_s) <= s * det && fabsf(det) > kDetEpsMT;
  const bool ok = UNMASKED ? (det != 0.f) : valid;
  const float inv_det = ok ? 1.f / det : 0.f;
  t = ok ? t_s * inv_det : CUDART_INF_F;
  u = u_s * inv_det;
  v = v_s * inv_det;
  return valid;
}

template <bool MT, bool UNMASKED>
__device__ __forceinline__ bool tri_test(const RayC& r, const Tri& g, float& t,
                                         float& u, float& v) {
  return MT ? moller_trumbore<UNMASKED>(r, g, t, u, v)
            : watertight<UNMASKED>(r, g, t, u, v);
}

}  // namespace hare
