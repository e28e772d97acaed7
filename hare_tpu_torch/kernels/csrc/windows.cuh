// The window-run test shared by every traversal kernel (K1 grid_shoot,
// B2 tree_shoot, B3 ropes_shoot), so all of them apply one acceptance and
// one tie rule.
//
// Device twin of hare_tpu_torch/accel/common.py test_runs / test_windows,
// itself the port of hare_tpu/accel/common.py test_windows (:125-274).  A
// run is `n_rows` consecutive window rows of `win` triangle slots each, in
// the tri-major layout of common.repack_windows: three float4 of geometry
// (v0 | e1 | e2) and one int4 of ids (tri, poly, top) per slot.  Acceptance:
// tid >= 0 (null slots hold -1), poly in neither exclusion slot, top ==
// top_index when top_index >= 0, valid, t > min_t; the nearest t wins, and
// on equal t the lowest triangle id.
#pragma once

#include "intersect.cuh"

namespace hare {

// min / max that propagate NaN, as torch.minimum / jnp.minimum do (fminf
// and fmaxf drop a NaN operand).
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct RunFilter {
  int ex0, ex1;    // the ray's excluded polygons
  int top_index;   // -1 = no topology filter
  float min_t;
};

template <bool MT>
__device__ __forceinline__ void test_run(const RayC& ray, const float4* __restrict__ win_geom,
                                         const int4* __restrict__ win_ids, int row0,
                                         int n_rows, int win, const RunFilter& f,
                                         float& best_t, int& best_tri) {
  const int slot_end = (row0 + n_rows) * win;
  for (int slot = row0 * win; slot < slot_end; ++slot) {
    const int4 id = __ldg(&win_ids[slot]);  // (tri, poly, top, -)
    if (id.x < 0 || id.y == f.ex0 || id.y == f.ex1 ||
        (f.top_index >= 0 && id.z != f.top_index))
      continue;
    const float4 a = __ldg(&win_geom[3 * slot]);
    const float4 b = __ldg(&win_geom[3 * slot + 1]);
    const float4 c = __ldg(&win_geom[3 * slot + 2]);
    const Tri tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    float t, u, v;
    if (tri_test<MT, false>(ray, tri, t, u, v) && t > f.min_t &&
        (t < best_t || (t == best_t && id.x < best_tri))) {
      best_t = t;
      best_tri = id.x;
    }
  }
}

}  // namespace hare
