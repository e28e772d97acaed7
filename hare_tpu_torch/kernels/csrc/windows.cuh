// The window-run test shared by every traversal kernel, so all of them
// apply one acceptance and one tie rule: test_run for one thread per ray (B2
// tree_shoot, B3 ropes_shoot), test_run_group for a group of lanes per ray
// (K1 grid_shoot).
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

// Hit key of "no accepted candidate": above every key of a real hit.
constexpr unsigned long long kNoHitKey = ~0ull;

// The same run test, shared by the G lanes of one group that hold the same
// ray (G = 8, 16 or 32, groups aligned within the warp; every lane passes the
// same ray, run and best hit).  Lane k of the group tests slots k, k + G,
// k + 2G, ... of the run's n_rows * win slots: it loads the slot's ids and
// its three geometry float4 together, with no branch between them, and
// neighbouring lanes read neighbouring slots.  The group then takes the
// minimum of the hit key bits(t) << 32 | tri over its lanes with
// __shfl_xor_sync; for the positive t of an accepted hit this is the
// nearest t, and on equal t the lowest triangle id — the result of
// test_run, since that rule is a lexicographic minimum, whatever the order
// of the slots.  Every lane returns with the group's best hit.
template <bool MT, int G>
__device__ __forceinline__ void test_run_group(const RayC& ray, const float4* __restrict__ win_geom,
                                               const int4* __restrict__ win_ids, int row0,
                                               int n_rows, int win, const RunFilter& f,
                                               int lane, unsigned mask, float& best_t,
                                               int& best_tri) {
  float lane_t = best_t;
  int lane_tri = best_tri;
  const int slot_end = (row0 + n_rows) * win;
  for (int slot = row0 * win + lane; slot < slot_end; slot += G) {
    const int4 id = __ldg(&win_ids[slot]);  // (tri, poly, top, -)
    const float4 a = __ldg(&win_geom[3 * slot]);
    const float4 b = __ldg(&win_geom[3 * slot + 1]);
    const float4 c = __ldg(&win_geom[3 * slot + 2]);
    const Tri tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
    float t, u, v;
    const bool valid = tri_test<MT, false>(ray, tri, t, u, v);
    if (valid && t > f.min_t && id.x >= 0 && id.y != f.ex0 && id.y != f.ex1 &&
        (f.top_index < 0 || id.z == f.top_index) &&
        (t < lane_t || (t == lane_t && id.x < lane_tri))) {
      lane_t = t;
      lane_tri = id.x;
    }
  }
  unsigned long long key =
      lane_tri < 0 ? kNoHitKey
                   : (static_cast<unsigned long long>(__float_as_uint(lane_t)) << 32) |
                         static_cast<unsigned>(lane_tri);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(mask, key, off, G);
    key = other < key ? other : key;
  }
  if (key != kNoHitKey) {
    best_t = __uint_as_float(static_cast<unsigned>(key >> 32));
    best_tri = static_cast<int>(key & 0xFFFFFFFFu);
  }
}

}  // namespace hare
