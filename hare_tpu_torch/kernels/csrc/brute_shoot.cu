// B1 brute_shoot: nearest hit over every triangle, one thread per ray.
//
// Replaces hare_tpu/accel/brute.py shoot_brute (:63-141), a lax.scan over
// tri_tile tiles of an (N x tile) test followed by a per-tile argmin.  Here
// each block of kThreads rays stages kTile triangles at a time in shared
// memory (v0|e1|e2 from scene.tri_geom, poly and top from scene.tri_meta),
// and every thread tests its ray against the whole tile, keeping a running
// (best_t, best_tri).  Triangles come in ascending order, so with the rule
// t < best || (t == best && tri < best_tri) the lowest index wins ties, as
// the JAX argmin does.
//
// What bounds it on the H100: FP32 arithmetic.  Every ray meets every
// triangle — 32,768 x 81,932 = 2.7e9 watertight tests (~50 flops each) per
// shoot on the bench scene — and every thread of a warp reads the same
// shared-memory triangle (a broadcast), so the kernel is compute-bound with
// no divergence beyond the accept branch.  The design keeps the ray in
// registers and reads each triangle from device memory once per block.
//
// Acceptance (brute.py:106-119): valid, t > min_t, poly in neither exclusion
// slot, poly != -2 (padding rows), top == top_index when top_index >= 0.
#include <limits>

#include "intersect.cuh"

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kThreads = 128;
constexpr int kTile = 128;  // triangles staged per shared-memory tile
constexpr int kPadPoly = -2;

template <bool MT>
__global__ void __launch_bounds__(kThreads)
brute_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const int* __restrict__ ex, int n, const float* __restrict__ tri_geom,
                   const int* __restrict__ tri_meta, int n_tris, float min_t,
                   int top_index, float* __restrict__ best_t_out,
                   int* __restrict__ best_tri_out) {
  __shared__ float s_geom[kTile * 9];
  __shared__ int s_poly[kTile];
  __shared__ int s_top[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const int r = live ? i : 0;
  const hare::RayC ray = hare::ray_setup(o[3 * r], o[3 * r + 1], o[3 * r + 2],
                                         d[3 * r], d[3 * r + 1], d[3 * r + 2]);
  const int ex0 = ex[2 * r], ex1 = ex[2 * r + 1];
  float best_t = kInf;
  int best_tri = -1;

  for (int base = 0; base < n_tris; base += kTile) {
    const int m = min(kTile, n_tris - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < m * 9; k += blockDim.x)
      s_geom[k] = tri_geom[9 * base + k];
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      s_poly[k] = tri_meta[8 * (base + k)];
      s_top[k] = tri_meta[8 * (base + k) + 7];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < m; ++k) {
      const int poly = s_poly[k];
      if (poly == kPadPoly || poly == ex0 || poly == ex1 ||
          (top_index >= 0 && s_top[k] != top_index))
        continue;
      const float* g = &s_geom[9 * k];
      const hare::Tri tri{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8]};
      float t, u, v;
      const int id = base + k;
      if (hare::tri_test<MT, false>(ray, tri, t, u, v) && t > min_t &&
          (t < best_t || (t == best_t && id < best_tri))) {
        best_t = t;
        best_tri = id;
      }
    }
  }
  if (live) {
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
  }
}

}  // namespace

// tri_geom (n_tris, 9) f32 v0|e1|e2; tri_meta (n_tris, 8) i32, lane 0 poly,
// lane 7 top.  top_index -1 = no filter; mt 0 watertight, 1 MT.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_brute_shoot(const float* o, const float* d, const int* ex, int n,
                                const float* tri_geom, const int* tri_meta, int n_tris,
                                float min_t, int top_index, int mt, float* best_t,
                                int* best_tri, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (mt)
      brute_shoot_kernel<true><<<blocks, kThreads, 0, s>>>(
          o, d, ex, n, tri_geom, tri_meta, n_tris, min_t, top_index, best_t, best_tri);
    else
      brute_shoot_kernel<false><<<blocks, kThreads, 0, s>>>(
          o, d, ex, n, tri_geom, tri_meta, n_tris, min_t, top_index, best_t, best_tri);
  }
  return static_cast<int>(cudaGetLastError());
}
