// K2 finalize_hits (forward): the hit record of each ray's winning triangle.
//
// Replaces the XLA program of hare_tpu/accel/common.py finalize_hits
// (:437-473) with the _hit_vals forward (:400-416, _vals_from_comps
// :367-384): gather the winner's packed row, re-solve t, u, v on its plane
// (UNMASKED — the fixed-hit-topology value), take cross(e1, e2) as the
// normal, and mask misses.  It also hands the bounce step the coplanar edge
// neighbours (JAX tri_geom lanes 10-12, here tri_meta lanes 1-3).
//
// A separate launch, not K1's epilogue: K1 stays a pure (best_t, best_tri)
// query like the JAX traversal, and this kernel is a few percent of K1.
// What bounds it on the H100: one 36-byte geometry row and one 16-byte id
// row gathered per ray, and ~25 floats written per ray — memory traffic of
// about 150 bytes a ray, so at 32k rays it is launch-latency bound.  The
// design reads the id lanes as one int4 and keeps everything else scalar.
#include "intersect.cuh"

namespace {

template <bool MT>
__global__ void __launch_bounds__(256)
finalize_kernel(const float* __restrict__ tri_geom, const int4* __restrict__ tri_meta,
                const float* __restrict__ best_t, const int* __restrict__ best_tri,
                const float* __restrict__ o, const float* __restrict__ d, int n,
                bool* __restrict__ hit_out, float* __restrict__ t_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                float* __restrict__ point_out, int* __restrict__ poly_out,
                int* __restrict__ tri_out, float* __restrict__ normal_out,
                int* __restrict__ nbr_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool hit = isfinite(best_t[i]);
  const int tri = max(best_tri[i], 0);
  const float* row = tri_geom + 9 * static_cast<long long>(tri);
  const hare::Tri g{row[0], row[1], row[2], row[3], row[4],
                    row[5], row[6], row[7], row[8]};
  const int4 meta = tri_meta[2 * static_cast<long long>(tri)];  // lanes 0-3
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const hare::RayC ray = hare::ray_setup(ox, oy, oz, dx, dy, dz);
  float t, u, v;
  hare::tri_test<MT, true>(ray, g, t, u, v);
  const float th = hit ? t : 0.f;  // keeps miss lanes finite (common.py:460)

  hit_out[i] = hit;
  t_out[i] = hit ? t : CUDART_INF_F;
  u_out[i] = hit ? u : 0.f;
  v_out[i] = hit ? v : 0.f;
  point_out[3 * i] = hit ? ox + th * dx : 0.f;
  point_out[3 * i + 1] = hit ? oy + th * dy : 0.f;
  point_out[3 * i + 2] = hit ? oz + th * dz : 0.f;
  poly_out[i] = hit ? meta.x : -1;
  tri_out[i] = hit ? tri : -1;
  normal_out[3 * i] = g.e1y * g.e2z - g.e1z * g.e2y;
  normal_out[3 * i + 1] = g.e1z * g.e2x - g.e1x * g.e2z;
  normal_out[3 * i + 2] = g.e1x * g.e2y - g.e1y * g.e2x;
  nbr_out[3 * i] = meta.y;
  nbr_out[3 * i + 1] = meta.z;
  nbr_out[3 * i + 2] = meta.w;
}

}  // namespace

// tri_geom (T, 9) f32, tri_meta (T, 8) i32; mt: 0 watertight, 1 MT.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_finalize_hits(const float* tri_geom, const int* tri_meta,
                                  const float* best_t, const int* best_tri,
                                  const float* o, const float* d, int n, int mt,
                                  bool* hit, float* t, float* u, float* v,
                                  float* point, int* poly, int* tri, float* normal,
                                  int* nbr, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* meta = reinterpret_cast<const int4*>(tri_meta);
    if (mt)
      finalize_kernel<true><<<blocks, threads, 0, s>>>(tri_geom, meta, best_t, best_tri, o, d, n,
                                                       hit, t, u, v, point, poly, tri, normal, nbr);
    else
      finalize_kernel<false><<<blocks, threads, 0, s>>>(tri_geom, meta, best_t, best_tri, o, d, n,
                                                        hit, t, u, v, point, poly, tri, normal, nbr);
  }
  return static_cast<int>(cudaGetLastError());
}
