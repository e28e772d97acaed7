// A3 finalize_hits backward: the VJP of the hit record w.r.t. the live
// vertices, the ray origins and the ray directions.
//
// Replaces the XLA program of hare_tpu/accel/common.py _hit_vals_bwd
// (:424-431): jax.vjp of the live recompute _vals_live (:387-397) — the
// winning triangle's (t, u, v, normal), unmasked, from the current vertices
// gathered through its vertex ids — together with the point
// o + where(hit, t, 0) d that finalize_hits builds around it (:460-462).
// One thread a ray.  It gathers the three live vertices through tri_meta
// lanes 4-6 and writes d(origin) and d(direction) (N, 3), and one cotangent
// for each of the triangle's corners with that corner's vertex id: (3N, 3)
// values and (3N,) keys, which scatter_add_ordered (scatter.cu) sums onto
// the (V, 3) vertices in a fixed order.  An absent cotangent (a null
// pointer: an output no loss reaches) reads as +0.0, the bits of the zeros
// autograd would otherwise fill in.
//
// The VJP is in closed form.  In exact arithmetic both triangle tests
// (watertight and Möller-Trumbore, intersect.cuh) give the same unmasked
// ray/plane solution: with s = o - v0, P = d x e2, Q = s x e1, det = e1.P,
// t = e2.Q / det, u = s.P / det and v = d.Q / det, each numerator and det a
// triple product [a, b, c] = a.(b x c), whose partials are b x c, c x a and
// a x b.  So one backward serves both tests; it differs from autograd
// through the watertight shear form by rounding only.  det == 0 gives (t,
// u, v) a zero gradient, as the JAX package's double where does.  A miss's
// t, u, v and point are constants (inf, 0, 0, 0), so only its normal's
// cotangent reaches its triangle's corners (triangle 0, as in the forward).
//
// What bounds it on the H100: bytes, about 140 B a ray (the ray, its
// winner, the forward t and hit, 11 cotangent floats in; 6 ray cotangents,
// 3 keys and 9 corner cotangents out) and the distinct vertex and id rows
// it gathers.  A hit ray takes ~200 operations, far below the FP32 roof.
// The design feeds the bytes (PERF.md §6, kernel_sweep.py case a3):
//   - blocks of kBlock = 128 threads, so several blocks of each SM are in
//     flight on 32,768 rays;
//   - every per-ray load is issued first, unconditionally; only best_tri ->
//     tri_meta -> the three vertex rows stays a chain of dependent loads;
//   - a whole block's (N, 3) input rows (3 kBlock contiguous floats an
//     array) and all four outputs pass through shared memory and move as
//     16-byte loads and stores: a per-ray store3 writes 4 B in every 12 or
//     36 of each warp-wide store.  A block that is not whole, or an array
//     whose address is not 16-byte aligned (a view at an odd storage
//     offset), takes per-ray scalar loads and stores instead: the same
//     values, moved otherwise.
// Which way the rows move changes no arithmetic: built with -fmad=false,
// every output has the bits of the plain per-ray statements below.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // rays a block; a multiple of 4
constexpr int kRow = 3 * kBlock;  // floats of a block's (N, 3) rows
constexpr int kStaged = 4;       // (N, 3) inputs staged: o, d, g_point, g_normal

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* p, long long i, V3 a) {
  p[3 * i] = a.x;
  p[3 * i + 1] = a.y;
  p[3 * i + 2] = a.z;
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// A ray's cotangent, or +0.0 where the cotangent is absent.
__device__ __forceinline__ float cotangent(const float* g, int i) { return g ? g[i] : 0.f; }

__global__ void __launch_bounds__(kBlock)
finalize_bwd_kernel(const float* __restrict__ vertices, const int4* __restrict__ tri_meta,
                    const int* __restrict__ best_tri, const float* __restrict__ t_fwd,
                    const bool* __restrict__ hit, const float* __restrict__ o,
                    const float* __restrict__ d, const float* __restrict__ g_t,
                    const float* __restrict__ g_u, const float* __restrict__ g_v,
                    const float* __restrict__ g_point, const float* __restrict__ g_normal, int n,
                    float* __restrict__ d_o, float* __restrict__ d_d, int* __restrict__ keys,
                    float* __restrict__ d_corner) {
  // Staged rows: the four (N, 3) inputs in, then d_o, d_d, keys (as bits)
  // and d_corner out, each at the block's own offsets.
  __shared__ __align__(16) float rows_in[kStaged * kRow];
  __shared__ __align__(16) float rows_out[6 * kRow];
  const int base = blockIdx.x * kBlock;
  const int i = base + threadIdx.x;
  const bool live = i < n;
  // Block-uniform: a whole block, and every (N, 3) array it moves as
  // 16-byte words aligned.
  const bool vec = n - base >= kBlock && aligned16(o) && aligned16(d) && aligned16(g_point) &&
                   aligned16(g_normal) && aligned16(d_o) && aligned16(d_d) && aligned16(keys) &&
                   aligned16(d_corner);

  // ---- every load that needs nothing but i, issued before the chain.
  const int tri = live ? max(best_tri[i], 0) : 0;
  const bool is_hit = live && hit[i];
  const float t_i = live ? t_fwd[i] : 0.f;
  const float g_t_i = live ? cotangent(g_t, i) : 0.f;
  const float g_u_i = live ? cotangent(g_u, i) : 0.f;
  const float g_v_i = live ? cotangent(g_v, i) : 0.f;
  constexpr int kWords = kStaged * kRow / 4;  // 16-byte words staged a block
  constexpr int kEach = (kWords + kBlock - 1) / kBlock;
  float4 in[kEach];
  if (vec) {
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int w = threadIdx.x + k * kBlock;
      const int a = w / (kRow / 4), off = w % (kRow / 4);
      const float* src = a == 0 ? o : a == 1 ? d : a == 2 ? g_point : g_normal;
      in[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < kWords && src != nullptr)
        in[k] = reinterpret_cast<const float4*>(src + 3LL * base)[off];
    }
  }
  // ---- the chain: the winner's vertex ids, then its three live vertices.
  const int4 iv = tri_meta[2 * static_cast<long long>(tri) + 1];  // lanes 4-7: tri_v, tri_top
  const V3 v0 = load3(vertices, iv.x), v1 = load3(vertices, iv.y), v2 = load3(vertices, iv.z);
  V3 ro, rd, gp, gn;
  if (vec) {
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      const int w = threadIdx.x + k * kBlock;
      if (w < kWords) reinterpret_cast<float4*>(rows_in)[w] = in[k];
    }
    __syncthreads();
    const int r = 3 * threadIdx.x;
    ro = V3{rows_in[r], rows_in[r + 1], rows_in[r + 2]};
    rd = V3{rows_in[kRow + r], rows_in[kRow + r + 1], rows_in[kRow + r + 2]};
    gp = V3{rows_in[2 * kRow + r], rows_in[2 * kRow + r + 1], rows_in[2 * kRow + r + 2]};
    gn = V3{rows_in[3 * kRow + r], rows_in[3 * kRow + r + 1], rows_in[3 * kRow + r + 2]};
  } else {
    const V3 zero{0.f, 0.f, 0.f};
    ro = live ? load3(o, i) : zero;
    rd = live ? load3(d, i) : zero;
    gp = live && g_point ? load3(g_point, i) : zero;
    gn = live && g_normal ? load3(g_normal, i) : zero;
  }

  const V3 e1 = v1 - v0, e2 = v2 - v0;
  // normal = e1 x e2: d(g.(e1 x e2)) = de1.(e2 x g) + de2.(g x e1).
  V3 ge1 = cross(e2, gn), ge2 = cross(gn, e1);
  V3 gs{0.f, 0.f, 0.f}, go{0.f, 0.f, 0.f}, gd{0.f, 0.f, 0.f};
  if (is_hit) {
    // point = o + t d: its cotangent adds to o, d and t.
    const float gt = g_t_i + dot(gp, rd);
    go = gp;
    gd = t_i * gp;
    const V3 s = ro - v0;
    const V3 P = cross(rd, e2), Q = cross(s, e1);
    const float det = dot(e1, P);
    if (det != 0.f) {
      const float inv = 1.f / det;
      const float t = dot(e2, Q) * inv, u = dot(s, P) * inv, v = dot(rd, Q) * inv;
      const float gu = g_u_i, gv = g_v_i;
      // Cotangents of the numerators [e2, s, e1], [s, d, e2], [d, s, e1]
      // and of det = [e1, d, e2].
      const float a_t = gt * inv, a_u = gu * inv, a_v = gv * inv;
      const float a_det = -((gt * t + gu * u) + gv * v) * inv;
      gs = (a_u * P + a_v * cross(e1, rd)) + a_t * cross(e1, e2);
      gd = gd + ((a_det * cross(e2, e1) + a_u * cross(e2, s)) + a_v * Q);
      ge1 = ge1 + ((a_det * P + a_v * cross(rd, s)) + a_t * cross(e2, s));
      ge2 = ge2 + ((a_det * cross(e1, rd) + a_u * cross(s, rd)) + a_t * Q);
    }
  }
  // s = o - v0, e1 = v1 - v0, e2 = v2 - v0.
  const V3 zero{0.f, 0.f, 0.f};
  const V3 g_o = go + gs, c0 = ((zero - gs) - ge1) - ge2;
  if (!vec) {
    if (!live) return;
    store3(d_o, i, g_o);
    store3(d_d, i, gd);
    keys[3 * i] = iv.x;
    keys[3 * i + 1] = iv.y;
    keys[3 * i + 2] = iv.z;
    store3(d_corner, 3 * static_cast<long long>(i), c0);
    store3(d_corner, 3 * static_cast<long long>(i) + 1, ge1);
    store3(d_corner, 3 * static_cast<long long>(i) + 2, ge2);
    return;
  }
  // ---- the block's outputs through shared memory, 16 bytes a store.
  float* s_o = rows_out;
  float* s_d = rows_out + kRow;
  int* s_keys = reinterpret_cast<int*>(rows_out + 2 * kRow);
  float* s_corner = rows_out + 3 * kRow;
  store3(s_o, threadIdx.x, g_o);
  store3(s_d, threadIdx.x, gd);
  s_keys[3 * threadIdx.x] = iv.x;
  s_keys[3 * threadIdx.x + 1] = iv.y;
  s_keys[3 * threadIdx.x + 2] = iv.z;
  store3(s_corner, 3 * threadIdx.x, c0);
  store3(s_corner, 3 * threadIdx.x + 1, ge1);
  store3(s_corner, 3 * threadIdx.x + 2, ge2);
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(rows_out);
  constexpr int kQ = kRow / 4;  // 16-byte words of a (kBlock, 3) block
  for (int w = threadIdx.x; w < 6 * kQ; w += kBlock) {
    if (w < kQ)
      reinterpret_cast<float4*>(d_o + 3LL * base)[w] = src[w];
    else if (w < 2 * kQ)
      reinterpret_cast<float4*>(d_d + 3LL * base)[w - kQ] = src[w];
    else if (w < 3 * kQ)
      reinterpret_cast<float4*>(keys + 3LL * base)[w - 2 * kQ] = src[w];
    else
      reinterpret_cast<float4*>(d_corner + 9LL * base)[w - 3 * kQ] = src[w];
  }
}

}  // namespace

// vertices (V, 3) f32, tri_meta (T, 8) i32; per ray: best_tri i32, the
// forward t f32 and hit bool, o and d (N, 3) f32; cotangents of t, u, v
// (N,) and of point and normal (N, 3) f32, each null where absent (read as
// zeros).  Writes d_o, d_d (N, 3), keys (3N,) i32 and d_corner (3N, 3) f32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_finalize_hits_bwd(const float* vertices, const int* tri_meta,
                                      const int* best_tri, const float* t_fwd, const bool* hit,
                                      const float* o, const float* d, const float* g_t,
                                      const float* g_u, const float* g_v, const float* g_point,
                                      const float* g_normal, int n, float* d_o, float* d_d,
                                      int* keys, float* d_corner, void* stream) {
  if (n > 0) {
    const int blocks = (n + kBlock - 1) / kBlock;
    finalize_bwd_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        vertices, reinterpret_cast<const int4*>(tri_meta), best_tri, t_fwd, hit, o, d, g_t, g_u,
        g_v, g_point, g_normal, n, d_o, d_d, keys, d_corner);
  }
  return static_cast<int>(cudaGetLastError());
}
