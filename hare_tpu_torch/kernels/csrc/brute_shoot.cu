// B1 brute_shoot: nearest hit over every triangle.
//
// Replaces hare_tpu/accel/brute.py shoot_brute (:63-141), a lax.scan over
// tri_tile tiles of an (N x tile) test followed by a per-tile argmin.  The
// result is the min over accepted (ray, triangle) pairs of the hit key
// (the bits of t shifted left 32, OR the triangle id: accel/common.py
// hit_key), which orders hits by t and an equal t by the lowest id, as the
// JAX argmin does; a min is exact, so any split of the triangles gives the
// same answer as the plain version's amin.
//
// What bounds it on the H100: FP32 arithmetic.  Every ray meets every
// triangle (bench referee: 32,768 x 81,932 = 2.7e9 watertight tests).
// The design fills the card whatever the ray count and feeds each test
// from shared memory:
// - Triangle slabs across blockIdx.y: the block count is brought to
//   kTargetBlocks (16 blocks of 4 warps an SM: a little over one wave at
//   56 registers a thread); each block keeps its rays' best keys in
//   registers and merges them into a per-ray key with a
//   64-bit atomicMin, and a small second kernel turns the keys into
//   (best_t, best_tri) and resets them for the next call.  With one slab
//   the block writes its rays' results itself.
// - R rays a thread (kWideRays, 2): one staged triangle row feeds R
//   independent tests, instruction-level parallelism for the dependent
//   chain of the watertight test.  Small launches (config 1: 10,000 rays,
//   one tile) take one ray a thread in blocks of 64, spread over the SMs.
// - Tiles of kTile triangles, double-buffered: the next tile's rows are
//   loaded into registers while this one is tested, then stored to the
//   other buffer; one barrier a tile.  (Not cp.async: the staged row is
//   derived, v0 + e1 and v0 + e2 precomputed once a tile for the
//   watertight test, as its shear takes the three corners.)
// - The watertight test reads its ray's permuted coordinates (kx, ky, kz)
//   of each corner straight from the row, three distinct words a warp, in
//   three banks, instead of selecting them in registers.
// - Padding rows (poly -2; config 1's 12 triangles sit in 128 rows) are
//   skipped before the test, a branch every thread takes alike; the other
//   acceptance checks (exclusions, top_index) and the division for t run
//   only for a test that is valid, rarely.
// Ray loads are coalesced through shared memory.  The arithmetic is the
// plain version's (intersect.cuh, built with -fmad=false): bit-equal.
//
// Acceptance (brute.py:106-119): valid, t > min_t, poly in neither exclusion
// slot, poly != -2 (padding rows), top == top_index when top_index >= 0.
#include <limits>

#include "intersect.cuh"

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr long long kNoHit = 0x7fffffffffffffffLL;  // common.NO_HIT_KEY
constexpr int kTile = 128;       // triangles a staged tile
constexpr int kRow = 12;         // words a staged row: 9 geometry, poly, top, pad
constexpr int kPadPoly = -2;
constexpr int kWideThreads = 128;
constexpr int kWideRays = 2;     // rays a thread in the wide launch
constexpr int kNarrowThreads = 64;
constexpr int kTargetBlocks = 132 * 16;

__device__ __forceinline__ long long hit_key(float t, int tri) {
  const unsigned long long hi =
      static_cast<unsigned long long>(static_cast<long long>(__float_as_int(t))) << 32;
  return static_cast<long long>(hi | static_cast<unsigned>(tri));
}

// One triangle's row as loaded from tri_geom / tri_meta.
struct Loaded {
  float g[9];
  int poly, top;
};

__device__ __forceinline__ void load_row(const float* __restrict__ tri_geom,
                                         const int* __restrict__ tri_meta, long long tri,
                                         Loaded& r) {
#pragma unroll
  for (int c = 0; c < 9; ++c) r.g[c] = tri_geom[9 * tri + c];
  r.poly = tri_meta[8 * tri];
  r.top = tri_meta[8 * tri + 7];
}

// The staged row: MT keeps v0 | e1 | e2; watertight takes the corners
// v0 | v0 + e1 | v0 + e2, the sums the plain test forms first.
template <bool MT>
__device__ __forceinline__ void store_row(float* row, const Loaded& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    row[c] = r.g[c];
    row[3 + c] = MT ? r.g[3 + c] : r.g[c] + r.g[3 + c];
    row[6 + c] = MT ? r.g[6 + c] : r.g[c] + r.g[6 + c];
  }
  row[9] = __int_as_float(r.poly);
  row[10] = __int_as_float(r.top);
}

// A ray's constants: for the watertight test its origin's permuted
// components, its shear and the permutation (word offsets into a row).
struct RayW {
  float ox, oy, oz, sx, sy, sz;
  int kx, ky, kz;
};

__device__ __forceinline__ RayW ray_w(const hare::RayC& r) {
  RayW w;
  w.ox = hare::pick3(r.kx, r.ox, r.oy, r.oz);
  w.oy = hare::pick3(r.ky, r.ox, r.oy, r.oz);
  w.oz = hare::pick3(r.kz, r.ox, r.oy, r.oz);
  w.sx = r.sx;
  w.sy = r.sy;
  w.sz = r.sz;
  w.kx = r.kx;
  w.ky = r.ky;
  w.kz = r.kz;
  return w;
}

// hare::watertight<false> on a staged row: the same operations in the same
// order (pick3(k, v - o) == v[k] - o[k]); t only where valid.
__device__ __forceinline__ bool watertight_row(const RayW& r, const float* row, float& t) {
  const float az = row[r.kz] - r.oz;
  const float ax = (row[r.kx] - r.ox) - r.sx * az;
  const float ay = (row[r.ky] - r.oy) - r.sy * az;
  const float bz = row[3 + r.kz] - r.oz;
  const float bx = (row[3 + r.kx] - r.ox) - r.sx * bz;
  const float by = (row[3 + r.ky] - r.oy) - r.sy * bz;
  const float cz = row[6 + r.kz] - r.oz;
  const float cx = (row[6 + r.kx] - r.ox) - r.sx * cz;
  const float cy = (row[6 + r.ky] - r.oy) - r.sy * cz;
  const float u_s = cx * by - cy * bx;
  const float v_s = ax * cy - ay * cx;
  const float w_s = bx * ay - by * ax;
  const float det = u_s + v_s + w_s;
  const float tol = 8.f * FLT_EPSILON * (fabsf(u_s) + fabsf(v_s) + fabsf(w_s));
  const bool same_sign = (u_s >= -tol && v_s >= -tol && w_s >= -tol) ||
                         (u_s <= tol && v_s <= tol && w_s <= tol);
  if (!(same_sign && fabsf(det) > 0.f)) return false;
  const float inv_det = 1.f / det;
  t = r.sz * (u_s * az + v_s * bz + w_s * cz) * inv_det;
  return true;
}

// hare::moller_trumbore<false> on a staged row (v0 | e1 | e2); t only
// where valid.
__device__ __forceinline__ bool mt_row(const hare::RayC& r, const float* row, float& t) {
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tx = r.ox - row[0], ty = r.oy - row[1], tz = r.oz - row[2];
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float u_s = tx * px + ty * py + tz * pz;
  const float v_s = r.dx * qx + r.dy * qy + r.dz * qz;
  const float s = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);
  if (!(s * u_s >= 0.f && s * v_s >= 0.f && s * (u_s + v_s) <= s * det &&
        fabsf(det) > hare::kDetEpsMT))
    return false;
  const float t_s = e2x * qx + e2y * qy + e2z * qz;
  const float inv_det = 1.f / det;
  t = t_s * inv_det;
  return true;
}

// Grid (ray blocks, slabs).  Block (x, y) tests the T * R rays from
// x * T * R (thread i: rays i, i + T, ...) against the tiles of slab y.
template <bool MT, int T, int R>
__global__ void __launch_bounds__(T)
brute_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const int* __restrict__ ex, int n, const float* __restrict__ tri_geom,
                   const int* __restrict__ tri_meta, int n_tris, float min_t, int top_index,
                   int tiles_per_slab, long long* __restrict__ keys,
                   float* __restrict__ best_t_out, int* __restrict__ best_tri_out) {
  constexpr int kRowsPerThread = kTile / T;
  __shared__ __align__(16) float s_tri[2][kTile * kRow];
  __shared__ float s_ray[2][T * R * 3];
  const int tid = threadIdx.x;
  const long long ray0 = static_cast<long long>(blockIdx.x) * T * R;
  const int nr = static_cast<int>(min(static_cast<long long>(T * R), n - ray0));
  for (int k = tid; k < nr * 3; k += T) {
    s_ray[0][k] = o[3 * ray0 + k];
    s_ray[1][k] = d[3 * ray0 + k];
  }
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  const int first = blockIdx.y * tiles_per_slab;
  const int last = min(first + tiles_per_slab, n_tiles);

  Loaded next[kRowsPerThread];
  auto load_tile = [&](int tile) {
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const long long tri = static_cast<long long>(tile) * kTile + q * T + tid;
      if (tri < n_tris) load_row(tri_geom, tri_meta, tri, next[q]);
    }
  };
  auto store_tile = [&](float* buf) {
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) store_row<MT>(buf + (q * T + tid) * kRow, next[q]);
  };
  if (first < last) {
    load_tile(first);
    store_tile(s_tri[0]);
  }
  __syncthreads();

  hare::RayC ray[R];
  RayW rw[R];
  long long best[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = min(tid + j * T, nr - 1);  // a dead lane repeats the last ray
    ray[j] = hare::ray_setup(s_ray[0][3 * i], s_ray[0][3 * i + 1], s_ray[0][3 * i + 2],
                             s_ray[1][3 * i], s_ray[1][3 * i + 1], s_ray[1][3 * i + 2]);
    rw[j] = ray_w(ray[j]);
    best[j] = kNoHit;
  }

  int cur = 0;
  for (int tile = first; tile < last; ++tile) {
    const bool more = tile + 1 < last;
    if (more) load_tile(tile + 1);
    const float* rows = s_tri[cur];
    const int base = tile * kTile;
    const int m = min(kTile, n_tris - base);
#pragma unroll 2
    for (int k = 0; k < m; ++k) {
      const float* row = rows + k * kRow;
      if (__float_as_int(row[9]) == kPadPoly) continue;  // the same row in every thread
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float t;
        const bool valid = MT ? mt_row(ray[j], row, t) : watertight_row(rw[j], row, t);
        if (!valid) continue;
        // Rare: a valid test; accept it as the plain version does.
        const int i = tid + j * T;
        const int poly = __float_as_int(row[9]);
        if (i >= nr || !(t > min_t) || (top_index >= 0 && __float_as_int(row[10]) != top_index))
          continue;
        const long long r = ray0 + i;
        if (poly == ex[2 * r] || poly == ex[2 * r + 1]) continue;
        const long long key = hit_key(t, base + k);
        if (key < best[j]) best[j] = key;
      }
    }
    if (more) store_tile(s_tri[cur ^ 1]);
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = tid + j * T;
    if (i >= nr) continue;
    const long long r = ray0 + i;
    if (gridDim.y > 1) {
      if (best[j] != kNoHit) atomicMin(keys + r, best[j]);
    } else {
      const bool miss = best[j] == kNoHit;
      best_t_out[r] = miss ? kInf : __int_as_float(static_cast<int>(best[j] >> 32));
      best_tri_out[r] = miss ? -1 : static_cast<int>(best[j] & 0xffffffffLL);
    }
  }
}

// After a launch of several slabs: each ray's merged key to (best_t,
// best_tri), and the key reset to kNoHit for the next call.
__global__ void brute_shoot_kernel_keys(int n, long long* __restrict__ keys,
                                        float* __restrict__ best_t_out,
                                        int* __restrict__ best_tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long key = keys[i];
  keys[i] = kNoHit;
  const bool miss = key == kNoHit;
  best_t_out[i] = miss ? kInf : __int_as_float(static_cast<int>(key >> 32));
  best_tri_out[i] = miss ? -1 : static_cast<int>(key & 0xffffffffLL);
}

template <int T, int R>
int launch(bool mt, const float* o, const float* d, const int* ex, int n, const float* tri_geom,
           const int* tri_meta, int n_tris, float min_t, int top_index, long long* keys,
           float* best_t, int* best_tri, cudaStream_t s) {
  const int ray_blocks = (n + T * R - 1) / (T * R);
  const int n_tiles = (n_tris + kTile - 1) / kTile;
  int slabs = (kTargetBlocks + ray_blocks - 1) / ray_blocks;
  slabs = max(1, min(slabs, min(n_tiles, 65535)));
  const int tiles_per_slab = max(1, (n_tiles + slabs - 1) / slabs);
  slabs = n_tiles > 0 ? (n_tiles + tiles_per_slab - 1) / tiles_per_slab : 1;
  if (slabs > 1 && keys == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(ray_blocks, slabs);
  if (mt)
    brute_shoot_kernel<true, T, R><<<grid, T, 0, s>>>(o, d, ex, n, tri_geom, tri_meta, n_tris,
                                                       min_t, top_index, tiles_per_slab, keys,
                                                       best_t, best_tri);
  else
    brute_shoot_kernel<false, T, R><<<grid, T, 0, s>>>(o, d, ex, n, tri_geom, tri_meta, n_tris,
                                                        min_t, top_index, tiles_per_slab, keys,
                                                        best_t, best_tri);
  if (slabs > 1)
    brute_shoot_kernel_keys<<<(n + 255) / 256, 256, 0, s>>>(n, keys, best_t, best_tri);
  return 0;
}

}  // namespace

// tri_geom (n_tris, 9) f32 v0|e1|e2; tri_meta (n_tris, 8) i32, lane 0 poly,
// lane 7 top.  top_index -1 = no filter; mt 0 watertight, 1 MT.  keys (n,)
// i64 scratch holding common.NO_HIT_KEY, and left holding it.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int hare_brute_shoot(const float* o, const float* d, const int* ex, int n,
                                const float* tri_geom, const int* tri_meta, int n_tris,
                                float min_t, int top_index, int mt, long long* keys,
                                float* best_t, int* best_tri, void* stream) {
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long wide_blocks = (n + kWideThreads * kWideRays - 1) / (kWideThreads * kWideRays);
    const long long n_tiles = (n_tris + kTile - 1) / kTile;
    const int rc =
        wide_blocks * n_tiles >= kTargetBlocks
            ? launch<kWideThreads, kWideRays>(mt, o, d, ex, n, tri_geom, tri_meta, n_tris, min_t,
                                              top_index, keys, best_t, best_tri, s)
            : launch<kNarrowThreads, 1>(mt, o, d, ex, n, tri_geom, tri_meta, n_tris, min_t,
                                        top_index, keys, best_t, best_tri, s);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
