// K1 grid_shoot: nearest hit through the uniform voxel grid, one ray per
// group of G lanes.
//
// Replaces the XLA loops of hare_tpu/accel/voxel.py shoot_grid (:414-867: grid
// entry, the lockstep collect/p1_step DDA march, the resume rounds) and
// hare_tpu/accel/common.py test_windows/_test_windows (:125-274).  On the TPU
// the march and the window test were split (collect-then-test) because an
// in-loop gather restaged its whole table each step; on Hopper the march and
// the test are fused and a ray stops as soon as the next cell's entry t
// exceeds its best hit.  The candidate buffers, resume rounds, straggler
// tiers and chunking are not needed.
//
// What bounds it on the H100.  On the bench scene (82k triangles, 48^3 grid,
// 32,768 rays; voxel.grid_work counts it) a first-bounce ray visits 8.2
// cells and tests 2.5 window slots, a ray of bounces 2-3 13-15 cells and
// 20-35 slots.  At 43 FP32 operations a watertight test that is under
// 0.05 GFLOP a shoot, under 1 us at 67 TFLOP/s; the bytes, each read once
// (the rays, 58-89k cell_meta entries, 22-148k distinct non-null slots of
// 48 B), are 2.8-9.1 MB, 0.8-2.7 us at 3.35 TB/s: the bound is the bytes
// (benchmarks/bounds.py).  The kernel takes 30-50x that on an H100 (PERF.md
// §6): every cell is a chain of dependent loads (its cell_meta entry, then
// its window rows), so the march is bound by latency.  One thread per ray
// (the first design) filled the card to one eighth (256 blocks of 128
// threads), a warp waited for the slowest of its 32 rays, and each slot
// cost two dependent, uncoalesced round trips (ids, then geometry).
//
// The design.  The G lanes of a group step the same DDA from the same
// registers, so the group never diverges within itself; a warp carries
// 32 / G rays and the card holds G times as many warps.  In each occupied
// cell the group shares the cell's run of n_wins * win slots
// (hare::test_run_group): lane k tests slots k, k + G, ..., loading ids and
// geometry together, neighbouring lanes on neighbouring slots, and a
// shuffle reduction of the hit key (bits(t) << 32 | tri, the plain version's
// own key) leaves every lane with the same best hit, so the early exit is
// uniform.  The launch is persistent (persistent.cuh, shared with B2 and
// B3): as many blocks as fit at once, each group taking its next ray from a
// counter, so no SM idles behind a slow wave.  G = 16, 128 threads a block
// and the persistent launch were chosen by measurement among G = 8, 16 and
// 32, 256 threads, one group per ray and a prefetch of the next cell's meta
// (hare_tpu_torch/benchmarks/kernel_sweep.py, PERF.md §6).  The result is
// bit-equal to the one-thread-per-ray kernel's, and, with -fmad=false
// (kernels/build.py), to the plain version's.
//
// The ray order.  On a 256^3 grid (config 5: 1.07 GB of tables, 21x the
// 50 MB L2) each shot re-reads its window slots about ten times, and rays
// handed out in index order (uniform directions, scattered bounce origins)
// spread that reuse over the whole launch.  So where a shot is many waves
// of resident rays (the rule: voxel.py order_engages), the entry point first sorts the shot's rays by a key of
// origin and direction, a counting sort in three launches
// (grid_shoot_order_keys, _scan, _place, about 0.065 ms at 2^20 rays), and
// the persistent loop takes order[t] for its t-th ray: rays in flight
// together leave one region in one direction and share cells and rows in
// L1 and L2.  Each ray still computes and writes at its own index, so the
// results are the same bits.  On config 5's two bounces K1 took 32% and 29%
// less time with the order, its kernels included (kernel_sweep.py --order;
// PERF.md §6).
//
// Semantics (all from the JAX code): entry at max(t_near, 0) + 1e-4*char_step
// for outside rays; masked DDA step where ties advance several axes at once;
// distance-field jump when dist >= 2; acceptance valid & t > min_t &
// tid >= 0 & poly != ex0 & poly != ex1 (& top == top_index when set); the
// nearest t wins, equal t goes to the lowest triangle id.
#include <algorithm>
#include <limits>

#include "persistent.cuh"
#include "windows.cuh"

namespace {

constexpr int kGroup = 16;   // lanes per ray
constexpr int kBlock = 128;  // threads per block
static_assert(kBlock % 32 == 0, "whole warps per block");

constexpr float kInf = std::numeric_limits<float>::infinity();

// The ray order's key: the Morton code of the origin's cell, 2^kOriginBits
// cells an axis over the grid's box, above that of the direction's
// octahedral map, 2^kDirBits cells an axis (voxel.py ORDER_BITS mirrors
// them).  From kernel_sweep.py --order on an H100 80GB HBM3 at 700 W
// (PERF.md §6), K1 with its order on config 5's 2^20-ray bounces, ms: (2, 7)
// 1.463 / 2.771 against 2.164 / 3.943 in drawn order; (1, 8) 1.436 / 2.817,
// (0, 10) 1.403 / 2.921, (2, 6) 1.512 / 2.827, (4, 4) 1.793 / 2.864 (bounce
// 1's one origin puts its rays in 2^(2 kDirBits) bins, whose counters'
// atomics then queue).
constexpr int kOriginBits = 2;
constexpr int kDirBits = 7;
constexpr int kKeyBits = 3 * kOriginBits + 2 * kDirBits;
static_assert(kKeyBits <= 20, "a tile sum per kTileBins bins in the keys kernel's shared memory");
// The order's scratch (int32 words): the bins' counts and offsets (kTiles
// tiles of kTileBins each), a sum per tile, then per ray its key, its rank
// among its bin's rays and the order.  The counts and tile sums are zero
// before each order and left at zero by it.
constexpr int kTileBins = 1024;
constexpr int kTiles = ((1 << kKeyBits) + kTileBins - 1) / kTileBins;
constexpr int kBins = kTiles * kTileBins;
constexpr long long kOrderFixedWords = 2LL * kBins + kTiles;

struct Grid {
  float gmin[3], gmax[3], vox[3], inv_vox[3];
  float entry_eps;  // ENTRY_EPS * char_step (voxel.py:501)
  float min_t;
  int dims[3];
  int win;        // triangles per window row
  int top_index;  // -1 = no topology filter
};

// ---- the ray order: a counting sort of the shot's rays by their key.
constexpr int kOrderBlock = 256;  // threads a block of the keys and scan kernels
constexpr int kOrderRays = 8;     // rays a thread of the keys kernel
constexpr int kScanPer = kTileBins / kOrderBlock;  // bins a thread of the scan

struct Order {
  float gmin[3], scale[3];  // the origin's cell along c: (o - gmin) * scale
};

// floor(u) clamped to [0, cells); NaN to 0.
__device__ __forceinline__ unsigned quantise(float u, int cells) {
  return u >= 0.f ? (u < static_cast<float>(cells) ? static_cast<unsigned>(floorf(u)) : cells - 1)
                  : 0u;
}

// The low 10 bits of v to every third bit, and the low 16 to every second.
__device__ __forceinline__ unsigned spread3(unsigned v) {
  v &= 0x3FFu;
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}
__device__ __forceinline__ unsigned spread2(unsigned v) {
  v &= 0xFFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  return (v | (v << 1)) & 0x55555555u;
}

// A ray's key (hare_tpu_torch/accel/voxel.py grid_order_keys_plain, each
// operation rounded as there): the Morton code of its origin's cell, x
// highest, above the Morton code of its direction's octahedral map.
__device__ __forceinline__ int order_key(const float* oc, const float* dc, const Order& p) {
  unsigned q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) q[c] = quantise((oc[c] - p.gmin[c]) * p.scale[c], 1 << kOriginBits);
  const float s = (fabsf(dc[0]) + fabsf(dc[1])) + fabsf(dc[2]);
  float px = s > 0.f ? dc[0] / s : 0.f;
  float py = s > 0.f ? dc[1] / s : 0.f;
  if (dc[2] < 0.f) {
    const float fx = (1.f - fabsf(py)) * (px >= 0.f ? 1.f : -1.f);
    const float fy = (1.f - fabsf(px)) * (py >= 0.f ? 1.f : -1.f);
    px = fx;
    py = fy;
  }
  const float half = 0.5f * static_cast<float>(1 << kDirBits);
  const unsigned u = quantise((px + 1.f) * half, 1 << kDirBits);
  const unsigned v = quantise((py + 1.f) * half, 1 << kDirBits);
  const unsigned origin = (spread3(q[0]) << 2) | (spread3(q[1]) << 1) | spread3(q[2]);
  return static_cast<int>((origin << (2 * kDirBits)) | (spread2(u) << 1) | spread2(v));
}

// Keys: each ray's key, and its rank among its bin's rays, the count an
// integer atomic returns (any order of the atomics gives a valid rank); a
// thread's kOrderRays atomics are in flight together, so their round trips
// overlap.  Each block adds its rays a tile into tile_sums, counted first
// in shared memory, lanes of a warp with the same tile adding together.
__global__ void __launch_bounds__(kOrderBlock)
grid_shoot_order_keys(const float* __restrict__ o, const float* __restrict__ d, int n,
                      const Order p, int* __restrict__ counts, int* __restrict__ tile_sums,
                      int* __restrict__ key, int* __restrict__ rank) {
  __shared__ int s_tiles[kTiles];
  for (int t = threadIdx.x; t < kTiles; t += kOrderBlock) s_tiles[t] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kOrderBlock * kOrderRays;
  int k[kOrderRays], rk[kOrderRays];
#pragma unroll
  for (int r = 0; r < kOrderRays; ++r) {
    const long long i = base + static_cast<long long>(r) * kOrderBlock + threadIdx.x;
    k[r] = -1;
    if (i < n) {
      const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
      const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      k[r] = order_key(oc, dc, p);
      rk[r] = atomicAdd(&counts[k[r]], 1);
    }
  }
#pragma unroll
  for (int r = 0; r < kOrderRays; ++r) {
    const long long i = base + static_cast<long long>(r) * kOrderBlock + threadIdx.x;
    const bool live = k[r] >= 0;
    if (live) {
      key[i] = k[r];
      rank[i] = rk[r];
    }
    // Whole warps reach here together (i grows by whole blocks).
    const unsigned live_mask = __ballot_sync(0xFFFFFFFFu, live);
    if (live) {
      const int tile = k[r] / kTileBins;
      const unsigned same = __match_any_sync(live_mask, tile);
      if ((threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(&s_tiles[tile], __popc(same));
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTiles; t += kOrderBlock)
    if (s_tiles[t] != 0) atomicAdd(&tile_sums[t], s_tiles[t]);
}

// Scan: block t turns the counts of tile t into offsets, the exclusive sum
// over the bins before each (the tiles before t from tile_sums), and
// zeroes the counts for the next order.
__global__ void __launch_bounds__(kOrderBlock)
grid_shoot_order_scan(int* __restrict__ counts, const int* __restrict__ tile_sums,
                      int* __restrict__ offs) {
  __shared__ int s_warp[kOrderBlock / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int before = 0;
  for (int j = t; j < static_cast<int>(blockIdx.x); j += kOrderBlock) before += tile_sums[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xFFFFFFFFu, before, off);
  if (lane == 0) s_warp[warp] = before;
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int w = 0; w < kOrderBlock / 32; ++w) base += s_warp[w];
  __syncthreads();  // s_warp is read before it is written again
  const long long b0 = static_cast<long long>(blockIdx.x) * kTileBins + t * kScanPer;
  int v[kScanPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) {
    v[q] = counts[b0 + q];
    sum += v[q];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int at = base + incl - sum;
  for (int w = 0; w < warp; ++w) at += s_warp[w];
#pragma unroll
  for (int q = 0; q < kScanPer; ++q) {
    offs[b0 + q] = at;
    counts[b0 + q] = 0;
    at += v[q];
  }
}

// Place: ray i at its bin's offset plus its rank; the tile sums zeroed for
// the next order.
__global__ void grid_shoot_order_place(const int* __restrict__ key, const int* __restrict__ rank,
                                       const int* __restrict__ offs, int n,
                                       int* __restrict__ tile_sums, int* __restrict__ order) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) order[offs[key[i]] + rank[i]] = static_cast<int>(i);
  if (i < kTiles) tile_sums[i] = 0;
}

// Parametric t of the cell boundary the ray leaves cell `cl` through, along
// one axis (voxel.py:545-548, :663-666).
__device__ __forceinline__ float boundary_t(const Grid& g, int c, int cl,
                                            float oc, float dc, float inv_sd) {
  const float nxt = g.gmin[c] + static_cast<float>(cl + (dc > 0.f)) * g.vox[c];
  return dc == 0.f ? kInf : (nxt - oc) * inv_sd;
}

// Ray i, on every lane of its group (lane `lane`, the group's lanes `mask`).
template <bool MT>
__device__ __forceinline__ void shoot_ray(int i, int lane, unsigned mask,
                                          const float* __restrict__ o, const float* __restrict__ d,
                                          const int* __restrict__ ex,
                                          const int2* __restrict__ cell_meta,
                                          const float4* __restrict__ win_geom,
                                          const int4* __restrict__ win_ids, const Grid& g,
                                          float* __restrict__ best_t_out,
                                          int* __restrict__ best_tri_out) {
  const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const int ex0 = ex[2 * i], ex1 = ex[2 * i + 1];
  float best_t = kInf;
  int best_tri = -1;

  // ---- grid entry: slab test against the grid box (voxel.py:494-503).
  bool inside = true;
  float t_near = -kInf, t_far = kInf;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool par = dc[c] == 0.f;
    const float inv = 1.f / (par ? 1.f : dc[c]);
    const float t1 = (g.gmin[c] - oc[c]) * inv;
    const float t2 = (g.gmax[c] - oc[c]) * inv;
    const bool in_slab = oc[c] >= g.gmin[c] && oc[c] <= g.gmax[c];
    t_near = fmaxf(t_near, par ? (in_slab ? -kInf : kInf) : fminf(t1, t2));
    t_far = fminf(t_far, par ? (in_slab ? kInf : -kInf) : fmaxf(t1, t2));
    inside = inside && in_slab;
  }
  const bool box_hit = t_far >= fmaxf(t_near, 0.f) && t_far >= 0.f;
  const float t0 = inside ? 0.f : (box_hit ? fmaxf(t_near, 0.f) + g.entry_eps : kInf);
  if (t0 < kInf) {
    // ---- DDA setup (voxel.py:516-552): zero components get t_delta = inf.
    float inv_sd[3], t_delta[3], t_max[3];
    int step[3], cell[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      inv_sd[c] = 1.f / (dc[c] == 0.f ? 1.f : dc[c]);
      step[c] = dc[c] > 0.f ? 1 : (dc[c] < 0.f ? -1 : 0);
      t_delta[c] = dc[c] == 0.f ? kInf : g.vox[c] * fabsf(inv_sd[c]);
      const float pos = oc[c] + t0 * dc[c];
      const int cl = __float2int_rd((pos - g.gmin[c]) * g.inv_vox[c]);
      cell[c] = min(max(cl, 0), g.dims[c] - 1);
      t_max[c] = boundary_t(g, c, cell[c], oc[c], dc[c], inv_sd[c]);
    }
    const float min_delta = fminf(fminf(t_delta[0], t_delta[1]), t_delta[2]);
    const hare::RayC ray = hare::ray_setup(oc[0], oc[1], oc[2], dc[0], dc[1], dc[2]);
    const hare::RunFilter filter{ex0, ex1, g.top_index, g.min_t};

    // A DDA step advances at least one axis and a jump lands beyond the
    // current cell, so a ray visits at most nx + ny + nz - 2 cells.  Every
    // lane of the group runs this loop on the same values.
    const int max_steps = g.dims[0] + g.dims[1] + g.dims[2] + 3;
    int2 meta = __ldg(&cell_meta[(cell[0] * g.dims[1] + cell[1]) * g.dims[2] + cell[2]]);
    for (int s = 0; s < max_steps; ++s) {
      const int row0 = meta.x;
      const int n_wins = static_cast<int>(static_cast<unsigned>(meta.y) >> 8);
      const int dist = meta.y & 0xFF;
      // ---- the group tests the cell's window rows together.
      if (n_wins > 0)
        hare::test_run_group<MT, kGroup>(ray, win_geom, win_ids, row0, n_wins, g.win, filter,
                                         lane, mask, best_t, best_tri);

      // ---- advance: masked DDA step, or distance-field jump (voxel.py:641-676).
      const float t_exit = fminf(fminf(t_max[0], t_max[1]), t_max[2]);
      bool off = false;
      float t_enter;
      if (dist >= 2) {
        t_enter = t_exit + static_cast<float>(dist - 1) * min_delta;
        const float t_land = t_enter + 1e-4f * min_delta;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float pos = oc[c] + t_land * dc[c];
          const int cl = __float2int_rd((pos - g.gmin[c]) * g.inv_vox[c]);
          off = off || cl < 0 || cl >= g.dims[c];
          cell[c] = min(max(cl, 0), g.dims[c] - 1);
          t_max[c] = boundary_t(g, c, cell[c], oc[c], dc[c], inv_sd[c]);
        }
      } else {
        t_enter = t_exit;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (t_max[c] <= t_exit) {
            cell[c] += step[c];
            t_max[c] += t_delta[c];
          }
          off = off || cell[c] < 0 || cell[c] >= g.dims[c];
          cell[c] = min(max(cell[c], 0), g.dims[c] - 1);
        }
      }
      meta = __ldg(&cell_meta[(cell[0] * g.dims[1] + cell[1]) * g.dims[2] + cell[2]]);
      if (off || !(t_enter <= best_t)) break;
    }
  }
  if (lane == 0) {
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
  }
}

// The persistent launch (persistent.cuh): each group takes its next ray from
// the counter until none is left.
template <bool MT>
__global__ void __launch_bounds__(kBlock)
grid_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ ex, int n,
                  const int2* __restrict__ cell_meta,
                  const float4* __restrict__ win_geom,
                  const int4* __restrict__ win_ids, const Grid g,
                  float* __restrict__ best_t_out, int* __restrict__ best_tri_out,
                  const int* __restrict__ order, unsigned* __restrict__ counter) {
  const int lane = threadIdx.x % kGroup;
  const unsigned mask = hare::group_mask<kGroup>();
  for (;;) {
    const int taken = hare::take_ray<kGroup>(counter, lane, mask);
    if (taken >= n) break;  // the whole group
    const int i = order ? __ldg(&order[taken]) : taken;
    shoot_ray<MT>(i, lane, mask, o, d, ex, cell_meta, win_geom, win_ids, g, best_t_out,
                  best_tri_out);
  }
  hare::group_done<kGroup>(counter, lane);
}

template <bool MT>
void launch(cudaStream_t s, const float* o, const float* d, const int* ex, int n,
            const int2* meta, const float4* geom, const int4* ids, const Grid& g,
            float* best_t, int* best_tri, const int* order, unsigned* counter) {
  const int blocks = hare::persistent_blocks(grid_shoot_kernel<MT>, n, kGroup, kBlock, 0);
  grid_shoot_kernel<MT><<<blocks, kBlock, 0, s>>>(o, d, ex, n, meta, geom, ids, g, best_t,
                                                  best_tri, order, counter);
}

// The order of n > 0 rays into the scratch's order (three launches on s).
void launch_order(cudaStream_t s, const float* o, const float* d, int n, const Order& p,
                  int* scratch) {
  int* counts = scratch;
  int* offs = counts + kBins;
  int* tile_sums = offs + kBins;
  int* key = scratch + kOrderFixedWords;
  int* rank = key + n;
  int* order = rank + n;
  const long long per_block = static_cast<long long>(kOrderBlock) * kOrderRays;
  const int key_blocks = static_cast<int>((n + per_block - 1) / per_block);
  grid_shoot_order_keys<<<key_blocks, kOrderBlock, 0, s>>>(o, d, n, p, counts, tile_sums, key,
                                                            rank);
  grid_shoot_order_scan<<<kTiles, kOrderBlock, 0, s>>>(counts, tile_sums, offs);
  const int place_blocks = (std::max(n, kTiles) + kOrderBlock - 1) / kOrderBlock;
  grid_shoot_order_place<<<place_blocks, kOrderBlock, 0, s>>>(key, rank, offs, n, tile_sums,
                                                              order);
}

}  // namespace

// fparams (host): gmin[3], gmax[3], vox[3], inv_vox[3], entry_eps, min_t.
// iparams (host): dims[3], win, top_index (-1 = none), mt (0 watertight, 1 MT).
// order: null, or the order's scratch on the device (kOrderFixedWords +
// 3n int32 words, its counts and tile sums zero; one per stream): K1 then
// takes the rays in the order of their keys, three launches before it.
// counter: two unsigned on the device, 0 before the first launch on
// `stream` and left at 0 by each launch (the ray counter of the persistent
// launch; one pair per stream, since launches on one stream run in turn).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_grid_shoot(const float* o, const float* d, const int* ex, int n,
                               const int* cell_meta, const float* win_geom,
                               const int* win_ids, const float* fparams,
                               const int* iparams, float* best_t, int* best_tri,
                               int* order, unsigned* counter, void* stream) {
  Grid g;
  for (int c = 0; c < 3; ++c) {
    g.gmin[c] = fparams[c];
    g.gmax[c] = fparams[3 + c];
    g.vox[c] = fparams[6 + c];
    g.inv_vox[c] = fparams[9 + c];
    g.dims[c] = iparams[c];
  }
  g.entry_eps = fparams[12];
  g.min_t = fparams[13];
  g.win = iparams[3];
  g.top_index = iparams[4];
  const bool mt = iparams[5] != 0;
  // The origin's cells: 2^kOriginBits over the box's extent, in f32 (as
  // voxel.py grid_order_keys_plain rounds it).
  Order p;
  for (int c = 0; c < 3; ++c) {
    p.gmin[c] = g.gmin[c];
    p.scale[c] = static_cast<float>(1 << kOriginBits) / (g.gmax[c] - g.gmin[c]);
  }
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int2* meta = reinterpret_cast<const int2*>(cell_meta);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    const int* taken = nullptr;
    if (order) {
      launch_order(s, o, d, n, p, order);
      taken = order + kOrderFixedWords + 2LL * n;
    }
    if (mt)
      launch<true>(s, o, d, ex, n, meta, geom, ids, g, best_t, best_tri, taken, counter);
    else
      launch<false>(s, o, d, ex, n, meta, geom, ids, g, best_t, best_tri, taken, counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// Into out (host): [0] the rays the card runs at once in one launch of K1
// (its resident blocks times their groups), what the order's engagement
// rule reads (hare_tpu_torch/accel/voxel.py order_engages), and [1] the
// order scratch's words before its per-ray part.  Runs on the host;
// `stream` is not used.
extern "C" int hare_grid_shoot_capacity(int mt, int* out, void* stream) {
  (void)stream;
  const int blocks = mt ? hare::resident_blocks(grid_shoot_kernel<true>, kBlock, 0)
                        : hare::resident_blocks(grid_shoot_kernel<false>, kBlock, 0);
  out[0] = blocks * (kBlock / kGroup);
  out[1] = static_cast<int>(kOrderFixedWords);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
