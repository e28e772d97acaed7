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
// uniform.  The launch is persistent: as many blocks as fit at once, each
// group taking its next ray from a counter, so no SM idles behind a slow
// wave.  G = 16, 128 threads a block and the persistent launch were chosen
// by measurement among G = 8, 16 and 32, 256 threads, one group per ray and
// a prefetch of the next cell's meta (hare_tpu_torch/benchmarks/
// k1_sweep.py, PERF.md §6).  The result is bit-equal to the
// one-thread-per-ray kernel's.
//
// Semantics (all from the JAX code): entry at max(t_near, 0) + 1e-4*char_step
// for outside rays; masked DDA step where ties advance several axes at once;
// distance-field jump when dist >= 2; acceptance valid & t > min_t &
// tid >= 0 & poly != ex0 & poly != ex1 (& top == top_index when set); the
// nearest t wins, equal t goes to the lowest triangle id.
#include <limits>

#include "windows.cuh"

namespace {

constexpr int kGroup = 16;   // lanes per ray
constexpr int kBlock = 128;  // threads per block
static_assert(kGroup == 8 || kGroup == 16 || kGroup == 32, "G is 8, 16 or 32");
static_assert(kBlock % 32 == 0, "whole warps per block");

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Grid {
  float gmin[3], gmax[3], vox[3], inv_vox[3];
  float entry_eps;  // ENTRY_EPS * char_step (voxel.py:501)
  float min_t;
  int dims[3];
  int win;        // triangles per window row
  int top_index;  // -1 = no topology filter
};

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

// counter[0] is the next ray to take, counter[1] the groups that have
// finished; both are 0 at launch, and the last group to finish sets them
// back to 0 for the next launch on the stream.
template <bool MT>
__global__ void __launch_bounds__(kBlock)
grid_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ ex, int n,
                  const int2* __restrict__ cell_meta,
                  const float4* __restrict__ win_geom,
                  const int4* __restrict__ win_ids, const Grid g,
                  float* __restrict__ best_t_out, int* __restrict__ best_tri_out,
                  unsigned* __restrict__ counter) {
  // Groups are aligned within the warp: lanes [base, base + G) hold one ray.
  const int lane = threadIdx.x % kGroup;
  const unsigned mask = (kGroup == 32 ? 0xFFFFFFFFu : (1u << (kGroup % 32)) - 1u)
                        << ((threadIdx.x % 32) - lane);
  for (;;) {
    unsigned next = 0;
    if (lane == 0) next = atomicAdd(&counter[0], 1u);
    const int i = static_cast<int>(__shfl_sync(mask, next, 0, kGroup));
    if (i >= n) break;  // the whole group
    shoot_ray<MT>(i, lane, mask, o, d, ex, cell_meta, win_geom, win_ids, g, best_t_out,
                  best_tri_out);
  }
  // A group's last take from counter[0] has returned before it counts
  // itself done, so the last group done is the last to touch either.
  const unsigned groups = gridDim.x * (kBlock / kGroup);
  __threadfence();
  if (lane == 0 && atomicAdd(&counter[1], 1u) == groups - 1) {
    atomicExch(&counter[0], 0u);
    atomicExch(&counter[1], 0u);
  }
}

// Blocks of the persistent launch: as many as the card holds at once, found
// once per device and kernel.
template <bool MT>
int resident_blocks() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_shoot_kernel<MT>, kBlock, 0);
  const int blocks = max(sms * per_sm, 1);
  if (dev < kMaxDevices) cached[dev] = blocks;
  return blocks;
}

}  // namespace

// fparams (host): gmin[3], gmax[3], vox[3], inv_vox[3], entry_eps, min_t.
// iparams (host): dims[3], win, top_index (-1 = none), mt (0 watertight, 1 MT).
// counter: two unsigned on the device, 0 before the first launch on
// `stream` and left at 0 by each launch (the ray counter of the persistent
// launch; one pair per stream, since launches on one stream run in turn).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_grid_shoot(const float* o, const float* d, const int* ex, int n,
                               const int* cell_meta, const float* win_geom,
                               const int* win_ids, const float* fparams,
                               const int* iparams, float* best_t, int* best_tri,
                               unsigned* counter, void* stream) {
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
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long threads = static_cast<long long>(n) * kGroup;
    const int ray_blocks = static_cast<int>((threads + kBlock - 1) / kBlock);
    const int2* meta = reinterpret_cast<const int2*>(cell_meta);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    if (mt) {
      const int blocks = min(ray_blocks, resident_blocks<true>());
      grid_shoot_kernel<true><<<blocks, kBlock, 0, s>>>(o, d, ex, n, meta, geom, ids, g, best_t,
                                                        best_tri, counter);
    } else {
      const int blocks = min(ray_blocks, resident_blocks<false>());
      grid_shoot_kernel<false><<<blocks, kBlock, 0, s>>>(o, d, ex, n, meta, geom, ids, g, best_t,
                                                         best_tri, counter);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
