// K3 energy_histogram, hard and soft binning, forward and backward.
// Deterministic: no float atomics.
//
// Replaces the XLA scatters of hare_tpu/trace/bounce.py energy_histogram:
// the hard segment_sum over clip(int(time / bin_dt)) (:294-300) and the
// soft ("tent") segment_sum (:280-293), which splits each energy between
// the two bins whose centres bracket time / bin_dt, the edge halves clamped
// into the end bins; dead lanes are dropped.  Both backwards, the hard one
// (the transpose of the segment_sum, a gather) and the soft one, are one
// function below (lane_bwd, hare_histogram_bwd).
//
// Order.  Float atomics would make the summation order, and so the last
// bits of each bin, change from run to run.  Here every sum has a fixed
// order that depends on the lane count alone:
//   - a block takes `chunk` consecutive lanes, each of its warps a fixed
//     slice of them, 32 lanes a step (chunk_lanes: at least kMinChunk
//     lanes a block, at most kMaxBlocks blocks);
//   - in a step, lanes with the same bin form a group (__match_any_sync);
//     its values are added from +0.0 in lane order, and its leader (lowest
//     lane) adds the sum into the warp's private row of bins in shared
//     memory (soft: every lane's low share first, then every high share);
//   - the block adds its warps' rows in warp order into one row in device
//     memory;
//   - a second launch folds the blocks' rows, R of them: kSegs segments of
//     ceil(R / kSegs) consecutive rows, each added from +0.0 in row order,
//     then the segment sums from +0.0 in segment order.
// Bins come in tiles of kTile (blockIdx.y), so any n_bins fits the shared
// memory; a block reads its lanes once for each tile.
//
// What bounds it on the H100: bytes, the lanes' energy, time and hit (9 B
// a lane) read once and the bins written once; at the main paths' sizes, a
// few dependent round trips to memory and the launches.  What the design
// does (PERF.md §6; kernel_sweep.py case k3 holds the candidates):
//   - a warp loads kAhead steps of lanes, unconditionally, before it adds
//     any of them: one round trip to memory for kAhead steps;
//   - a group's leader alone sums it, by a scan of the step's 32 values
//     (eight 16-byte reads, a peer's value or +0.0 added in lane order):
//     no dependent chain of shuffles on every lane;
//   - two launches, not one: folding the rows in the same launch, by the
//     last blocks to finish (counters, fences and a second level of
//     segments) or behind a grid-wide barrier, reads slower on the device
//     than the second launch at the bench's and config 4's sizes.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;            // bins a block holds
constexpr long long kMinChunk = 512;   // lanes a block sums, at least
constexpr long long kMaxBlocks = 528;  // blocks along the lanes, at most
constexpr int kSegs = 8;               // segments of the blocks' rows
constexpr int kAhead = 4;              // steps a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

// Lanes a block sums: at least kMinChunk, few enough for kMaxBlocks blocks,
// a multiple of kThreads so each warp's slice is whole steps of 32.
__host__ __device__ inline long long chunk_lanes(long long n) {
  const long long want = (n + kMaxBlocks - 1) / kMaxBlocks;
  const long long chunk = (want + kThreads - 1) / kThreads * kThreads;
  return chunk > kMinChunk ? chunk : kMinChunk;
}

// The hard bin, clip(int(time / bin_dt), 0, n_bins - 1): clamping before
// the truncating conversion gives the same bin and keeps it in range.
__device__ __forceinline__ int hard_bin(float time, int n_bins, float bin_dt) {
  const float q = fminf(fmaxf(time / bin_dt, 0.f), static_cast<float>(n_bins - 1));
  return static_cast<int>(q);
}

// The soft split (bounce.py:281-288): the two bins lo, hi and the share
// frac of the energy that goes to hi; x is the unclipped frac.
struct Tent {
  int lo, hi;
  float x, frac;
};

__device__ __forceinline__ Tent tent(float time, int n_bins, float bin_dt) {
  const float pos = time / bin_dt - 0.5f;  // bin i's centre at (i + 0.5) bin_dt
  const float i0 = fminf(fmaxf(floorf(pos), -1.f), static_cast<float>(n_bins - 1));
  const float x = pos - i0;
  const int i = static_cast<int>(i0);
  return Tent{max(i, 0), min(i + 1, n_bins - 1), x, fminf(fmaxf(x, 0.f), 1.f)};
}

// Adds each lane's value into row[bin] (bin -1: nothing): the group of
// lanes with one bin is summed from +0.0 in lane order by its leader, its
// lowest lane, which reads the step's 32 values from the warp's slots and
// adds each peer's, +0.0 for every other lane.  A sum from +0.0 is never
// -0.0, so adding +0.0 leaves it unchanged: the bits are those of the
// peers' values alone, added in lane order.
__device__ __forceinline__ void add_grouped(float* row, float* slots, int bin, float val,
                                            int lane) {
  const unsigned peers = __match_any_sync(kFull, bin);
  slots[lane] = val;
  __syncwarp();
  if (bin >= 0 && lane == __ffs(peers) - 1) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(slots + k);
      acc += (peers >> k) & 1u ? v.x : 0.f;
      acc += (peers >> (k + 1)) & 1u ? v.y : 0.f;
      acc += (peers >> (k + 2)) & 1u ? v.z : 0.f;
      acc += (peers >> (k + 3)) & 1u ? v.w : 0.f;
    }
    row[bin] += acc;
  }
  __syncwarp();
}

// Rows of a segment of R blocks' rows: ceil(R / kSegs).
__host__ __device__ inline int seg_rows(int blocks) { return (blocks + kSegs - 1) / kSegs; }

// No __launch_bounds__: with it, ptxas of CUDA 12.8 failed on the soft
// instantiation of the earlier kernel (C7600, "Register allocation failed
// with register count of '7'"), as it does on that kernel's shuffle chain.
template <bool SOFT>
__global__ void hist_rows_kernel(const float* __restrict__ energy, const float* __restrict__ time,
                                 const bool* __restrict__ hit, long long n, long long chunk,
                                 int n_bins, float bin_dt, float* __restrict__ partials) {
  __shared__ __align__(16) float priv[kWarps * kTile];
  __shared__ __align__(16) float slots[kWarps][32];  // a step's values, for the leaders
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kTile;
  const int tile = min(kTile, n_bins - b0);
  for (int q = threadIdx.x; q < kWarps * kTile / 4; q += kThreads)
    reinterpret_cast<float4*>(priv)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  float* row = priv + warp * kTile;
  const long long begin = blockIdx.x * chunk + warp * (chunk / kWarps);
  const long long end = min(begin + chunk / kWarps, n);
  for (long long base = begin; base < end; base += 32 * kAhead) {
    float e[kAhead], t[kAhead];
    bool h[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const long long i = base + 32 * s + lane;
      h[s] = false;
      e[s] = t[s] = 0.f;
      if (i < end) {
        h[s] = hit[i];
        e[s] = energy[i];
        t[s] = time[i];
      }
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (base + 32 * s >= end) break;  // warp-uniform
      int bin_a = -1, bin_b = -1;
      float val_a = 0.f, val_b = 0.f;
      if (h[s]) {
        if (SOFT) {
          const Tent ts = tent(t[s], n_bins, bin_dt);
          const float e_hi = e[s] * ts.frac;
          bin_a = ts.lo;
          val_a = e[s] - e_hi;
          bin_b = ts.hi;
          val_b = e_hi;
        } else {
          bin_a = hard_bin(t[s], n_bins, bin_dt);
          val_a = e[s];
        }
      }
      // Bins outside this block's tile: none here.
      bin_a = bin_a >= b0 && bin_a < b0 + tile ? bin_a - b0 : -1;
      add_grouped(row, slots[warp], bin_a, val_a, lane);
      if (SOFT) {
        bin_b = bin_b >= b0 && bin_b < b0 + tile ? bin_b - b0 : -1;
        add_grouped(row, slots[warp], bin_b, val_b, lane);
      }
    }
  }
  __syncthreads();

  // ---- this block's row: its warps' rows in warp order.
  float* out = partials + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * kTile;
  for (int q = threadIdx.x; q < kTile / 4; q += kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < kWarps; ++w) {
      const float4 r = reinterpret_cast<const float4*>(priv + w * kTile)[q];
      s.x += r.x;
      s.y += r.y;
      s.z += r.z;
      s.w += r.w;
    }
    reinterpret_cast<float4*>(out)[q] = s;
  }
}

// The blocks' rows folded into the histogram, 32 bins a block: kSegs
// threads a bin each add one segment's rows in order from +0.0; then one
// adds the segment sums in order.
__global__ void __launch_bounds__(kThreads)
hist_fold_kernel(const float* __restrict__ partials, int blocks, int n_bins,
                 float* __restrict__ hist) {
  static_assert(kThreads == 32 * kSegs, "a thread for each bin and segment");
  __shared__ float seg_sum[kSegs][32];
  const int col = threadIdx.x % 32, seg = threadIdx.x / 32;
  const int b = blockIdx.x * 32 + col;
  const float* rows = partials + static_cast<long long>(b / kTile) * blocks * kTile + b % kTile;
  const int per = seg_rows(blocks), k0 = seg * per, count = max(0, min(per, blocks - k0));
  float s = 0.f;
  if (b < n_bins) {
#pragma unroll 8
    for (int k = 0; k < count; ++k) s += rows[static_cast<long long>(k0 + k) * kTile];
  }
  seg_sum[seg][col] = s;
  __syncthreads();
  if (seg == 0 && b < n_bins) {
    float t = 0.f;
    for (int j = 0; j < kSegs; ++j) t += seg_sum[j][col];
    hist[b] = t;
  }
}

// The backward of both binnings, one function: on a hit lane, with G the
// incoming gradient of the bins (read at stride gs: autograd hands the
// gradient of a sum as one value broadcast, stride 0),
//   - hard: d_energy = G[bin], bin = clip(int(time / bin_dt)) as the
//     forward's (hard_bin), the gather that transposes the JAX package's
//     segment_sum; time gets no cotangent, so d_time is not written;
//   - soft: autograd's statement of e_hi = e frac, e_lo = e - e_hi
//     (trace/bounce.py soft_histogram_plain): d_energy = G[lo] + (G[hi] -
//     G[lo]) frac and d_time = ((G[hi] - G[lo]) e) c / bin_dt, where c, the
//     gradient of clip(x, 0, 1), is 1 inside, 0 outside and 1/2 at either
//     bound — the JAX package's (its clip is min(max(x, 0), 1), whose ties
//     split the gradient).
// A dead lane gets +0.0.  These are the plain versions' operations in their
// order (trace/bounce.py hard_histogram_bwd_plain, soft_histogram_bwd_plain).
template <bool SOFT>
__device__ __forceinline__ void lane_bwd(float e, float time, bool hit,
                                         const float* __restrict__ g, long long gs, int n_bins,
                                         float bin_dt, float& d_e, float& d_t) {
  d_e = d_t = 0.f;
  if (!hit) return;
  if (!SOFT) {
    d_e = __ldg(g + hard_bin(time, n_bins, bin_dt) * gs);
    return;
  }
  const Tent s = tent(time, n_bins, bin_dt);
  const float g_lo = __ldg(g + s.lo * gs), g_hi = __ldg(g + s.hi * gs);
  const float g_e_hi = g_hi - g_lo;
  d_e = g_lo + g_e_hi * s.frac;
  const float g_frac = g_e_hi * e;
  const float g_x = s.x > 0.f && s.x < 1.f ? g_frac
                    : (s.x == 0.f || s.x == 1.f ? g_frac / 2.f : 0.f);
  d_t = g_x / bin_dt;
}

// What bounds the backward on the H100: bytes (hard: time and hit in,
// d_energy out, 9 B a lane; soft: energy too in and d_time out, 17 B),
// and at the main paths' sizes (10^5 lanes) the launch and one round trip
// to memory.  So:
//   - from kWideMin lanes on, where the bytes bound it (config 3's 3M
//     lanes), a thread takes kLanes = 4 consecutive lanes: energy and time
//     as one float4 each, hit as one 32-bit word, d_energy and d_time
//     stored as float4s (the last lanes of a count that is not a multiple
//     of 4, or arrays not aligned for the wide words, lane by lane: the
//     same values);
//   - below it, a thread takes one lane, in blocks of kNarrowBlock: four
//     lanes a thread read 10-25% slower there (kernel_sweep.py case hb);
//   - the bins' gradient (4 KB at 1024 bins) is read through the read-only
//     path, where it stays in L1.
constexpr int kNarrowBlock = 256;     // threads a block, one lane each
constexpr int kWideBlock = 128;       // threads a block, kLanes lanes each
constexpr int kLanes = 4;
constexpr long long kWideMin = 1 << 20;  // lanes from which a thread takes kLanes

template <bool SOFT, int LANES>
__device__ __forceinline__ void bwd_lanes(const float* __restrict__ energy,
                                          const float* __restrict__ time,
                                          const bool* __restrict__ hit,
                                          const float* __restrict__ g, long long gs, long long n,
                                          int n_bins, float bin_dt, bool vec,
                                          float* __restrict__ d_energy,
                                          float* __restrict__ d_time) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float de, dt;
  if (LANES == 1) {
    if (q >= n) return;
    lane_bwd<SOFT>(SOFT ? energy[q] : 0.f, time[q], hit[q], g, gs, n_bins, bin_dt, de, dt);
    d_energy[q] = de;
    if (SOFT) d_time[q] = dt;
    return;
  }
  const long long i0 = LANES * q;
  if (i0 >= n) return;
  if (vec && i0 + LANES <= n) {
    const float4 t4 = reinterpret_cast<const float4*>(time)[q];
    const unsigned h4 = reinterpret_cast<const unsigned*>(hit)[q];
    const float4 e4 = SOFT ? reinterpret_cast<const float4*>(energy)[q]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 de4, dt4;
    lane_bwd<SOFT>(e4.x, t4.x, h4 & 0xffu, g, gs, n_bins, bin_dt, de4.x, dt4.x);
    lane_bwd<SOFT>(e4.y, t4.y, (h4 >> 8) & 0xffu, g, gs, n_bins, bin_dt, de4.y, dt4.y);
    lane_bwd<SOFT>(e4.z, t4.z, (h4 >> 16) & 0xffu, g, gs, n_bins, bin_dt, de4.z, dt4.z);
    lane_bwd<SOFT>(e4.w, t4.w, h4 >> 24, g, gs, n_bins, bin_dt, de4.w, dt4.w);
    reinterpret_cast<float4*>(d_energy)[q] = de4;
    if (SOFT) reinterpret_cast<float4*>(d_time)[q] = dt4;
    return;
  }
  const long long end = min(i0 + LANES, n);
  for (long long i = i0; i < end; ++i) {
    lane_bwd<SOFT>(SOFT ? energy[i] : 0.f, time[i], hit[i], g, gs, n_bins, bin_dt, de, dt);
    d_energy[i] = de;
    if (SOFT) d_time[i] = dt;
  }
}

// Two names for the profiler; one body.
template <int LANES>
__global__ void __launch_bounds__(LANES == 1 ? kNarrowBlock : kWideBlock)
hard_bwd_kernel(const float* __restrict__ time, const bool* __restrict__ hit,
                const float* __restrict__ g, long long gs, long long n, int n_bins, float bin_dt,
                bool vec, float* __restrict__ d_energy) {
  bwd_lanes<false, LANES>(nullptr, time, hit, g, gs, n, n_bins, bin_dt, vec, d_energy, nullptr);
}

template <int LANES>
__global__ void __launch_bounds__(LANES == 1 ? kNarrowBlock : kWideBlock)
soft_bwd_kernel(const float* __restrict__ energy, const float* __restrict__ time,
                const bool* __restrict__ hit, const float* __restrict__ g, long long gs,
                long long n, int n_bins, float bin_dt, bool vec, float* __restrict__ d_energy,
                float* __restrict__ d_time) {
  bwd_lanes<true, LANES>(energy, time, hit, g, gs, n, n_bins, bin_dt, vec, d_energy, d_time);
}

inline bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// The histogram of n lanes into n_bins bins (soft: 0 hard, 1 tent), into
// hist.  partials is scratch of n_partials floats, at least tiles blocks
// kTile, with blocks = max(1, ceil(n / chunk)) (at most kMaxBlocks) and
// tiles = ceil(n_bins / kTile).  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue before any launch where the
// scratch is short.
extern "C" int hare_energy_histogram(const float* energy, const float* time, const bool* hit,
                                     long long n, int n_bins, float bin_dt, int soft,
                                     float* partials, long long n_partials, float* hist,
                                     void* stream) {
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunk = chunk_lanes(n);
  const long long blocks = n > 0 ? (n + chunk - 1) / chunk : 1;  // n = 0: one block writes zeros
  const long long tiles = (n_bins + kTile - 1) / kTile;
  if (tiles * blocks * kTile > n_partials) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  if (soft)
    hist_rows_kernel<true><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                      partials);
  else
    hist_rows_kernel<false><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins, bin_dt,
                                                       partials);
  hist_fold_kernel<<<(n_bins + 31) / 32, kThreads, 0, s>>>(partials, static_cast<int>(blocks),
                                                           n_bins, hist);
  return static_cast<int>(cudaGetLastError());
}

// The histogram's backward (soft: 0 hard, 1 tent): d(energy) of the n
// lanes from grad_hist, the incoming gradient of the n_bins bins, read at
// element stride grad_stride (0: one value broadcast); soft also d(time).
// Hard reads no energy and writes no d_time (either may be null).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_histogram_bwd(const float* energy, const float* time, const bool* hit,
                                  const float* grad_hist, long long grad_stride, long long n,
                                  int n_bins, float bin_dt, int soft, float* d_energy,
                                  float* d_time, void* stream) {
  if (n > 0 && n_bins > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = aligned_to(time, 16) && aligned_to(hit, 4) && aligned_to(d_energy, 16) &&
                     (!soft || (aligned_to(energy, 16) && aligned_to(d_time, 16)));
    if (n >= kWideMin) {
      const long long threads = (n + kLanes - 1) / kLanes;
      const unsigned blocks = static_cast<unsigned>((threads + kWideBlock - 1) / kWideBlock);
      if (soft)
        soft_bwd_kernel<kLanes><<<blocks, kWideBlock, 0, s>>>(
            energy, time, hit, grad_hist, grad_stride, n, n_bins, bin_dt, vec, d_energy, d_time);
      else
        hard_bwd_kernel<kLanes><<<blocks, kWideBlock, 0, s>>>(
            time, hit, grad_hist, grad_stride, n, n_bins, bin_dt, vec, d_energy);
    } else {
      const unsigned blocks = static_cast<unsigned>((n + kNarrowBlock - 1) / kNarrowBlock);
      if (soft)
        soft_bwd_kernel<1><<<blocks, kNarrowBlock, 0, s>>>(
            energy, time, hit, grad_hist, grad_stride, n, n_bins, bin_dt, vec, d_energy, d_time);
      else
        hard_bwd_kernel<1><<<blocks, kNarrowBlock, 0, s>>>(
            time, hit, grad_hist, grad_stride, n, n_bins, bin_dt, vec, d_energy);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
