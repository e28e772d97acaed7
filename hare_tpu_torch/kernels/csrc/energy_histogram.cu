// K3 energy_histogram, hard and soft binning, forward; and the soft
// binning's backward.  Deterministic: no float atomics.
//
// Replaces the XLA scatters of hare_tpu/trace/bounce.py energy_histogram:
// the hard segment_sum over clip(int(time / bin_dt)) (:294-300) and the
// soft ("tent") segment_sum (:280-293), which splits each energy between
// the two bins whose centres bracket time / bin_dt, the edge halves clamped
// into the end bins; dead lanes are dropped.  The hard backward is a gather
// in the torch wrapper (trace/bounce.py); the soft backward is
// soft_histogram_bwd below.
//
// Order.  Float atomics would make the summation order, and so the last
// bits of each bin, change from run to run.  Here every sum has a fixed
// order that depends on the lane count alone:
//   - a block takes `chunk` consecutive lanes, each of its warps a fixed
//     slice of them, 32 lanes a step (chunk_lanes: at least kMinChunk
//     lanes a block, at most kMaxBlocks blocks);
//   - in a step, lanes with the same bin are grouped (__match_any_sync)
//     and each group's values are added in lane order, then into the
//     warp's private row of bins in shared memory by the group's leader;
//   - the block folds its warps' rows in warp order into one partial row
//     in device memory, and a second launch folds the blocks' rows: eight
//     threads a bin each sum a fixed segment of the rows in order, then
//     one adds the eight in order.
// Bins come in tiles of kTile (blockIdx.y), so any n_bins fits the shared
// memory; a block reads its lanes once for each tile.
//
// What bounds it on the H100: bytes, the lanes' energy, time and hit (9 B
// a lane) read once and the bins written once.  The partial rows add 4 B a
// bin a block, written once and read once by the fold, within the 50 MB L2
// (at most kMaxBlocks rows).  A step's match, shuffles and adds are a
// dependent chain, so the kernel is latency-bound and wants many warps in
// flight: small chunks up to two blocks a multiprocessor, and a fold that
// spreads each bin's rows over eight threads.
//
// histogram_partials carries no __launch_bounds__: with it, ptxas of CUDA
// 12.8 fails on the soft instantiation (C7600, "Register allocation failed
// with register count of '7'"); without it the kernel takes 32 registers.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;                   // bins a block holds
constexpr long long kMinChunk = 1024;         // lanes a block sums, at least
constexpr long long kMaxBlocks = 264;         // two blocks a multiprocessor
                                              // (bounce.py's HIST_MAX_BLOCKS)
constexpr int kFoldBins = 32;                 // bins a fold block sums
constexpr int kFoldSegs = kThreads / kFoldBins;  // threads a bin in the fold

// Lanes a block sums: at least kMinChunk, few enough for kMaxBlocks blocks,
// a multiple of kThreads so each warp's slice is whole steps of 32.
__host__ __device__ inline long long chunk_lanes(long long n) {
  const long long want = (n + kMaxBlocks - 1) / kMaxBlocks;
  const long long chunk = (want + kThreads - 1) / kThreads * kThreads;
  return chunk > kMinChunk ? chunk : kMinChunk;
}
constexpr unsigned kFull = 0xffffffffu;

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

// Adds each lane's value into row[bin] (bin -1: nothing), the lanes of one
// bin summed in lane order by their group, then added by its leader.
__device__ __forceinline__ void add_in_lane_order(float* row, int bin, float val, int lane) {
  const unsigned peers = __match_any_sync(kFull, bin);
  float acc = 0.f;
  for (int k = 0; k < 32; ++k) {
    const float v = __shfl_sync(kFull, val, k);
    if ((peers >> k) & 1u) acc += v;
  }
  if (bin >= 0 && lane == __ffs(peers) - 1) row[bin] += acc;
}

template <bool SOFT>
__global__ void histogram_partials(const float* __restrict__ energy, const float* __restrict__ time,
                   const bool* __restrict__ hit, long long n, long long chunk, int n_bins,
                   float bin_dt, float* __restrict__ partials) {
  __shared__ float priv[kWarps * kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * kTile;
  const int tile = min(kTile, n_bins - b0);
  for (int b = threadIdx.x; b < kWarps * kTile; b += kThreads) priv[b] = 0.f;
  __syncthreads();
  float* row = priv + warp * kTile;
  const long long begin = blockIdx.x * chunk + warp * (chunk / kWarps);
  const long long end = min(begin + chunk / kWarps, n);
  for (long long base = begin; base < end; base += 32) {
    const long long i = base + lane;
    int bin_a = -1, bin_b = -1;
    float val_a = 0.f, val_b = 0.f;
    if (i < end && hit[i]) {
      const float e = energy[i];
      if (SOFT) {
        const Tent s = tent(time[i], n_bins, bin_dt);
        const float e_hi = e * s.frac;
        bin_a = s.lo;
        val_a = e - e_hi;
        bin_b = s.hi;
        val_b = e_hi;
      } else {
        bin_a = hard_bin(time[i], n_bins, bin_dt);
        val_a = e;
      }
    }
    // Bins outside this block's tile: none here.
    bin_a = bin_a >= b0 && bin_a < b0 + tile ? bin_a - b0 : -1;
    add_in_lane_order(row, bin_a, val_a, lane);
    if (SOFT) {
      bin_b = bin_b >= b0 && bin_b < b0 + tile ? bin_b - b0 : -1;
      add_in_lane_order(row, bin_b, val_b, lane);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < tile; b += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += priv[w * kTile + b];
    partials[static_cast<long long>(blockIdx.x) * n_bins + b0 + b] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_partials(const float* __restrict__ partials, int n_blocks, int n_bins,
              float* __restrict__ hist) {
  __shared__ float seg_sum[kFoldSegs][kFoldBins];
  const int col = threadIdx.x % kFoldBins, seg = threadIdx.x / kFoldBins;
  const int b = blockIdx.x * kFoldBins + col;
  const int per = (n_blocks + kFoldSegs - 1) / kFoldSegs;
  const int k1 = min((seg + 1) * per, n_blocks);
  float s = 0.f;
  if (b < n_bins) {
#pragma unroll 8
    for (int k = seg * per; k < k1; ++k) s += partials[static_cast<long long>(k) * n_bins + b];
  }
  seg_sum[seg][col] = s;
  __syncthreads();
  if (seg == 0 && b < n_bins) {
    float t = 0.f;
    for (int j = 0; j < kFoldSegs; ++j) t += seg_sum[j][col];
    hist[b] = t;
  }
}

// d(energy) and d(time) of the soft histogram, one thread a lane: on a hit
// lane, with G the incoming gradient of the bins, autograd's statement of
// e_hi = e frac, e_lo = e - e_hi (trace/bounce.py soft_histogram_plain):
// d_energy = G[lo] + (G[hi] - G[lo]) frac and d_time = ((G[hi] - G[lo]) e)
// c / bin_dt, where c, the gradient of clip(x, 0, 1), is 1 inside, 0
// outside and 1/2 at either bound — the JAX package's (its clip is
// min(max(x, 0), 1), whose ties split the gradient).
__global__ void __launch_bounds__(kThreads)
soft_bwd_kernel(const float* __restrict__ energy, const float* __restrict__ time,
                const bool* __restrict__ hit, const float* __restrict__ grad_hist, long long n,
                int n_bins, float bin_dt, float* __restrict__ d_energy,
                float* __restrict__ d_time) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!hit[i]) {
    d_energy[i] = 0.f;
    d_time[i] = 0.f;
    return;
  }
  const Tent s = tent(time[i], n_bins, bin_dt);
  const float g_lo = grad_hist[s.lo], g_hi = grad_hist[s.hi];
  const float g_e_hi = g_hi - g_lo;
  d_energy[i] = g_lo + g_e_hi * s.frac;
  const float g_frac = g_e_hi * energy[i];
  const float g_x = s.x > 0.f && s.x < 1.f ? g_frac
                    : (s.x == 0.f || s.x == 1.f ? g_frac / 2.f : 0.f);
  d_time[i] = g_x / bin_dt;
}

}  // namespace

// The histogram of n lanes into n_bins bins (soft: 0 hard, 1 tent), into
// hist.  partials is scratch of n_partials floats, at least
// min(ceil(n / 1024), 264) * n_bins.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hare_energy_histogram(const float* energy, const float* time, const bool* hit,
                                     long long n, int n_bins, float bin_dt, int soft,
                                     float* partials, long long n_partials, float* hist,
                                     void* stream) {
  if (n_bins <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long chunk = chunk_lanes(n);
  const long long blocks = (n + chunk - 1) / chunk;
  if (blocks * n_bins > n_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const dim3 grid(static_cast<unsigned>(blocks), (n_bins + kTile - 1) / kTile);
    if (soft)
      histogram_partials<true><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins,
                                                         bin_dt, partials);
    else
      histogram_partials<false><<<grid, kThreads, 0, s>>>(energy, time, hit, n, chunk, n_bins,
                                                          bin_dt, partials);
  }
  fold_partials<<<(n_bins + kFoldBins - 1) / kFoldBins, kThreads, 0, s>>>(
      partials, static_cast<int>(blocks), n_bins, hist);
  return static_cast<int>(cudaGetLastError());
}

// The soft histogram's d(energy) and d(time), (n,) each, from the incoming
// gradient of the n_bins bins.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hare_soft_histogram_bwd(const float* energy, const float* time, const bool* hit,
                                       const float* grad_hist, long long n, int n_bins,
                                       float bin_dt, float* d_energy, float* d_time,
                                       void* stream) {
  if (n > 0 && n_bins > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    soft_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(energy, time, hit, grad_hist, n,
                                                           n_bins, bin_dt, d_energy, d_time);
  }
  return static_cast<int>(cudaGetLastError());
}
