// scatter_add_ordered: out[k] = sum of values[i] over keys[i] == k, in a
// fixed order: no float atomics, so two runs give the same bits.
//
// Replaces the XLA scatter-adds that transpose the JAX package's gathers on
// its gradient paths: vertices[iv[:, k]] (hare_tpu/accel/common.py:390, the
// finalize backward's vertex cotangents) and absorption[pid]
// (hare_tpu/trace/bounce.py:194, the absorption gradient).  PyTorch's
// scatter-add on the card is a float atomic: its order, and so the last
// bits of each sum, change from run to run.
//
// Order.  The wrapper (hare_tpu_torch/accel/scatter.py) sorts the keys with
// a stable sort, so each key's values form one run of sorted positions in
// increasing original index.  The sorted positions are cut into segments
// of `segment` (the wrapper's SEGMENT).  Pass 1 (scatter_ordered_pieces)
// sums each piece, the part of a run inside one segment, from 0 in index
// order; pass 2 (scatter_ordered_runs, one thread a run) adds a run's
// pieces in segment order.
// A run inside one segment is one piece, summed exactly as index_add_ sums
// it on the CPU, so its bits equal the CPU's; a run that crosses segments
// differs from the CPU's by rounding.  The CPU's order for every run, one
// chain of adds a key, made eval config 3's absorption gradient (runs of
// 147k values) cost 3.0-4.7 ms of a 13-16 ms step on an H100; the pieces
// cut each chain to `segment` adds.
//
// Design of pass 1: one warp a window of 32 sorted positions.  Each lane
// loads its own position's key, index and value; a ballot finds the piece
// starts (a run's start, or a segment's first position); for each start,
// in order, every lane folds the piece's values in the window in order
// through shuffles, so the adds form one chain that no lane reorders.  A
// piece that reaches the window's end goes on loading kDepth steps of 32
// at once, so their three dependent loads (sorted key, index, value) are
// in flight together.  Short runs cost a few shuffles each; a long piece
// is at most `segment` adds.  Keys with no values keep the zeros the
// wrapper writes.
//
// What bounds it on the H100: bytes.  Each element's sorted key (4 B),
// index (8 B) and value (4 C B) are read once; the sums written once (the
// pieces add 4 C B a piece, a small share where runs are long).  A
// piece is a serial chain of up to `segment` adds on one warp; the windows
// run in parallel.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kDepth = 8;         // steps of 32 a long piece loads at once
constexpr int kRunDepth = 8;      // segments pass 2 loads at once

// Folds into acc, in order, the values of the positions at + 32 q + lane
// (q < Q) below lim that belong to the run of run_key; returns whether the
// piece may go on past them.  Its positions are a prefix of each step's
// lanes.
template <int C, int Q>
__device__ __forceinline__ bool fold_steps(const int* __restrict__ sorted_keys,
                                           const long long* __restrict__ perm,
                                           const float* __restrict__ values, long long lim,
                                           int run_key, long long at, int lane, float (&acc)[C]) {
  bool in[Q];
  long long src[Q];
  float v[Q][C];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long i = at + 32 * q + lane;
    in[q] = i < lim && sorted_keys[i] == run_key;
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) src[q] = in[q] ? perm[at + 32 * q + lane] : 0;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c) v[q][c] = in[q] ? values[src[q] * C + c] : 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int count = __popc(__ballot_sync(kFull, in[q]));
    if (count == 32) {  // unrolled: the shuffles run ahead of the chain of adds
#pragma unroll
      for (int l = 0; l < 32; ++l) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += __shfl_sync(kFull, v[q][c], l);
      }
      continue;
    }
    for (int l = 0; l < count; ++l) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += __shfl_sync(kFull, v[q][c], l);
    }
    return false;
  }
  return true;
}

// Pass 1: pieces[j] = the sum of the piece that starts at sorted position j.
template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_ordered_pieces(const int* __restrict__ sorted_keys, const long long* __restrict__ perm,
                       const float* __restrict__ values, long long m, long long segment,
                       float* __restrict__ pieces) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long base = warp * 32; base < m; base += n_warps * 32) {
    const long long j = base + lane;
    const bool live = j < m;
    const int key = live ? sorted_keys[j] : 0;
    const bool start = live && (j % segment == 0 || sorted_keys[j - 1] != key);
    const long long src = live ? perm[j] : 0;
    float mine[C];
#pragma unroll
    for (int c = 0; c < C; ++c) mine[c] = live ? values[src * C + c] : 0.f;
    unsigned starts = __ballot_sync(kFull, start);
    while (starts) {  // each piece that starts here, in order
      const int s = __ffs(starts) - 1;
      starts &= starts - 1;
      const int run_key = __shfl_sync(kFull, key, s);
      const long long lim = min((base + s) / segment * segment + segment, m);
      // The piece's lanes here are s .. end - 1 (sorted: a prefix from s).
      const int end = s + __popc(__ballot_sync(kFull, lane >= s && j < lim && key == run_key));
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      for (int l = s; l < end; ++l) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += __shfl_sync(kFull, mine[c], l);
      }
      bool more = end == 32;  // the piece may go on past this window
      for (long long at = base + 32; more && at < lim; at += 32 * kDepth)
        more = fold_steps<C, kDepth>(sorted_keys, perm, values, lim, run_key, at, lane, acc);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) pieces[(base + s) * C + c] = acc[c];
      }
    }
  }
}

// Pass 2: out[key] = the run's pieces added in segment order, one thread a
// run (at its start); the pieces after the first start at segment bounds.
template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_ordered_runs(const int* __restrict__ sorted_keys, const float* __restrict__ pieces,
                     long long m, long long segment, int n_keys, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < m;
       j += stride) {
    const int key = sorted_keys[j];
    if (j > 0 && sorted_keys[j - 1] == key) continue;  // not a run's start
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = pieces[j * C + c];
    for (long long b = (j / segment + 1) * segment;; b += kRunDepth * segment) {
      bool in[kRunDepth];
      float v[kRunDepth][C];
#pragma unroll
      for (int q = 0; q < kRunDepth; ++q) {
        const long long at = b + q * segment;
        in[q] = at < m && sorted_keys[at] == key;
      }
#pragma unroll
      for (int q = 0; q < kRunDepth; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[q][c] = in[q] ? pieces[(b + q * segment) * C + c] : 0.f;
      bool more = true;
#pragma unroll
      for (int q = 0; q < kRunDepth; ++q) {
        more = more && in[q];
        if (more) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += v[q][c];
        }
      }
      if (!more) break;
    }
    if (key >= 0 && key < n_keys) {
#pragma unroll
      for (int c = 0; c < C; ++c) out[static_cast<long long>(key) * C + c] = acc[c];
    }
  }
}

}  // namespace

// sorted_keys (m,) i32 and perm (m,) i64 from a stable sort of the keys;
// values (m, cols) f32, cols 1 or 3; segment > 0, the sorted positions
// summed apart; pieces (m, cols) f32 scratch; out (n_keys, cols) f32
// holding zeros.  Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_scatter_add_ordered(const int* sorted_keys, const long long* perm,
                                        const float* values, long long m, int cols,
                                        long long segment, int n_keys, float* pieces, float* out,
                                        void* stream) {
  if ((cols != 1 && cols != 3) || segment <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0) {
    // Pass 1: a warp a window of 32 positions; pass 2: a thread a position.
    const long long want1 = ((m + 31) / 32 * 32 + kThreads - 1) / kThreads;
    const int blocks1 = static_cast<int>(want1 < 4096 ? want1 : 4096);
    const long long want2 = (m + kThreads - 1) / kThreads;
    const int blocks2 = static_cast<int>(want2 < 4096 ? want2 : 4096);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cols == 1) {
      scatter_ordered_pieces<1><<<blocks1, kThreads, 0, s>>>(sorted_keys, perm, values, m, segment,
                                                             pieces);
      scatter_ordered_runs<1><<<blocks2, kThreads, 0, s>>>(sorted_keys, pieces, m, segment, n_keys,
                                                           out);
    } else {
      scatter_ordered_pieces<3><<<blocks1, kThreads, 0, s>>>(sorted_keys, perm, values, m, segment,
                                                             pieces);
      scatter_ordered_runs<3><<<blocks2, kThreads, 0, s>>>(sorted_keys, pieces, m, segment, n_keys,
                                                           out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
