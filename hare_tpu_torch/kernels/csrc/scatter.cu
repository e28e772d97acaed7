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
// Order, defined by positions alone.  The original positions are cut into
// chunks of kChunk consecutive indices.  Inside a chunk each key's values
// are summed from +0.0 in index order; a key's chunk sums are then added,
// from +0.0, in chunk order.  No sum is -0.0 (a fold from +0.0 never gives
// it), so a chunk without the key adds an exact no-op, and the plain
// version (hare_tpu_torch/accel/scatter.py scatter_add_plain: index_add_
// into zeros a chunk, the chunks' sums added in order) gives these bits.
// A key whose values lie in one chunk is summed as CPU index_add_ sums it.
//
// Pass 1 (scatter_ordered_chunks), one block a chunk: the chunk's values
// are loaded coalesced, in original order, into shared memory, and its
// (key, position) pairs, one integer each, are sorted (bitonic: the
// position makes every pair distinct, so any sort is stable; strides up to
// 32 in registers and shuffles, 10 of the 55 stages through shared
// memory); each run of one key is folded in index order, by the thread at
// its start where it spans at most 32 positions, else by the warp (32
// values staged at once in shared memory, added in order); the chunk's
// distinct keys, ascending, their sums and their count go to scratch.  Keys
// outside [0, n_keys) sort last and are dropped.
// Pass 2 (scatter_ordered_keys), one block a range of key_range keys (32
// to 256: the largest that still gives kRangeBlocks blocks, two an SM): a
// thread a chunk finds the range's entries in that chunk's sorted list by
// two binary searches (the second over at most key_range places).  Where a
// batch of 256 chunks holds at most kListed entries of the range, they are
// copied into a list in shared memory, in chunk order, and each key's
// thread reads through it, adding its own.  Else, as many chunks at a time
// as a 32 KB table holds, each chunk's entries (a thread a chunk, kInFlight
// loads in flight) are written into a dense (chunk x key) table in shared
// memory, zeros elsewhere, and the thread of each key adds its column in
// chunk order.  Every key of the range writes its sum, zero where it has
// no value, so the output needs no fill.  A range without entries in a
// batch of chunks skips it.
//
// No host sort and no scratch to reset: every scratch word pass 2 reads is
// written by pass 1 of the same call.  The scratch's layout and size are
// this file's alone: the caller passes kChunk (which its plain version cuts
// by) and the words it holds, and a mismatch is refused.
//
// What bounds it on the H100: bytes (each key and value read once, each sum
// written once) at these sizes, far below what a launch costs; in practice
// latency: pass 1's sort and its longest run, a serial chain of up to
// kChunk adds; pass 2's dependent loads.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;      // original positions a chunk
constexpr int kPosBits = 10;      // log2(kChunk)
constexpr int kSortThreads = 512;  // pass 1: two pairs a thread
constexpr int kPass2Threads = 256;  // pass 2: up to one a key of the range
constexpr int kRangeBlocks = 264;   // pass 2: blocks wanted (two an SM of an H100)
constexpr int kTableFloats = 8192;  // pass 2's (chunk, key) table: 32 KB
constexpr int kInFlight = 4;      // pass 2: entry loads a thread issues at once
constexpr int kListed = 256;      // pass 2: entries of a batch kept as a list
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldDepth = 8;     // positions of a run loaded at once

// A (key, position) pair as one unsigned integer, key above position:
// 32 bits where every key fits in 22 (n_keys < 2^22), else 64.  The
// all-ones key field is the sort key of a dropped value: it sorts last.
template <typename P>
struct Pairs {
  static constexpr int kShift = sizeof(P) == 4 ? kPosBits : 32;
  static constexpr P kDrop = static_cast<P>(~P(0)) >> kShift;
  __device__ static P make(P key, int pos) { return (key << kShift) | static_cast<P>(pos); }
  __device__ static P key(P x) { return x >> kShift; }
  __device__ static int pos(P x) { return static_cast<int>(x & (kChunk - 1)); }
};

// One register stage of the bitonic sort: x at position p against the
// pair at p ^ j (j <= 16, in lane ^ j), in a run of k sorted ascending
// where p & k == 0.
template <typename P>
__device__ __forceinline__ P bitonic_shfl(P x, int p, int j, int k) {
  const P y = __shfl_xor_sync(kFull, x, j);
  const bool keep_min = ((p & k) == 0) == ((p & j) == 0);
  return keep_min ? (y < x ? y : x) : (y < x ? x : y);
}

// Pass 1: the chunk's distinct keys (ascending) and their sums, from +0.0
// in index order, into ukeys / usums at chunk * kChunk, their count into
// ucount[chunk].
template <int C, typename P>
__global__ void __launch_bounds__(kSortThreads)
scatter_ordered_chunks(const int* __restrict__ keys, const float* __restrict__ values, long long m,
                       int n_keys, int* __restrict__ ukeys, float* __restrict__ usums,
                       int* __restrict__ ucount) {
  using Q = Pairs<P>;
  __shared__ P s_pair[kChunk];
  __shared__ float s_val[kChunk * C];
  __shared__ int s_warp[kSortThreads / 32];
  __shared__ __align__(16) float s_stage[kSortThreads / 32][2][32 * C];  // long folds
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), m - c0));
#pragma unroll
  for (int q = 0; q < kChunk * C / kSortThreads; ++q) {  // all loads in flight at once
    const int i = t + q * kSortThreads;
    if (i < len * C) s_val[i] = values[c0 * C + i];
  }

  // Bitonic sort, ascending.  Warp w holds positions 64 w + lane (x0) and
  // 64 w + 32 + lane (x1) in registers: strides up to 32 are register
  // compares and shuffles; strides of 64 and more go through shared memory.
  const int p0 = 64 * warp + lane, p1 = p0 + 32;
  P x0, x1;
  {
    const int k0 = p0 < len ? keys[c0 + p0] : -1;
    const int k1 = p1 < len ? keys[c0 + p1] : -1;
    x0 = Q::make(k0 >= 0 && k0 < n_keys ? static_cast<P>(k0) : Q::kDrop, p0);
    x1 = Q::make(k1 >= 0 && k1 < n_keys ? static_cast<P>(k1) : Q::kDrop, p1);
  }
  for (int k = 2; k <= kChunk; k <<= 1) {
    int j = k >> 1;
    if (j >= 64) {
      s_pair[p0] = x0;
      s_pair[p1] = x1;
      __syncthreads();
      for (; j >= 64; j >>= 1) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const P a = s_pair[i], b = s_pair[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s_pair[i] = b;
          s_pair[i + j] = a;
        }
        __syncthreads();
      }
      x0 = s_pair[p0];
      x1 = s_pair[p1];
    }
    if (j == 32) {
      const P lo = x0 < x1 ? x0 : x1, hi = x0 < x1 ? x1 : x0;
      const bool up = (p0 & k) == 0;
      x0 = up ? lo : hi;
      x1 = up ? hi : lo;
      j = 16;
    }
    for (; j > 0; j >>= 1) {
      x0 = bitonic_shfl(x0, p0, j, k);
      x1 = bitonic_shfl(x1, p1, j, k);
    }
  }
  __syncthreads();  // the last shared-memory stage is read
  s_pair[p0] = x0;
  s_pair[p1] = x1;
  __syncthreads();

  // Run starts; thread t owns sorted positions 2t and 2t + 1.  A run's
  // place among the chunk's distinct keys is the count of starts before it.
  const int j0 = 2 * t;
  const P k0 = Q::key(s_pair[j0]), k1 = Q::key(s_pair[j0 + 1]);
  const bool st0 = k0 != Q::kDrop && (j0 == 0 || Q::key(s_pair[j0 - 1]) != k0);
  const bool st1 = k1 != Q::kDrop && k1 != k0;
  const int cnt = st0 + st1;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kSortThreads / 32;
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int first_u = incl - cnt + (warp > 0 ? s_warp[warp - 1] : 0);
  const int total = s_warp[kSortThreads / 32 - 1];
  if (t == 0) ucount[blockIdx.x] = total;

  // A run of at most 32 positions is folded by the thread at its start; a
  // longer one by the warp whose 64 positions hold its start.
  const bool long0 = st0 && Q::key(s_pair[min(j0 + 32, kChunk - 1)]) == k0 && j0 + 32 < kChunk;
  const bool long1 = st1 && Q::key(s_pair[min(j0 + 33, kChunk - 1)]) == k1 && j0 + 33 < kChunk;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (!(h == 0 ? st0 && !long0 : st1 && !long1)) continue;
    const P key = h == 0 ? k0 : k1;
    const int u = first_u + (h == 1 && st0);
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    // The run's positions ascend (the sort breaks key ties by position):
    // fold them in order, kFoldDepth loaded at once.
    for (int at = j0 + h;; at += kFoldDepth) {
      bool in[kFoldDepth];
      int pos[kFoldDepth];
#pragma unroll
      for (int q = 0; q < kFoldDepth; ++q) {
        const int x = at + q;
        const P pair = s_pair[min(x, kChunk - 1)];
        in[q] = x < kChunk && Q::key(pair) == key;
        pos[q] = in[q] ? Q::pos(pair) : 0;
      }
      float v[kFoldDepth][C];
#pragma unroll
      for (int q = 0; q < kFoldDepth; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) v[q][c] = s_val[pos[q] * C + c];
      bool more = true;
#pragma unroll
      for (int q = 0; q < kFoldDepth; ++q) {
        more = more && in[q];
        if (more) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += v[q][c];
        }
      }
      if (!more) break;
    }
    ukeys[c0 + u] = static_cast<int>(key);
#pragma unroll
    for (int c = 0; c < C; ++c) usums[(c0 + u) * C + c] = acc[c];
  }
  // Long runs, one at a time: the lanes stage 32 values at once in shared
  // memory (the next 32 while these are added) and every lane adds them in
  // order, so each lane holds the same sum.
  unsigned long long longs = static_cast<unsigned long long>(__ballot_sync(kFull, long0)) |
                             static_cast<unsigned long long>(__ballot_sync(kFull, long1)) << 32;
  while (longs) {
    const int bit = __ffsll(static_cast<long long>(longs)) - 1;
    longs &= longs - 1;
    const int src = bit & 31, h = bit >> 5;
    const P key = __shfl_sync(kFull, h == 0 ? k0 : k1, src);
    const int u = __shfl_sync(kFull, first_u + (h == 1 && st0), src);
    const int s0 = 2 * (32 * warp + src) + h;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    // Lane l stages the value of position at + l (0 past the run) into
    // buffer buf; returns how many of the 32 are in the run (a prefix).
    auto stage = [&](int at, int buf) {
      const int x = at + lane;
      const P pair = s_pair[min(x, kChunk - 1)];
      const bool in = x < kChunk && Q::key(pair) == key;
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_stage[warp][buf][lane * C + c] = in ? s_val[Q::pos(pair) * C + c] : 0.f;
      const int count = __popc(__ballot_sync(kFull, in));
      __syncwarp();
      return count;
    };
    int count = stage(s0, 0);
    for (int at = s0, b = 0; count > 0; at += 32, b ^= 1) {
      const int next = count == 32 ? stage(at + 32, b ^ 1) : 0;
      const float* vals = s_stage[warp][b];
      if (count == 32) {
#pragma unroll
        for (int l = 0; l < 32 * C; l += C) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += vals[l + c];
        }
      } else {
        for (int l = 0; l < count * C; l += C) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += vals[l + c];
        }
      }
      __syncwarp();  // buffer b is read before it is staged again
      count = next;
    }
    if (lane == 0) {
      ukeys[c0 + u] = static_cast<int>(key);
#pragma unroll
      for (int c = 0; c < C; ++c) usums[(c0 + u) * C + c] = acc[c];
    }
  }
}

// The first place in a[lo, hi) (ascending) holding a value >= x.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Pass 2: out[k] for the keys k of this block's range r (key_range keys,
// 32 to 256), each key's chunk sums added from +0.0 in chunk order.  A
// chunk's entries of the range are found by two binary searches in the
// chunk's list.
template <int C>
__global__ void __launch_bounds__(kPass2Threads)
scatter_ordered_keys(const int* __restrict__ ukeys, const float* __restrict__ usums,
                     const int* __restrict__ ucount, long long n_chunks, int n_keys,
                     int key_range, float* __restrict__ out) {
  __shared__ float s_tab[kTableFloats];  // (chunk of the group, key of the range, C)
  __shared__ int s_lo[kPass2Threads], s_hi[kPass2Threads];
  __shared__ int s_warp[kPass2Threads / 32];
  const int t = threadIdx.x;
  const int k0 = blockIdx.x * key_range;
  const int k1 = min(k0 + key_range, n_keys);
  const int group = min(kPass2Threads, kTableFloats / (key_range * C));  // chunks a table
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (long long cb = 0; cb < n_chunks; cb += kPass2Threads) {
    const long long ch = cb + t;
    int lo = 0, hi = 0;
    if (ch < n_chunks) {
      // The chunk's keys are distinct: at most key_range lie in the range.
      const int* u = ukeys + ch * kChunk;
      const int cnt = ucount[ch];
      lo = lower_bound(u, 0, cnt, k0);
      hi = lower_bound(u, lo, min(cnt, lo + key_range), k1);
    }
    __syncthreads();  // the last batch's bounds and table are no longer read
    s_lo[t] = lo;
    s_hi[t] = hi;
    if (!__syncthreads_or(hi > lo)) continue;
    // The batch's entries of the range, chunk by chunk: where few, a list
    // in chunk order that each key's thread reads through, adding its own.
    int incl = hi - lo;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if ((t & 31) >= o) incl += y;
    }
    if ((t & 31) == 31) s_warp[t >> 5] = incl;
    __syncthreads();
    int off = incl - (hi - lo), n_e = 0;
#pragma unroll
    for (int w = 0; w < kPass2Threads / 32; ++w) {
      off += w < (t >> 5) ? s_warp[w] : 0;
      n_e += s_warp[w];
    }
    if (n_e <= kListed) {
      int* e_key = reinterpret_cast<int*>(s_tab);
      float* e_val = s_tab + kListed;
      const long long base = ch * kChunk;
      for (int j0 = lo; j0 < hi; j0 += kInFlight) {
        int key[kInFlight];
        float v[kInFlight][C];
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) {
          const bool in = j0 + f < hi;
          key[f] = in ? ukeys[base + j0 + f] - k0 : -1;
#pragma unroll
          for (int c = 0; c < C; ++c) v[f][c] = in ? usums[(base + j0 + f) * C + c] : 0.f;
        }
#pragma unroll
        for (int f = 0; f < kInFlight; ++f) {
          if (key[f] < 0) continue;
          const int e = off + j0 - lo + f;
          e_key[e] = key[f];
#pragma unroll
          for (int c = 0; c < C; ++c) e_val[e * C + c] = v[f][c];
        }
      }
      __syncthreads();
      if (t < key_range) {
        for (int e = 0; e < n_e; ++e) {
          if (e_key[e] != t) continue;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += e_val[e * C + c];
        }
      }
      continue;  // the next batch's first barrier orders the list's reads
    }
    const int nb = static_cast<int>(min(static_cast<long long>(kPass2Threads), n_chunks - cb));
    for (int g0 = 0; g0 < nb; g0 += group) {
      const int ng = min(group, nb - g0);
      if (!__syncthreads_or(t < ng && s_hi[g0 + t] > s_lo[g0 + t])) continue;
      for (int i = t; i < ng * key_range * C; i += kPass2Threads) s_tab[i] = 0.f;
      __syncthreads();
      // Thread q writes the entries of the group's chunk q (at most
      // key_range), kInFlight loads at a time.
      if (t < ng) {
        float* row = s_tab + t * key_range * C;
        const long long base = (cb + g0 + t) * kChunk;
        const int hi_t = s_hi[g0 + t];
        for (int j0 = s_lo[g0 + t]; j0 < hi_t; j0 += kInFlight) {
          int key[kInFlight];
          float v[kInFlight][C];
#pragma unroll
          for (int f = 0; f < kInFlight; ++f) {
            const bool in = j0 + f < hi_t;
            key[f] = in ? ukeys[base + j0 + f] - k0 : -1;
#pragma unroll
            for (int c = 0; c < C; ++c) v[f][c] = in ? usums[(base + j0 + f) * C + c] : 0.f;
          }
#pragma unroll
          for (int f = 0; f < kInFlight; ++f) {
            if (key[f] < 0) continue;
#pragma unroll
            for (int c = 0; c < C; ++c) row[key[f] * C + c] = v[f][c];
          }
        }
      }
      __syncthreads();
      if (t < key_range) {
#pragma unroll 8
        for (int q = 0; q < ng; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += s_tab[(q * key_range + t) * C + c];
        }
      }
      __syncthreads();  // the table is read before the next group zeroes it
    }
  }
  if (k0 + t < k1) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[static_cast<long long>(k0 + t) * C + c] = acc[c];
  }
}

template <int C, typename P>
void launch_pairs(const int* keys, const float* values, long long m, int n_keys, int* ukeys,
                  float* usums, int* ucount, float* out, cudaStream_t s) {
  const long long n_chunks = (m + kChunk - 1) / kChunk;
  int key_range = kPass2Threads;
  while (key_range > 32 && n_keys < kRangeBlocks * key_range) key_range >>= 1;
  if (n_chunks > 0)
    scatter_ordered_chunks<C, P><<<static_cast<unsigned>(n_chunks), kSortThreads, 0, s>>>(
        keys, values, m, n_keys, ukeys, usums, ucount);
  if (n_keys > 0)
    scatter_ordered_keys<C><<<(n_keys + key_range - 1) / key_range, kPass2Threads, 0, s>>>(
        ukeys, usums, ucount, n_chunks, n_keys, key_range, out);
}

template <int C>
void launch(const int* keys, const float* values, long long m, int n_keys, int* scratch,
            float* out, cudaStream_t s) {
  const long long placed = (m + kChunk - 1) / kChunk * kChunk;
  int* ukeys = scratch;
  float* usums = reinterpret_cast<float*>(scratch + placed);
  int* ucount = scratch + placed * (1 + C);
  if (n_keys <= Pairs<unsigned>::kDrop)
    launch_pairs<C, unsigned>(keys, values, m, n_keys, ukeys, usums, ucount, out, s);
  else
    launch_pairs<C, unsigned long long>(keys, values, m, n_keys, ukeys, usums, ucount, out, s);
}

}  // namespace

// keys (m,) i32; values (m, cols) f32, cols 1 or 3; out (n_keys, cols) f32,
// every element written.  chunk: the caller's chunk size, which must be
// kChunk.  scratch: scratch_words int32 words, at least
// ceil(m / kChunk) * (kChunk * (1 + cols) + 1) (per chunk its distinct
// keys, their sums and their count); nothing in it need be set.  Launches
// on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// chunk other than kChunk or too small a scratch.
extern "C" int hare_scatter_add_ordered(const int* keys, const float* values, long long m,
                                        int cols, int n_keys, int chunk, int* scratch,
                                        long long scratch_words, float* out, void* stream) {
  const long long n_chunks = (m + kChunk - 1) / kChunk;
  if ((cols != 1 && cols != 3) || m < 0 || n_keys < 0 || chunk != kChunk ||
      scratch_words < n_chunks * (kChunk * (1LL + cols) + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols == 1)
    launch<1>(keys, values, m, n_keys, scratch, out, s);
  else
    launch<3>(keys, values, m, n_keys, scratch, out, s);
  return static_cast<int>(cudaGetLastError());
}
