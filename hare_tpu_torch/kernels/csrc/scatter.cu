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
// Pass 2 adds each key's chunk sums in chunk order, a range of key_range
// keys at a time (32 to 256: the largest that still gives kRangeBlocks
// ranges, two an SM).  Which chunks hold entries of a range it learns one
// of two ways:
// - Searched (scatter_ordered_keys, one block a range): a thread a chunk
//   finds the range's entries in that chunk's list by two binary searches
//   (the second over at most key_range places).  Its work is n_ranges x
//   n_chunks searches, most of which find nothing where the keys are many:
//   at 5,242,892 keys and 1,024 chunks, 21M searches for at most 2^20
//   entries.
// - Listed (scatter_ordered_listed): pass 1 also cuts each chunk's list
//   where its keys enter a new range, one (range, chunk, [lo, hi)) pair a
//   piece, writes each pair's lo and counts the pairs of each range with
//   integer atomics (any order gives the same counts); the count an atomic
//   returns is the pair's place among its range's pairs.
//   scatter_ordered_scan (one block) turns the counts into each range's
//   segment and scatter_ordered_place puts every pair at its place in its
//   range's segment (scatter_ordered_zero zeroed the counts before pass
//   1).  A range's pairs are then put in chunk order: its chunks are
//   distinct, so the order the atomics gave leaves no trace.  Only the
//   listed [lo, hi) pieces are read: the work follows the entries.  A
//   block takes kWarps ranges.  A warp alone takes a range of at most
//   kWarpPairs pairs and kWarpListed entries: it ranks the pairs with
//   shuffles (a pair's rank is the count of smaller chunk ids), copies the
//   entries into a list in shared memory in chunk order, and each lane
//   adds those of its keys as it reads through the list.  The block takes
//   any other range itself, sorting its pairs by chunk in shared memory
//   (bitonic; beyond kMaxPairs of them, it searches).
//   Listing costs three launches more than searching (about 0.002 ms each
//   where the card is idle), so pass 2 lists only where the searches are
//   many: n_ranges x n_chunks above kSearchesMax (the rule in plan()).
// Where a block takes a range, it takes the range's entries 256 chunks at a
// time, in chunk order.  Where a batch holds at most kListed entries of the
// range, they are copied into a list in shared memory, in chunk order, and
// each key's thread reads through it, adding its own.  Else, as many
// chunks at a time as a 32 KB table holds, each chunk's entries (a thread
// a chunk, kInFlight loads in flight) are written into a dense (chunk x
// key) table in shared memory, zeros elsewhere (its columns only the keys
// the batch holds where a table of all key_range would hold too few
// chunks: the walls' few keys at config 5), and the thread of each key
// adds its column in chunk order.  Every way, a key adds its chunk sums in
// chunk order, and a chunk without the key adds nothing or +0.0, so all
// ways give the same bits.  Every key of a range writes its sum, zero where
// it has no value, so the output needs no fill.  A range without entries
// in a batch of chunks skips it.
//
// No host sort and no scratch to reset: every scratch word a launch reads
// is written by an earlier launch of the same call.  The scratch's layout
// and size are this file's alone: the caller passes kChunk (which its plain
// version cuts by) and the words it holds, and a mismatch is refused.
//
// What bounds it on the H100: bytes (each key and value read once, each sum
// written once), 29.4 MB at 2^20 values into 5,242,892 keys; far below what
// a launch costs at the bench's sizes.  In practice latency: pass 1's sort
// and its longest run, a serial chain of up to kChunk adds; pass 2's
// dependent loads, a range at a time on each block or warp.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;      // original positions a chunk
constexpr int kPosBits = 10;      // log2(kChunk)
constexpr int kSortThreads = 512;  // pass 1: two pairs a thread
constexpr int kPass2Threads = 256;  // pass 2: up to one a key of the range
constexpr int kRangeBlocks = 264;   // pass 2: blocks wanted (two an SM of an H100)
constexpr int kMinRange = 32;       // pass 2: the fewest keys a range holds
constexpr int kTableFloats = 8192;  // pass 2's (chunk, key) table: 32 KB
constexpr int kInFlight = 4;      // pass 2: entry loads a thread issues at once
constexpr int kListed = 256;      // pass 2: entries of a batch kept as a list
constexpr int kMaxPairs = 1024;   // pass 2: listed pairs a block sorts (4 a thread)
constexpr int kPairsPerThread = kMaxPairs / kPass2Threads;
constexpr int kWarps = kPass2Threads / 32;  // listed pass 2: ranges a block
constexpr int kWarpPairs = 64;    // listed pass 2: pairs a warp ranks (2 a lane)
constexpr int kWarpListed = 256;  // listed pass 2: entries a warp lists
constexpr int kWarpWords = kTableFloats / kWarps;  // a warp's list: keys, then sums
// Pass 2 lists pairs where it would otherwise make more searches than this.
constexpr long long kSearchesMax = 1LL << 20;
constexpr int kScanThreads = 1024;  // scatter_ordered_scan: one block
constexpr int kScanItems = 8;       // counts a thread scans at a time
constexpr int kPlaceThreads = 256;  // scatter_ordered_place: a block a chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldDepth = 8;     // positions of a run loaded at once

// The scratch, int32 words: per chunk its distinct keys (kChunk), their
// sums (kChunk * C), their count, its pairs' starts and their places in
// their ranges (kChunk each) and their count; per range of kMinRange keys
// (at least as many as pass 2's ranges) a count and an offset, and one
// more offset; per value at most one pair (each holds a value): its chunk
// and its [lo, hi).  hare_tpu_torch/accel/scatter.py scratch_words
// repeats it.
long long scratch_words(long long m, int cols, int n_keys) {
  const long long n_chunks = (m + kChunk - 1) / kChunk;
  const long long ranges = (n_keys + kMinRange - 1LL) / kMinRange;
  return n_chunks * (kChunk * (3LL + cols) + 2) + 2 * ranges + 1 + 2 * m;
}

struct Scratch {
  int* ukeys;
  float* usums;
  int* ucount;
  int* plo;     // per chunk: the place in its list where each pair starts
  int* pidx;    // per chunk: each pair's place among its range's pairs
  int* pcount;  // per chunk: its pairs
  int* counts;  // per range: its pairs
  int* offs;    // per range: where its pairs start; one more: the total
  int* pair_chunk;
  int* pair_lohi;  // lo | hi << 16

  Scratch(int* w, long long m, int cols, int n_keys) {
    const long long placed = (m + kChunk - 1) / kChunk * kChunk, n_chunks = placed / kChunk;
    const long long ranges = (n_keys + kMinRange - 1LL) / kMinRange;
    ukeys = w;
    usums = reinterpret_cast<float*>(ukeys + placed);
    ucount = w + placed * (1 + cols);
    plo = ucount + n_chunks;
    pidx = plo + placed;
    pcount = pidx + placed;
    counts = pcount + n_chunks;
    offs = counts + ranges;
    pair_chunk = offs + ranges + 1;
    pair_lohi = pair_chunk + m;
  }
};

// How pass 2 runs for m values into n_keys keys: key_range keys a block
// (a power of two), and whether it reads listed pairs (else it searches).
struct Plan {
  int key_range;
  bool listed;
};

Plan plan(long long m, int n_keys) {
  int key_range = kPass2Threads;
  while (key_range > kMinRange && n_keys < kRangeBlocks * key_range) key_range >>= 1;
  const long long n_chunks = (m + kChunk - 1) / kChunk;
  const long long n_ranges = (n_keys + key_range - 1LL) / key_range;
  // Pairs are counted and placed in int: at most m of them.
  return {key_range, n_chunks > 0 && n_chunks * n_ranges > kSearchesMax && m <= 0x7fffffffLL};
}

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
// ucount[chunk].  Where Listed (pass 2 lists pairs), also the start of
// each pair (a range of 2^range_shift keys met in the list) into plo at
// chunk * kChunk, their count into pcount[chunk], and one added to counts
// at each pair's range; the count it found there, the pair's place among
// its range's pairs, into pidx beside plo.
template <int C, typename P, bool Listed>
__global__ void __launch_bounds__(kSortThreads)
scatter_ordered_chunks(const int* __restrict__ keys, const float* __restrict__ values, long long m,
                       int n_keys, int range_shift, int* __restrict__ ukeys,
                       float* __restrict__ usums, int* __restrict__ ucount, int* __restrict__ plo,
                       int* __restrict__ pidx, int* __restrict__ pcount,
                       int* __restrict__ counts) {
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
  // place among the chunk's distinct keys is the count of starts before it;
  // a pair starts at a run whose range is not the previous run's, and its
  // place among the chunk's pairs is the count of pair starts before it
  // (both counted at once: run starts in the low 16 bits).
  const int j0 = 2 * t;
  const P k0 = Q::key(s_pair[j0]), k1 = Q::key(s_pair[j0 + 1]);
  const bool st0 = k0 != Q::kDrop && (j0 == 0 || Q::key(s_pair[j0 - 1]) != k0);
  const bool st1 = k1 != Q::kDrop && k1 != k0;
  const bool ps0 = st0 && (j0 == 0 || Q::key(s_pair[j0 - 1]) >> range_shift != k0 >> range_shift);
  const bool ps1 = st1 && k1 >> range_shift != k0 >> range_shift;
  const int cnt = st0 + st1 + (Listed ? (ps0 + ps1) << 16 : 0);
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
  const int first = incl - cnt + (warp > 0 ? s_warp[warp - 1] : 0);
  const int first_u = first & 0xffff, first_p = first >> 16;
  const int total = s_warp[kSortThreads / 32 - 1];
  if (t == 0) ucount[blockIdx.x] = total & 0xffff;
  if (Listed) {
    if (t == 0) pcount[blockIdx.x] = total >> 16;
    if (ps0) {
      plo[c0 + first_p] = first_u;
      pidx[c0 + first_p] = atomicAdd(counts + (k0 >> range_shift), 1);
    }
    if (ps1) {
      plo[c0 + first_p + ps0] = first_u + st0;
      pidx[c0 + first_p + ps0] = atomicAdd(counts + (k1 >> range_shift), 1);
    }
  }

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

// Zeroes the n counts pass 1 adds to.
__global__ void scatter_ordered_zero(int* __restrict__ counts, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    counts[i] = 0;
}

// One block: offs[r] = the pairs of the ranges before r (offs[n] = all).
// Each tile of counts is read and written coalesced, through shared
// memory.
__global__ void __launch_bounds__(kScanThreads)
scatter_ordered_scan(const int* __restrict__ counts, long long n, int* __restrict__ offs) {
  constexpr int kTile = kScanThreads * kScanItems;
  __shared__ int s_tile[kTile];
  __shared__ int s_warp[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (long long b = 0; b < n; b += kTile) {
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int i = q * kScanThreads + t;
      s_tile[i] = b + i < n ? counts[b + i] : 0;
    }
    __syncthreads();
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = s_tile[t * kScanItems + q];
      sum += v[q];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();  // also: every tile value is read
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    int at = carry + incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      s_tile[t * kScanItems + q] = at;
      at += v[q];
    }
    carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int i = q * kScanThreads + t;
      if (b + i < n) offs[b + i] = s_tile[i];
    }
    __syncthreads();  // s_tile and s_warp are read before the next tile
  }
  if (t == 0) offs[n] = carry;
}

// One block a chunk: each of its pairs into its range's segment, at the
// place pass 1's atomic gave it.
__global__ void __launch_bounds__(kPlaceThreads)
scatter_ordered_place(const int* __restrict__ ukeys, const int* __restrict__ ucount,
                      const int* __restrict__ plo, const int* __restrict__ pidx,
                      const int* __restrict__ pcount, int range_shift,
                      const int* __restrict__ offs, int* __restrict__ pair_chunk,
                      int* __restrict__ pair_lohi) {
  const int c = blockIdx.x;
  const long long c0 = static_cast<long long>(c) * kChunk;
  const int np = pcount[c], nu = ucount[c];
  for (int p = threadIdx.x; p < np; p += kPlaceThreads) {
    const int lo = plo[c0 + p];
    const int hi = p + 1 < np ? plo[c0 + p + 1] : nu;
    const int slot = offs[ukeys[c0 + lo] >> range_shift] + pidx[c0 + p];
    pair_chunk[slot] = c;
    pair_lohi[slot] = lo | hi << 16;
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

// Pass 2's shared memory.
struct Pass2Smem {
  float tab[kTableFloats];  // (chunk of the group, key of the range, C), or lists
  int lo[kPass2Threads], hi[kPass2Threads], ch[kPass2Threads];
  int warp[kWarps];
  int col[kPass2Threads];  // a key of the range: its column of the table
  int heavy[kWarps];  // listed pass 2: warp w's range left to the block
};

// One batch of up to kPass2Threads slots, ascending by chunk, thread t's
// slot t: entries [lo, hi) of chunk ch's list, all in the block's range
// [k0, k0 + key_range).  Thread t adds key k0 + t's entries to acc, slot by
// slot.  Every thread of the block calls it.
template <int C>
__device__ void fold_batch(int ch, int lo, int hi, int nb, int k0, int key_range,
                           const int* __restrict__ ukeys, const float* __restrict__ usums,
                           float (&acc)[C], Pass2Smem& sm) {
  const int t = threadIdx.x;
  __syncthreads();  // the last batch's bounds and table are no longer read
  sm.lo[t] = lo;
  sm.hi[t] = hi;
  sm.ch[t] = ch;
  if (!__syncthreads_or(hi > lo)) return;
  // The batch's entries of the range, slot by slot: where few, a list in
  // chunk order that each key's thread reads through, adding its own.
  int incl = hi - lo;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if ((t & 31) >= o) incl += y;
  }
  if ((t & 31) == 31) sm.warp[t >> 5] = incl;
  __syncthreads();
  int off = incl - (hi - lo), n_e = 0;
#pragma unroll
  for (int w = 0; w < kPass2Threads / 32; ++w) {
    off += w < (t >> 5) ? sm.warp[w] : 0;
    n_e += sm.warp[w];
  }
  if (n_e <= kListed) {
    int* e_key = reinterpret_cast<int*>(sm.tab);
    float* e_val = sm.tab + kListed;
    const long long base = static_cast<long long>(ch) * kChunk;
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
    return;  // the next batch's first barrier orders the list's reads
  }
  // Else a dense (slot x key) table, as many slots at a time as it holds.
  // Where a table over the whole range would not hold the batch's slots
  // (compacted), its columns are only the keys the batch holds (the walls'
  // 12 keys and a few others at config 5), sm.col mapping a key of the
  // range to its column.
  const bool compacted = key_range * C * nb > kTableFloats;
  int width = key_range;
  int col_t = t < key_range ? t : -1;  // thread t's key's column
  if (compacted) {
    if (t < key_range) sm.col[t] = 0;
    __syncthreads();
    const long long base_t = static_cast<long long>(ch) * kChunk;
#pragma unroll 4
    for (int j = lo; j < hi; ++j) sm.col[ukeys[base_t + j] - k0] = 1;
    __syncthreads();
    const int held = t < key_range ? sm.col[t] : 0;
    int at = held;  // the held keys up to t's, inclusive
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, at, o);
      if ((t & 31) >= o) at += y;
    }
    if ((t & 31) == 31) sm.warp[t >> 5] = at;
    __syncthreads();
    width = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < (t >> 5) ? sm.warp[w] : 0;
      width += sm.warp[w];
    }
    col_t = held ? at - 1 : -1;
    if (t < key_range) sm.col[t] = col_t;
    __syncthreads();
  }
  const int group = min(kPass2Threads, kTableFloats / (width * C));  // slots a table
  // Thread q writes the entries of the group's slot q (at most key_range),
  // kInFlight loads at a time, each key into its column.
  auto fill = [&](int g0, auto column) {
    float* row = sm.tab + t * width * C;
    const long long base = static_cast<long long>(sm.ch[g0 + t]) * kChunk;
    const int hi_t = sm.hi[g0 + t];
    for (int j0 = sm.lo[g0 + t]; j0 < hi_t; j0 += kInFlight) {
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
        for (int c = 0; c < C; ++c) row[column(key[f]) * C + c] = v[f][c];
      }
    }
  };
  for (int g0 = 0; g0 < nb; g0 += group) {
    const int ng = min(group, nb - g0);
    if (!__syncthreads_or(t < ng && sm.hi[g0 + t] > sm.lo[g0 + t])) continue;
    for (int i = t; i < ng * width * C; i += kPass2Threads) sm.tab[i] = 0.f;
    __syncthreads();
    if (t < ng) {
      if (compacted)
        fill(g0, [&](int k) { return sm.col[k]; });
      else
        fill(g0, [](int k) { return k; });
    }
    __syncthreads();
    if (col_t >= 0) {
#pragma unroll 8
      for (int q = 0; q < ng; ++q) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += sm.tab[(q * width + col_t) * C + c];
      }
    }
    __syncthreads();  // the table is read before the next group zeroes it
  }
}

// out[k] for the keys k of range r (key_range keys, 32 to 256), each key's
// chunk sums added from +0.0 in chunk order, by the whole block (thread t:
// key r * key_range + t).  With offs set, the range's pairs (offs[r] to
// offs[r + 1] of pair_chunk and pair_lohi) say where its entries are;
// else, or where they are more than kMaxPairs, two binary searches in each
// chunk's list.
template <int C>
__device__ void fold_range(long long r, const int* __restrict__ ukeys,
                           const float* __restrict__ usums, const int* __restrict__ ucount,
                           long long n_chunks, int n_keys, int key_range,
                           const int* __restrict__ offs, const int* __restrict__ pair_chunk,
                           const int* __restrict__ pair_lohi, float* __restrict__ out,
                           Pass2Smem& sm) {
  const int t = threadIdx.x;
  const int k0 = static_cast<int>(r * key_range);
  const int k1 = min(k0 + key_range, n_keys);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  const int p0 = offs != nullptr ? offs[r] : 0;
  const int np = offs != nullptr ? offs[r + 1] - p0 : 0;
  if (offs != nullptr && np <= kMaxPairs) {
    // Sort the pairs by chunk in shared memory (bitonic, over the next
    // power of two, padded past the last chunk); thread t keeps sorted
    // pairs t, t + 256, ... in registers for the batches.
    int* s_ch = reinterpret_cast<int*>(sm.tab);
    int* s_lh = s_ch + kMaxPairs;
    int size = 1;
    while (size < np) size <<= 1;
    for (int i = t; i < size; i += kPass2Threads) {
      s_ch[i] = i < np ? pair_chunk[p0 + i] : 0x7fffffff;
      s_lh[i] = i < np ? pair_lohi[p0 + i] : 0;
    }
    __syncthreads();
    for (int k = 2; k <= size; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < size / 2; i += kPass2Threads) {
          const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1)), b = a + j;
          if ((s_ch[a] > s_ch[b]) == ((a & k) == 0)) {
            const int c = s_ch[a], x = s_lh[a];
            s_ch[a] = s_ch[b];
            s_lh[a] = s_lh[b];
            s_ch[b] = c;
            s_lh[b] = x;
          }
        }
        __syncthreads();
      }
    }
    int ch[kPairsPerThread], lh[kPairsPerThread];
#pragma unroll
    for (int q = 0; q < kPairsPerThread; ++q) {
      const int i = t + q * kPass2Threads;
      ch[q] = i < np ? s_ch[i] : 0;
      lh[q] = i < np ? s_lh[i] : 0;  // lo = hi = 0: no entries
    }
    // fold_batch's first barrier orders these reads before tab is rewritten.
    for (int q = 0; q * kPass2Threads < np; ++q) {
      int c = 0, x = 0;
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        if (k == q) {
          c = ch[k];
          x = lh[k];
        }
      }
      fold_batch<C>(c, x & 0xffff, x >> 16, min(kPass2Threads, np - q * kPass2Threads), k0,
                    key_range, ukeys, usums, acc, sm);
    }
  } else {
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
      fold_batch<C>(static_cast<int>(ch), lo, hi,
                    static_cast<int>(min(static_cast<long long>(kPass2Threads), n_chunks - cb)),
                    k0, key_range, ukeys, usums, acc, sm);
    }
  }
  if (k0 + t < k1) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[static_cast<long long>(k0 + t) * C + c] = acc[c];
  }
}

// Pass 2, searched: one block a range.
template <int C>
__global__ void __launch_bounds__(kPass2Threads)
scatter_ordered_keys(const int* __restrict__ ukeys, const float* __restrict__ usums,
                     const int* __restrict__ ucount, long long n_chunks, int n_keys,
                     int key_range, float* __restrict__ out) {
  __shared__ Pass2Smem sm;
  fold_range<C>(blockIdx.x, ukeys, usums, ucount, n_chunks, n_keys, key_range, nullptr, nullptr,
                nullptr, out, sm);
}

// Pass 2, listed: kWarps ranges a block, one a warp.  A warp takes its range
// alone where it has at most kWarpPairs pairs holding at most kWarpListed
// entries (at config 5, all but the shell's): lane i holds pairs i and
// i + 32, ranks them by chunk with shuffles and counts the entries before
// each in chunk order; the lanes copy their pairs' entries into the warp's
// list in shared memory, in chunk order, and lane l adds the entries of
// keys l, l + 32, ... of the range as it reads through the list.  The
// block then takes the other ranges one at a time (fold_range).
template <int C>
__global__ void __launch_bounds__(kPass2Threads)
scatter_ordered_listed(const int* __restrict__ ukeys, const float* __restrict__ usums,
                       const int* __restrict__ ucount, long long n_chunks, int n_keys,
                       int key_range, long long n_ranges, const int* __restrict__ offs,
                       const int* __restrict__ pair_chunk, const int* __restrict__ pair_lohi,
                       float* __restrict__ out) {
  constexpr int kKeysPerLane = kPass2Threads / 32;
  __shared__ Pass2Smem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  bool heavy = false;
  if (r < n_ranges) {
    const int p0 = offs[r], np = offs[r + 1] - p0;
    heavy = np > kWarpPairs;
    if (!heavy) {
      int ch[2], lo[2], hi[2], before[2] = {0, 0};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = lane + 32 * q;
        const int x = i < np ? pair_lohi[p0 + i] : 0;
        ch[q] = i < np ? pair_chunk[p0 + i] : 0;
        lo[q] = x & 0xffff;
        hi[q] = x >> 16;
      }
      // The range's chunks are distinct: a pair's entries follow those of
      // the pairs in smaller chunks.
      for (int j = 0; j < np; ++j) {
        const int y = __shfl_sync(kFull, j < 32 ? ch[0] : ch[1], j & 31);
        const int n = __shfl_sync(kFull, j < 32 ? hi[0] - lo[0] : hi[1] - lo[1], j & 31);
#pragma unroll
        for (int q = 0; q < 2; ++q) before[q] += y < ch[q] ? n : 0;
      }
      int n_e = hi[0] - lo[0] + hi[1] - lo[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) n_e += __shfl_xor_sync(kFull, n_e, o);
      heavy = n_e > kWarpListed;
      if (!heavy) {
        const int k0 = static_cast<int>(r * key_range);
        int* e_key = reinterpret_cast<int*>(sm.tab) + warp * kWarpWords;
        float* e_val = sm.tab + warp * kWarpWords + kWarpListed;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const long long base = static_cast<long long>(ch[q]) * kChunk;
          for (int j0 = lo[q]; j0 < hi[q]; j0 += kInFlight) {
            int key[kInFlight];
            float v[kInFlight][C];
#pragma unroll
            for (int f = 0; f < kInFlight; ++f) {
              const bool in = j0 + f < hi[q];
              key[f] = in ? ukeys[base + j0 + f] - k0 : -1;
#pragma unroll
              for (int c = 0; c < C; ++c) v[f][c] = in ? usums[(base + j0 + f) * C + c] : 0.f;
            }
#pragma unroll
            for (int f = 0; f < kInFlight; ++f) {
              if (key[f] < 0) continue;
              const int e = before[q] + j0 - lo[q] + f;
              e_key[e] = key[f];
#pragma unroll
              for (int c = 0; c < C; ++c) e_val[e * C + c] = v[f][c];
            }
          }
        }
        __syncwarp();
        float acc[kKeysPerLane][C];
#pragma unroll
        for (int k = 0; k < kKeysPerLane; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[k][c] = 0.f;
        for (int e = 0; e < n_e; ++e) {
          const int key = e_key[e];
          if ((key & 31) != lane) continue;
#pragma unroll
          for (int k = 0; k < kKeysPerLane; ++k) {
            if (k == key >> 5) {
#pragma unroll
              for (int c = 0; c < C; ++c) acc[k][c] += e_val[e * C + c];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kKeysPerLane; ++k) {
          const int key = k0 + 32 * k + lane;
          if (32 * k < key_range && key < n_keys) {
#pragma unroll
            for (int c = 0; c < C; ++c) out[static_cast<long long>(key) * C + c] = acc[k][c];
          }
        }
      }
    }
  }
  if (lane == 0) sm.heavy[warp] = heavy;
  __syncthreads();  // also: every warp's list is read
  for (int w = 0; w < kWarps; ++w) {
    if (!sm.heavy[w]) continue;
    __syncthreads();  // shared memory is no longer read for an earlier range
    fold_range<C>(static_cast<long long>(blockIdx.x) * kWarps + w, ukeys, usums, ucount,
                  n_chunks, n_keys, key_range, offs, pair_chunk, pair_lohi, out, sm);
  }
}

template <int C, typename P>
void launch_pairs(const int* keys, const float* values, long long m, int n_keys,
                  const Scratch& w, float* out, cudaStream_t s) {
  const long long n_chunks = (m + kChunk - 1) / kChunk;
  const Plan pl = plan(m, n_keys);
  const int shift = __builtin_ctz(pl.key_range);
  const long long n_ranges = (n_keys + pl.key_range - 1LL) / pl.key_range;
  if (pl.listed) {
    const long long blocks = (n_ranges + 255) / 256;
    scatter_ordered_zero<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), 256, 0, s>>>(
        w.counts, n_ranges);
  }
  if (pl.listed)
    scatter_ordered_chunks<C, P, true><<<static_cast<unsigned>(n_chunks), kSortThreads, 0, s>>>(
        keys, values, m, n_keys, shift, w.ukeys, w.usums, w.ucount, w.plo, w.pidx, w.pcount,
        w.counts);
  else if (n_chunks > 0)
    scatter_ordered_chunks<C, P, false><<<static_cast<unsigned>(n_chunks), kSortThreads, 0, s>>>(
        keys, values, m, n_keys, shift, w.ukeys, w.usums, w.ucount, w.plo, w.pidx, w.pcount,
        w.counts);
  if (pl.listed) {
    scatter_ordered_scan<<<1, kScanThreads, 0, s>>>(w.counts, n_ranges, w.offs);
    scatter_ordered_place<<<static_cast<unsigned>(n_chunks), kPlaceThreads, 0, s>>>(
        w.ukeys, w.ucount, w.plo, w.pidx, w.pcount, shift, w.offs, w.pair_chunk, w.pair_lohi);
  }
  if (pl.listed)
    scatter_ordered_listed<C><<<static_cast<unsigned>((n_ranges + kWarps - 1) / kWarps),
                                kPass2Threads, 0, s>>>(w.ukeys, w.usums, w.ucount, n_chunks,
                                                       n_keys, pl.key_range, n_ranges, w.offs,
                                                       w.pair_chunk, w.pair_lohi, out);
  else if (n_keys > 0)
    scatter_ordered_keys<C><<<static_cast<unsigned>(n_ranges), kPass2Threads, 0, s>>>(
        w.ukeys, w.usums, w.ucount, n_chunks, n_keys, pl.key_range, out);
}

template <int C>
void launch(const int* keys, const float* values, long long m, int n_keys, int* scratch,
            float* out, cudaStream_t s) {
  const Scratch w(scratch, m, C, n_keys);
  if (n_keys <= Pairs<unsigned>::kDrop)
    launch_pairs<C, unsigned>(keys, values, m, n_keys, w, out, s);
  else
    launch_pairs<C, unsigned long long>(keys, values, m, n_keys, w, out, s);
}

}  // namespace

// keys (m,) i32; values (m, cols) f32, cols 1 or 3; out (n_keys, cols) f32,
// every element written.  chunk: the caller's chunk size, which must be
// kChunk.  scratch: scratch_words int32 words, at least scratch_words(m,
// cols, n_keys) above; nothing in it need be set.  Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a chunk other
// than kChunk or too small a scratch.
extern "C" int hare_scatter_add_ordered(const int* keys, const float* values, long long m,
                                        int cols, int n_keys, int chunk, int* scratch,
                                        long long scratch_words_given, float* out, void* stream) {
  if ((cols != 1 && cols != 3) || m < 0 || n_keys < 0 || chunk != kChunk ||
      scratch_words_given < scratch_words(m, cols, n_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols == 1)
    launch<1>(keys, values, m, n_keys, scratch, out, s);
  else
    launch<3>(keys, values, m, n_keys, scratch, out, s);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a call of m values into n_keys keys, on the host: into
// out[0] the keys a pass-2 block takes, into out[1] 1 where pass 2 reads
// listed pairs, 0 where it searches.  Launches nothing; `stream` unused.
extern "C" int hare_scatter_plan(long long m, int n_keys, int* out, void* stream) {
  (void)stream;
  if (m < 0 || n_keys < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(m, n_keys);
  out[0] = pl.key_range;
  out[1] = pl.listed;
  return 0;
}
