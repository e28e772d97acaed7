// P1-P4: the Pallas feasibility probes of benchmarks/, as H100 kernels.
//
// P1 column_sum replaces benchmarks/pallas_probe.py probe_vmem (kernel :25,
// pallas_call :29): o[0, j] = sum_r x[r, j] over a float32 table that the
// TPU kernel held whole in VMEM.  Hopper has no 100 MB scratch (227 KB of
// shared memory per block, then the 50 MB L2), so the kernel streams the
// table from global memory.  One add per 4 bytes read: what bounds it is
// bytes per second, from L2 while the table fits and from HBM past it.
// Design: pass 1 runs `bands` blocks; each walks a strided band of rows with
// 16-byte loads, neighbouring threads on neighbouring columns (a 192-column
// row is 48 float4 lanes), keeps float4 partials in registers, folds its row
// slots in shared memory and writes one row of column partials.  Pass 2 adds
// the bands, one warp per column, in a fixed order, so repeated calls give
// the same bits (atomics would not).
//
// P2-P4 gather_sum replaces pallas_probe.py probe_gather (:50 / :58) and
// probe_meta_gather (:88 / :96), and benchmarks/r4_dyngather_probe.py probe
// (:42 / :57):
//     o[r] = sum_{i < iters} sum_j tab[(idx[r] + i) mod n, j]
// (jnp.take(mode="wrap"); take_along_axis with idx broadcast over the row is
// the same row gather).  The JAX kernels sum each gathered row first, then
// add the row sums in i order, so the function is a windowed sum over the
// table's row sums.  What bounds it is bytes: the table read once (18 MB for
// P2, 50 MB for P4's window rows).  Gathering whole rows per output, as the
// first port did, re-reads each row once for every window that reaches it
// (P4's window rows about 8 times).  So a call is two launches on one
// stream, no atomics:
// - pass 1 streams the table as a flat array and writes every row's sum,
//   s[k] = sum_j tab[k, j], into scratch the wrapper allocates each call:
//   16-byte loads, neighbouring threads on neighbouring words.  Rows of 4k
//   elements (k > 4) are summed by a group of lanes, each adding its words
//   in order, then a fixed shuffle tree; rows of at most 4 words by the
//   thread that loads them; rows of 2 elements two to a word; other
//   widths element by element, a thread a row.
// - pass 2 adds each output's iters row sums: a group of g lanes an output
//   (enough groups for half the card), lane l adding i = l, l + g, ... in
//   order, then a fixed shuffle tree.  Neighbouring lanes read neighbouring
//   words of the window.
// Every row sum and every window has one order, so repeated calls give the
// same bits.  Indices wrap with %, since iters may exceed n.  int32 sums
// accumulate in uint32 and cast back: JAX's int32 add wraps, and signed
// overflow in C++ is undefined.  iters == 0 launches pass 2 alone, which
// writes zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColumnThreads = 512;  // pass-1 block: cols/4 lanes x row slots

__global__ void __launch_bounds__(kColumnThreads)
column_sum_bands(const float4* __restrict__ x, long long rows, int lanes,
                 float4* __restrict__ partial) {
  extern __shared__ float4 fold[];  // [row slots][lanes]
  const int lane = threadIdx.x, slot = threadIdx.y, slots = blockDim.y;
  const long long step = static_cast<long long>(gridDim.x) * slots;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (long long r = static_cast<long long>(blockIdx.x) * slots + slot; r < rows; r += step) {
    const float4 v = __ldg(x + r * lanes + lane);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  fold[slot * lanes + lane] = acc;
  __syncthreads();
  if (slot == 0) {
    for (int s = 1; s < slots; ++s) {
      const float4 v = fold[s * lanes + lane];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    partial[static_cast<long long>(blockIdx.x) * lanes + lane] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
column_sum_fold(const float* __restrict__ partial, int bands, int cols,
                float* __restrict__ out) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (col >= cols) return;  // warp-uniform: one warp per column
  float s = 0.f;
  for (int b = lane; b < bands; b += 32) s += partial[static_cast<long long>(b) * cols + col];
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[col] = s;
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// The accumulator of an output type: int32 sums wrap, so they run in uint32.
template <typename Out> struct Accum { using type = Out; };
template <> struct Accum<int> { using type = unsigned; };

template <typename A, typename T>
__device__ __forceinline__ A term(T v) { return static_cast<A>(v); }

// One 16-byte word's four elements added in order.
template <typename A, typename V>
__device__ __forceinline__ A word_sum(V x) {
  return term<A>(x.x) + term<A>(x.y) + term<A>(x.z) + term<A>(x.w);
}

// The g lanes of a group (g a power of two, at most 32) fold their partials:
// a butterfly, so every lane ends with the same bits.  Every lane of the
// warp must reach it.
template <typename A>
__device__ __forceinline__ A fold_group(A acc, int g) {
  for (int off = g / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// k mod n in [0, n), as jnp.take(mode="wrap") and Python's % give it.
__device__ __forceinline__ unsigned wrap_start(int k, unsigned n) {
  const long long m = static_cast<long long>(k) % n;
  return static_cast<unsigned>(m < 0 ? m + n : m);
}

// Pass 1, rows of nv 16-byte words: a group of g lanes a row, lane l adding
// words l, l + g, ... from 0 in order.  Groups past the last row sum row 0
// and write nothing, so every lane reaches the fold.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
gather_sum_rows_vec(const typename Vec4<T>::type* __restrict__ tab, long long n, int nv, int g,
                    A* __restrict__ sums) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = t / g;
  const int lane = static_cast<int>(t % g);
  const auto* words = tab + (row < n ? row : 0) * nv;
  A acc = 0;
#pragma unroll 4
  for (int v = lane; v < nv; v += g) acc += word_sum<A>(__ldg(words + v));
  acc = fold_group(acc, g);
  if (row < n && lane == 0) sums[row] = acc;
}

// Pass 1, rows of 2 elements: a thread loads one 16-byte word, two rows,
// and adds each from its first element; a table ending inside a word ends
// with one row, element by element in the same order.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
gather_sum_rows_pair(const T* __restrict__ tab, long long n, A* __restrict__ sums) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r0 = 2 * t;
  if (r0 >= n) return;
  if (r0 + 2 <= n) {
    const auto x = __ldg(reinterpret_cast<const typename Vec4<T>::type*>(tab) + t);
    sums[r0] = A(0) + term<A>(x.x) + term<A>(x.y);
    sums[r0 + 1] = A(0) + term<A>(x.z) + term<A>(x.w);
    return;
  }
  sums[r0] = A(0) + term<A>(__ldg(tab + 2 * r0)) + term<A>(__ldg(tab + 2 * r0 + 1));
}

// Pass 1, any other width: a thread a row, its elements added from 0 in order.
template <typename T, typename A>
__global__ void __launch_bounds__(kThreads)
gather_sum_rows_scalar(const T* __restrict__ tab, long long n, int width, A* __restrict__ sums) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* row = tab + r * width;
  A acc = 0;
  for (int j = 0; j < width; ++j) acc += term<A>(__ldg(row + j));
  sums[r] = acc;
}

// Pass 2: o[r] = sum_{i < iters} s[(w0 + i) mod n], w0 = idx[r] mod n; a
// group of g lanes an output, lane l adding i = l, l + g, ... from 0 in
// order, then the fold.  Groups past the last output sum output 0's window
// and write nothing, so every lane reaches the fold.
template <typename A, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_sum_windows(const A* __restrict__ sums, unsigned n, const int* __restrict__ idx,
                   int n_out, int iters, int g, Out* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = t / g;
  const int lane = static_cast<int>(t % g);
  // w0 < n < 2^31 and lane < 32: the sum does not overflow 32 bits, and
  // k + step < 2n after each step.
  unsigned k = (wrap_start(__ldg(idx + (r < n_out ? r : 0)), n) + lane) % n;
  const unsigned step = static_cast<unsigned>(g) % n;
  A acc = 0;
#pragma unroll 4
  for (int i = lane; i < iters; i += g) {
    acc += __ldg(sums + k);
    k += step;
    if (k >= n) k -= n;
  }
  acc = fold_group(acc, g);
  if (r < n_out && lane == 0) out[r] = static_cast<Out>(acc);
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// Pass 1 for a table of `width` elements a row, by the width's path.
template <typename T, typename A>
void row_sums(const T* tab, long long n, int width, A* sums, cudaStream_t s) {
  using V = typename Vec4<T>::type;
  if (width % 4 == 0) {
    const int nv = width / 4;
    // The largest power of two dividing nv, at most 32: each lane loads as
    // many words as the next; rows of at most 4 words, one thread.
    const int g = nv <= 4 ? 1 : (nv & -nv) < 32 ? (nv & -nv) : 32;
    gather_sum_rows_vec<T, A><<<blocks_for(n * g), kThreads, 0, s>>>(
        reinterpret_cast<const V*>(tab), n, nv, g, sums);
  } else if (width == 2) {
    gather_sum_rows_pair<T, A><<<blocks_for((n + 1) / 2), kThreads, 0, s>>>(tab, n, sums);
  } else {
    gather_sum_rows_scalar<T, A><<<blocks_for(n), kThreads, 0, s>>>(tab, n, width, sums);
  }
}

// Pass 2's lanes an output: a power of two, at most 32 and at most iters,
// doubled while a lane would add more than 8 row sums or the groups would
// not fill half an H100 (66 SMs' worth of 2048 threads).  More lanes, each
// adding fewer row sums, read slower where the outputs alone fill the card.
int window_lanes(int n_out, int iters) {
  int g = 1;
  while (g < 32 && g < iters &&
         (8LL * g < iters || static_cast<long long>(n_out) * g < 66LL * 2048))
    g <<= 1;
  return g;
}

// tab (n, width) row-major and 16-byte aligned, 0 < n < 2^31; idx (n_out,);
// sums n accumulators of scratch.  Launches both passes on `stream`.
template <typename T, typename Out>
int gather_sum(const T* tab, long long n, int width, const int* idx, int n_out, int iters,
               typename Accum<Out>::type* sums, Out* out, void* stream) {
  using A = typename Accum<Out>::type;
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (iters > 0) {
    row_sums<T, A>(tab, n, width, sums, s);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int g = window_lanes(n_out, iters);
  gather_sum_windows<A, Out><<<blocks_for(static_cast<long long>(n_out) * g), kThreads, 0, s>>>(
      sums, static_cast<unsigned>(n), idx, n_out, iters, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, cols) float32, row-major and 16-byte aligned, cols a multiple of 4
// and at most 4 * kColumnThreads; partial holds bands * cols floats of
// scratch; out (cols,).  Launches both passes on `stream`.
extern "C" int hare_column_sum(const float* x, long long rows, int cols, int bands,
                               float* partial, float* out, void* stream) {
  const int lanes = cols / 4;
  if (cols <= 0 || cols % 4 != 0 || lanes > kColumnThreads || bands <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(lanes, kColumnThreads / lanes);
  column_sum_bands<<<bands, block, sizeof(float4) * block.x * block.y, s>>>(
      reinterpret_cast<const float4*>(x), rows, lanes, reinterpret_cast<float4*>(partial));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  column_sum_fold<<<(cols * 32 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, bands, cols, out);
  return static_cast<int>(cudaGetLastError());
}

// P2 and P4's float tables; sums holds n floats of scratch.
extern "C" int hare_gather_sum_f32(const float* tab, long long n, int width, const int* idx,
                                   int n_out, int iters, float* sums, float* out, void* stream) {
  return gather_sum<float, float>(tab, n, width, idx, n_out, iters, sums, out, stream);
}

// P3: int32 cell_meta rows, int32 sums that wrap; sums holds n uint32.
extern "C" int hare_gather_sum_i32(const int* tab, long long n, int width, const int* idx,
                                   int n_out, int iters, unsigned* sums, int* out, void* stream) {
  return gather_sum<int, int>(tab, n, width, idx, n_out, iters, sums, out, stream);
}

// P4's cell_meta call: int32 rows summed in float32; sums holds n floats.
extern "C" int hare_gather_sum_i32_f32(const int* tab, long long n, int width, const int* idx,
                                       int n_out, int iters, float* sums, float* out,
                                       void* stream) {
  return gather_sum<int, float>(tab, n, width, idx, n_out, iters, sums, out, stream);
}
