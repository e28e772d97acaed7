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
// the same row gather).  No arithmetic to speak of: what bounds it is bytes
// per gathered row, read from L2 while the table fits (P2 18 MB, P3 0.9 MB)
// and from HBM when it does not (P4's 50 MB window rows), and how many row
// reads are in flight.  The iterations are independent gathers, so the loop
// over i is unrolled to keep several rows in flight per thread.  Wide rows
// (>= 32 elements, a multiple of 4) get one warp per output row: each row is
// read with coalesced 16-byte loads, each lane keeps its partial across all
// i, and one __shfl_xor_sync tree ends the row.  Narrow rows (P3's 2 int32,
// P4's 2 and 8) get one thread per output row, which reads the row's one or
// two 32-byte sectors itself and adds the row before adding it to the sum,
// as the JAX kernels do.  Indices wrap with %, since iters may exceed n.
// int32 sums accumulate in uint32 and cast back: JAX's int32 add wraps, and
// signed overflow in C++ is undefined.
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

// k mod n in [0, n), as jnp.take(mode="wrap") and Python's % give it.
__device__ __forceinline__ unsigned wrap_start(int k, unsigned n) {
  const long long m = static_cast<long long>(k) % n;
  return static_cast<unsigned>(m < 0 ? m + n : m);
}

template <typename T, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_rows_warp(const T* __restrict__ tab, unsigned n, int width,
                 const int* __restrict__ idx, int n_out, int iters,
                 Out* __restrict__ out) {
  using A = typename Accum<Out>::type;
  using V = typename Vec4<T>::type;
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= n_out) return;  // warp-uniform: the shuffles below see whole warps
  const int nv = width / 4;
  const V* vt = reinterpret_cast<const V*>(tab);
  const unsigned w0 = wrap_start(idx[r], n);
  A acc = 0;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
    // w0 < n < 2^31 and i < 2^31: the sum does not overflow 32 bits.
    const V* row = vt + static_cast<size_t>((w0 + static_cast<unsigned>(i)) % n) * nv;
    for (int v = lane; v < nv; v += 32) {
      const V x = __ldg(row + v);
      acc += term<A>(x.x) + term<A>(x.y) + term<A>(x.z) + term<A>(x.w);
    }
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[r] = static_cast<Out>(acc);
}

template <typename T, typename Out>
__global__ void __launch_bounds__(kThreads)
gather_rows_thread(const T* __restrict__ tab, unsigned n, int width,
                   const int* __restrict__ idx, int n_out, int iters,
                   Out* __restrict__ out) {
  using A = typename Accum<Out>::type;
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_out) return;
  const unsigned w0 = wrap_start(idx[r], n);
  A acc = 0;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
    const T* row = tab + static_cast<size_t>((w0 + static_cast<unsigned>(i)) % n) * width;
    A s = 0;
    for (int j = 0; j < width; ++j) s += term<A>(__ldg(row + j));
    acc += s;
  }
  out[r] = static_cast<Out>(acc);
}

// tab (n, width) row-major and 16-byte aligned, 0 < n < 2^31; idx (n_out,).
template <typename T, typename Out>
int gather_sum(const T* tab, long long n, int width, const int* idx, int n_out,
               int iters, Out* out, void* stream) {
  if (n_out > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned un = static_cast<unsigned>(n);
    if (width >= 32 && width % 4 == 0) {
      const long long blocks = (static_cast<long long>(n_out) * 32 + kThreads - 1) / kThreads;
      gather_rows_warp<T, Out><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          tab, un, width, idx, n_out, iters, out);
    } else {
      const long long blocks = (static_cast<long long>(n_out) + kThreads - 1) / kThreads;
      gather_rows_thread<T, Out><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          tab, un, width, idx, n_out, iters, out);
    }
  }
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

// P2 and P4's float tables.
extern "C" int hare_gather_sum_f32(const float* tab, long long n, int width, const int* idx,
                                   int n_out, int iters, float* out, void* stream) {
  return gather_sum<float, float>(tab, n, width, idx, n_out, iters, out, stream);
}

// P3: int32 cell_meta rows, int32 sums that wrap.
extern "C" int hare_gather_sum_i32(const int* tab, long long n, int width, const int* idx,
                                   int n_out, int iters, int* out, void* stream) {
  return gather_sum<int, int>(tab, n, width, idx, n_out, iters, out, stream);
}

// P4's cell_meta call: int32 rows summed in float32.
extern "C" int hare_gather_sum_i32_f32(const int* tab, long long n, int width, const int* idx,
                                       int n_out, int iters, float* out, void* stream) {
  return gather_sum<int, float>(tab, n, width, idx, n_out, iters, out, stream);
}
