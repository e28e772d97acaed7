// K3 energy_histogram (hard binning, forward): hist[bin(time)] += energy.
//
// Replaces the XLA scatter of hare_tpu/trace/bounce.py energy_histogram
// (:294-300, jax.ops.segment_sum over clip(int(time / bin_dt))) with dead
// lanes dropped.  The backward (grad_energy = where(hit, grad_hist[bin], 0))
// is plain indexing in the torch wrapper, as XLA's transpose was.
//
// What bounds it on the H100: atomics on a few hot bins.  Arrival times of
// one bounce cluster in a few dozen 1 ms bins, so global atomicAdd would
// serialise on those addresses.  The design privatises the whole histogram
// in shared memory per block (1024 bins = 4 KB), adds there, then folds each
// non-zero private bin into the output with one global atomic.  Histograms
// too large for the 48 KB static shared-memory window use global atomics.
// Float atomics make the summation order, and so the last bits of each bin,
// vary from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBins = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const float* __restrict__ energy, const float* __restrict__ time,
                 const bool* __restrict__ hit, long long n, int n_bins, float bin_dt,
                 bool shared_bins, float* __restrict__ hist) {
  extern __shared__ float priv[];
  if (shared_bins) {
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x) priv[b] = 0.f;
    __syncthreads();
  }
  float* dst = shared_bins ? priv : hist;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += stride) {
    if (!hit[i]) continue;
    // clip(int(time / bin_dt), 0, n_bins - 1): clamping before the
    // truncating conversion gives the same bin and keeps it in range.
    const float q = fminf(fmaxf(time[i] / bin_dt, 0.f), static_cast<float>(n_bins - 1));
    atomicAdd(&dst[static_cast<int>(q)], energy[i]);
  }
  if (shared_bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < n_bins; b += blockDim.x)
      if (priv[b] != 0.f) atomicAdd(&hist[b], priv[b]);
  }
}

}  // namespace

// hist must hold n_bins zeros.  Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_energy_histogram(const float* energy, const float* time,
                                     const bool* hit, long long n, int n_bins,
                                     float bin_dt, float* hist, void* stream) {
  if (n > 0 && n_bins > 0) {
    const bool shared_bins = n_bins <= kMaxSharedBins;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 264 ? want : 264);  // 2 per SM
    const size_t smem = shared_bins ? sizeof(float) * n_bins : 0;
    histogram_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        energy, time, hit, n, n_bins, bin_dt, shared_bins, hist);
  }
  return static_cast<int>(cudaGetLastError());
}
