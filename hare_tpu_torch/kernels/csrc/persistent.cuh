// The persistent launch shared by the traversal kernels K1 grid_shoot, B2
// tree_shoot and B3 ropes_shoot: one ray per group of G lanes, as many
// blocks as the card holds at once, each group taking its next ray from a
// counter on the device, so no SM idles behind a slow wave.
//
// The counter is two unsigned ints: counter[0] is the next ray to take,
// counter[1] the groups that have finished.  Both are 0 at launch, and the
// last group to finish sets them back to 0 for the next launch.  Launches
// on one stream run in turn, so one pair per device and stream serves all
// three kernels (hare_tpu_torch/accel/common.py ray_counter).
#pragma once

#include <algorithm>
#include <cstddef>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace hare {

// The lanes of this thread's group: G lanes, groups aligned within the warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G == 8 || G == 16 || G == 32, "G is 8, 16 or 32");
  const int lane = threadIdx.x % G;
  return (G == 32 ? 0xFFFFFFFFu : (1u << (G % 32)) - 1u) << ((threadIdx.x % 32) - lane);
}

// The group's next ray, the same on every lane; n or more once none is left.
template <int G>
__device__ __forceinline__ int take_ray(unsigned* counter, int lane, unsigned mask) {
  unsigned next = 0;
  if (lane == 0) next = atomicAdd(&counter[0], 1u);
  return static_cast<int>(__shfl_sync(mask, next, 0, G));
}

// Count the group done, after its last take_ray.  A group's last take from
// counter[0] has returned before it counts itself done, so the last group
// done is the last to touch either, and it resets both.
template <int G>
__device__ __forceinline__ void group_done(unsigned* counter, int lane) {
  const unsigned groups = gridDim.x * (blockDim.x / G);
  __threadfence();
  if (lane == 0 && atomicAdd(&counter[1], 1u) == groups - 1) {
    atomicExch(&counter[0], 0u);
    atomicExch(&counter[1], 0u);
  }
}

// Blocks of a persistent launch of `kernel` with `block` threads and `smem`
// bytes of dynamic shared memory: as many as the card holds at once, found
// once per kernel, device and size.
template <typename Kernel>
int resident_blocks(Kernel kernel, int block, size_t smem) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaGetDevice(&dev);
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.fn == fn && e.dev == dev && e.smem == smem) return e.blocks;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  const int blocks = std::max(sms * per_sm, 1);
  cache.push_back({fn, dev, smem, blocks});
  return blocks;
}

// Blocks for n rays: the resident blocks, or fewer where n rays need fewer.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int n, int group, int block, size_t smem) {
  const long long ray_blocks = (static_cast<long long>(n) * group + block - 1) / block;
  return static_cast<int>(std::min<long long>(ray_blocks, resident_blocks(kernel, block, smem)));
}

}  // namespace hare
