// B2 tree_shoot: nearest hit through an octree or KD-tree, one ray per group
// of G lanes.
//
// Replaces hare_tpu/accel/tree.py shoot_tree (:249-562), a lockstep
// collect-then-test stack machine: an 8-bit-quantised packed (N, S) stack,
// SoA or one-hot selects, a P-slot push with a lax.cond overflow arm,
// candidate buffers, buffer tiers and straggler rounds.  None of that is
// needed when each ray walks on its own: a stack of exact f32 (node, tmin)
// entries and a pop / prune / slab-test K children / test leaf windows /
// push loop.  Each hit leaf child's window run is tested at once
// (windows.cuh, the test K1 and B3 share) and updates the best hit live, so
// later children and pops prune against it.  Hit inner children are pushed
// far-to-near, so the nearest pops first (the reference's
// ComputeTraversalOrder, Octree - alt.cs:286-306).  Children are kept while
// tmin <= best_t, inclusive, or an equal-t hit with a lower triangle id in a
// later leaf would be lost.
//
// What bounds it on the H100: dependent loads, as in K1.  A pop reads one
// node row (K child boxes of 2 float4 and K infos of 1 int4), then the
// window rows of the hit leaf children; the arithmetic (K slab tests a pop,
// a triangle test a slot) is under 1 us a bench shoot
// (hare_tpu_torch/benchmarks/bounds.py).  The first design, one thread per
// ray, filled the card to an eighth, a warp waited for the slowest of its
// 32 walks, each window slot was two dependent, uncoalesced loads tested by
// one thread, and each thread kept a 128-entry stack in local memory.
//
// The design, as K1's.  The G lanes of a group walk one ray: every lane
// holds the same stack pointer, best hit and node, so control stays
// uniform.  At a pop, lane k < K loads child k's box and info: a node's K
// children are contiguous rows, so the group's loads coalesce, and the
// lanes slab-test their children at once.  A ballot gives the hit leaf
// children; each one's run goes, in slot order, to hare::test_run_group
// (all G lanes share its slots and reduce the hit key, so every lane comes
// back with the same best hit).  A second ballot gives the inner children
// to push; lane k's place in the push order is the count of pushed
// children farther than its own (equal tmin: the higher slot counts as
// farther), the plain version's `pos`.  The stack holds the tree's own
// bound S entries, in dynamic shared memory, one S x (int, float) slice per
// group, sized at launch.  The launch is persistent (persistent.cuh).
// G = 8, 128 threads a block, the stack in shared memory and the
// persistent launch were chosen by measurement among G = 16, 256 threads,
// the stack in the group's registers (entry e on lane e % G; 22-26% slower,
// its pushes cost K + 2 shuffles) and one group per ray
// (hare_tpu_torch/benchmarks/kernel_sweep.py, PERF.md §6).  The result is
// bit-equal to the plain version's, pops included.
//
// The stack bound is the JAX one, S = (K-1)*(max_depth+2)+4 (tree.py:268); a
// ray that would push past it sets the error flag (the wrapper raises) and
// stops — no entry is dropped silently.  The slab test divides by
// where(d == 0, 1e-30, d) (tree.py:283) and propagates NaN as jnp.minimum
// does.
#include <limits>

#include "persistent.cuh"
#include "windows.cuh"

namespace {

constexpr int kGroup = 8;       // lanes per ray
constexpr int kBlock = 128;     // threads per block
constexpr int kMaxStack = 128;  // tree.KERNEL_MAX_STACK: the largest S a launch takes
static_assert(kBlock % 32 == 0, "whole warps per block");

constexpr float kInf = std::numeric_limits<float>::infinity();

struct TreeP {
  int win;          // triangles per window row
  int pseudo_root;  // row whose only child is the root
  int stack;        // per-ray stack bound S
  float min_t;
  int top_index;    // -1 = no topology filter
};

// Ray i, on every lane of its group (lane `lane`, the group's lanes `mask`).
// st_node / st_t: the group's S stack entries in shared memory.
template <int K, bool MT>
__device__ __forceinline__ void shoot_ray(int i, int lane, unsigned mask,
                                          const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const int* __restrict__ ex,
                                          const float4* __restrict__ child_box,
                                          const int4* __restrict__ child_info,
                                          const float4* __restrict__ win_geom,
                                          const int4* __restrict__ win_ids, const TreeP& p,
                                          int* st_node, float* st_t,
                                          float* __restrict__ best_t_out,
                                          int* __restrict__ best_tri_out,
                                          int* __restrict__ pops_out, int* __restrict__ err) {
  static_assert(K <= kGroup, "a lane for each child");
  const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float inv_d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) inv_d[c] = 1.f / (dc[c] == 0.f ? 1e-30f : dc[c]);
  const hare::RayC ray = hare::ray_setup(oc[0], oc[1], oc[2], dc[0], dc[1], dc[2]);
  const hare::RunFilter filter{ex[2 * i], ex[2 * i + 1], p.top_index, p.min_t};
  const int base = (threadIdx.x % 32) - lane;  // the group's first lane in the warp

  if (lane == 0) {
    st_node[0] = p.pseudo_root;
    st_t[0] = 0.f;
  }
  __syncwarp(mask);
  int sp = 1, pops = 0;
  float best_t = kInf;
  int best_tri = -1;

  while (sp > 0) {
    --sp;
    ++pops;
    const int node = st_node[sp];
    const float t_node = st_t[sp];
    __syncwarp(mask);  // every lane has read the entry before a push overwrites it
    if (!(t_node <= best_t)) continue;  // entered beyond the best hit

    // ---- lane k < K slab-tests child k (one coalesced row for the group).
    float tmin = kInf;
    bool slab = false;
    int4 info = make_int4(-1, 0, 0, 0);  // (id, ws, nw, -)
    if (lane < K) {
      const float4 lo = __ldg(&child_box[2 * (node * K + lane)]);
      const float4 hi = __ldg(&child_box[2 * (node * K + lane) + 1]);
      info = __ldg(&child_info[node * K + lane]);
      const float lo_c[3] = {lo.x, lo.y, lo.z}, hi_c[3] = {hi.x, hi.y, hi.z};
      float t_lo = -kInf, t_hi = kInf;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t1 = (lo_c[c] - oc[c]) * inv_d[c];
        const float t2 = (hi_c[c] - oc[c]) * inv_d[c];
        t_lo = hare::nan_max(t_lo, hare::nan_min(t1, t2));
        t_hi = hare::nan_min(t_hi, hare::nan_max(t1, t2));
      }
      tmin = hare::nan_max(t_lo, 0.f);
      slab = t_hi >= tmin && t_hi >= 0.f;
    }

    // ---- the hit leaf children's runs, in slot order, by the whole group.
    unsigned leaves = (__ballot_sync(mask, slab && info.z > 0) >> base) & ((1u << K) - 1u);
    while (leaves) {
      const int k = __ffs(leaves) - 1;
      leaves &= leaves - 1u;
      const float t_k = __shfl_sync(mask, tmin, k, kGroup);
      const int ws = __shfl_sync(mask, info.y, k, kGroup);
      const int nw = __shfl_sync(mask, info.z, k, kGroup);
      if (t_k <= best_t)
        hare::test_run_group<MT, kGroup>(ray, win_geom, win_ids, ws, nw, p.win, filter, lane,
                                         mask, best_t, best_tri);
    }

    // ---- push the hit inner children far-to-near (ties: higher slot first).
    const bool push = slab && info.x >= 0 && tmin <= best_t;
    const unsigned pushed = (__ballot_sync(mask, push) >> base) & ((1u << K) - 1u);
    const int n_push = __popc(pushed);
    if (sp + n_push > p.stack) {
      if (lane == 0) atomicExch(err, 1);
      break;
    }
    int pos = 0;  // pushed children farther than this lane's
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float t_j = __shfl_sync(mask, tmin, j, kGroup);
      pos += ((pushed >> j) & 1u) && (t_j > tmin || (t_j == tmin && j > lane));
    }
    if (push) {
      st_node[sp + pos] = info.x;
      st_t[sp + pos] = tmin;
    }
    sp += n_push;
    __syncwarp(mask);  // the pushes land before the next pop reads them
  }
  if (lane == 0) {
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
    if (pops_out) pops_out[i] = pops;
  }
}

// The persistent launch (persistent.cuh); dynamic shared memory holds the
// block's stacks, S ints then S floats for each group.
template <int K, bool MT>
__global__ void __launch_bounds__(kBlock)
tree_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ ex, int n,
                  const float4* __restrict__ child_box,
                  const int4* __restrict__ child_info,
                  const float4* __restrict__ win_geom,
                  const int4* __restrict__ win_ids, const TreeP p,
                  float* __restrict__ best_t_out, int* __restrict__ best_tri_out,
                  int* __restrict__ pops_out, int* __restrict__ err,
                  unsigned* __restrict__ counter) {
  extern __shared__ int stacks[];
  const int lane = threadIdx.x % kGroup;
  const unsigned mask = hare::group_mask<kGroup>();
  const int group = threadIdx.x / kGroup;
  int* st_node = stacks + group * p.stack;
  float* st_t = reinterpret_cast<float*>(stacks + (kBlock / kGroup) * p.stack) + group * p.stack;
  for (;;) {
    const int i = hare::take_ray<kGroup>(counter, lane, mask);
    if (i >= n) break;  // the whole group
    shoot_ray<K, MT>(i, lane, mask, o, d, ex, child_box, child_info, win_geom, win_ids, p,
                     st_node, st_t, best_t_out, best_tri_out, pops_out, err);
  }
  hare::group_done<kGroup>(counter, lane);
}

template <int K, bool MT>
void launch(cudaStream_t s, const float* o, const float* d, const int* ex, int n,
            const float4* box, const int4* info, const float4* geom, const int4* ids,
            const TreeP& p, float* best_t, int* best_tri, int* pops, int* err,
            unsigned* counter) {
  const size_t smem = static_cast<size_t>(kBlock / kGroup) * p.stack * (sizeof(int) + sizeof(float));
  const int blocks = hare::persistent_blocks(tree_shoot_kernel<K, MT>, n, kGroup, kBlock, smem);
  tree_shoot_kernel<K, MT><<<blocks, kBlock, smem, s>>>(o, d, ex, n, box, info, geom, ids, p,
                                                        best_t, best_tri, pops, err, counter);
}

template <int K>
void launch_k(bool mt, cudaStream_t s, const float* o, const float* d, const int* ex, int n,
              const float4* box, const int4* info, const float4* geom, const int4* ids,
              const TreeP& p, float* best_t, int* best_tri, int* pops, int* err,
              unsigned* counter) {
  if (mt)
    launch<K, true>(s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err, counter);
  else
    launch<K, false>(s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err, counter);
}

}  // namespace

// child_box (rows, K, 8) f32; child_info (rows, K, 4) i32; win_geom (R, win,
// 12) f32; win_ids (R, win, 4) i32.  iparams (host): K (2, 4 or 8), win,
// pseudo_root, stack bound S (<= 128), top_index (-1 = none), mt.  pops may
// be null.  err: one int the kernel sets to 1 on a stack overflow.  counter:
// the persistent launch's two unsigned on the device, 0 before the launch
// and left at 0 (persistent.cuh).  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unsupported K or S.
extern "C" int hare_tree_shoot(const float* o, const float* d, const int* ex, int n,
                               const float* child_box, const int* child_info,
                               const float* win_geom, const int* win_ids, float min_t,
                               const int* iparams, float* best_t, int* best_tri,
                               int* pops, int* err, unsigned* counter, void* stream) {
  const int K = iparams[0];
  const TreeP p{iparams[1], iparams[2], iparams[3], min_t, iparams[4]};
  const bool mt = iparams[5] != 0;
  if (p.stack > kMaxStack || p.stack < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* box = reinterpret_cast<const float4*>(child_box);
    const int4* info = reinterpret_cast<const int4*>(child_info);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    if (K == 2)
      launch_k<2>(mt, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err, counter);
    else if (K == 4)
      launch_k<4>(mt, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err, counter);
    else if (K == 8)
      launch_k<8>(mt, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err, counter);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
