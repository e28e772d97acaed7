// B2 tree_shoot: nearest hit through an octree or KD-tree, one thread per ray.
//
// Replaces hare_tpu/accel/tree.py shoot_tree (:249-562), a lockstep
// collect-then-test stack machine: an 8-bit-quantised packed (N, S) stack,
// SoA or one-hot selects, a P-slot push with a lax.cond overflow arm,
// candidate buffers, buffer tiers and straggler rounds.  None of that is
// needed when each thread walks its own ray: a per-thread stack of exact f32
// (node, tmin) entries in local memory, and a pop / prune / slab-test K
// children / test leaf windows / push loop.  Each hit leaf child's window run
// is tested at once (windows.cuh, the test K1 and B3 share) and updates the
// best hit live, so later children and pops prune against it.  Hit inner
// children are pushed far-to-near, so the nearest pops first (the
// reference's ComputeTraversalOrder, Octree - alt.cs:286-306).  Children are
// kept while tmin <= best_t, inclusive, or an equal-t hit with a lower
// triangle id in a later leaf would be lost.
//
// What bounds it on the H100: dependent loads, as in K1.  Each pop reads K
// child boxes (2 float4) and infos (1 int4), then 64 bytes per candidate
// triangle of the hit leaves; threads of a warp walk different nodes, so the
// loads do not coalesce, and a warp waits for its slowest ray.  The stack
// lives in local memory (L1-cached).  The design reads tables through the
// read-only path and prunes against the live best hit.
//
// The stack bound is the JAX one, S = (K-1)*(max_depth+2)+4 (tree.py:268); a
// ray that would push past it sets the error flag (the wrapper raises) and
// stops — no entry is dropped silently.  The slab test divides by
// where(d == 0, 1e-30, d) (tree.py:283) and propagates NaN as jnp.minimum
// does.
#include <limits>

#include "windows.cuh"

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kMaxStack = 128;  // tree.KERNEL_MAX_STACK

struct TreeP {
  int win;          // triangles per window row
  int pseudo_root;  // row whose only child is the root
  int stack;        // per-ray stack bound S
  float min_t;
  int top_index;    // -1 = no topology filter
};

template <int K, bool MT>
__global__ void __launch_bounds__(128)
tree_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ ex, int n,
                  const float4* __restrict__ child_box,
                  const int4* __restrict__ child_info,
                  const float4* __restrict__ win_geom,
                  const int4* __restrict__ win_ids, const TreeP p,
                  float* __restrict__ best_t_out, int* __restrict__ best_tri_out,
                  int* __restrict__ pops_out, int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float inv_d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) inv_d[c] = 1.f / (dc[c] == 0.f ? 1e-30f : dc[c]);
  const hare::RayC ray = hare::ray_setup(oc[0], oc[1], oc[2], dc[0], dc[1], dc[2]);
  const hare::RunFilter filter{ex[2 * i], ex[2 * i + 1], p.top_index, p.min_t};

  int st_node[kMaxStack];
  float st_t[kMaxStack];
  st_node[0] = p.pseudo_root;
  st_t[0] = 0.f;
  int sp = 1, pops = 0;
  float best_t = kInf;
  int best_tri = -1;

  while (sp > 0) {
    --sp;
    ++pops;
    const int node = st_node[sp];
    if (!(st_t[sp] <= best_t)) continue;  // entered beyond the best hit

    // ---- slab-test the K children; test each hit leaf child's run at once.
    float tmin[K];
    int cid[K];
    bool slab[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 lo = __ldg(&child_box[2 * (node * K + k)]);
      const float4 hi = __ldg(&child_box[2 * (node * K + k) + 1]);
      const float lo_c[3] = {lo.x, lo.y, lo.z}, hi_c[3] = {hi.x, hi.y, hi.z};
      float t_lo = -kInf, t_hi = kInf;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t1 = (lo_c[c] - oc[c]) * inv_d[c];
        const float t2 = (hi_c[c] - oc[c]) * inv_d[c];
        t_lo = hare::nan_max(t_lo, hare::nan_min(t1, t2));
        t_hi = hare::nan_min(t_hi, hare::nan_max(t1, t2));
      }
      tmin[k] = hare::nan_max(t_lo, 0.f);
      slab[k] = t_hi >= tmin[k] && t_hi >= 0.f;
      const int4 info = __ldg(&child_info[node * K + k]);  // (id, ws, nw, -)
      cid[k] = info.x;
      if (slab[k] && info.z > 0 && tmin[k] <= best_t)
        hare::test_run<MT>(ray, win_geom, win_ids, info.y, info.z, p.win, filter,
                           best_t, best_tri);
    }

    // ---- push the hit inner children far-to-near (ties: higher slot first).
    unsigned todo = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (slab[k] && cid[k] >= 0 && tmin[k] <= best_t) todo |= 1u << k;
    if (sp + __popc(todo) > p.stack) {
      atomicExch(err, 1);
      break;
    }
    while (todo) {
      int pick = 0, pick_id = 0;
      float pick_t = -kInf;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (((todo >> k) & 1u) && tmin[k] >= pick_t) {
          pick = k;
          pick_t = tmin[k];
          pick_id = cid[k];
        }
      }
      st_node[sp] = pick_id;
      st_t[sp] = pick_t;
      ++sp;
      todo &= ~(1u << pick);
    }
  }
  best_t_out[i] = best_t;
  best_tri_out[i] = best_tri;
  if (pops_out) pops_out[i] = pops;
}

template <int K>
void launch(bool mt, int blocks, cudaStream_t s, const float* o, const float* d,
            const int* ex, int n, const float4* box, const int4* info,
            const float4* geom, const int4* ids, const TreeP& p, float* best_t,
            int* best_tri, int* pops, int* err) {
  if (mt)
    tree_shoot_kernel<K, true><<<blocks, 128, 0, s>>>(o, d, ex, n, box, info, geom, ids, p,
                                                      best_t, best_tri, pops, err);
  else
    tree_shoot_kernel<K, false><<<blocks, 128, 0, s>>>(o, d, ex, n, box, info, geom, ids, p,
                                                       best_t, best_tri, pops, err);
}

}  // namespace

// child_box (rows, K, 8) f32; child_info (rows, K, 4) i32; win_geom (R, win,
// 12) f32; win_ids (R, win, 4) i32.  iparams (host): K (2, 4 or 8), win,
// pseudo_root, stack bound S (<= 128), top_index (-1 = none), mt.  pops may
// be null.  err: one int the kernel sets to 1 on a stack overflow.
// Launches on `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue
// for an unsupported K or S.
extern "C" int hare_tree_shoot(const float* o, const float* d, const int* ex, int n,
                               const float* child_box, const int* child_info,
                               const float* win_geom, const int* win_ids, float min_t,
                               const int* iparams, float* best_t, int* best_tri,
                               int* pops, int* err, void* stream) {
  const int K = iparams[0];
  const TreeP p{iparams[1], iparams[2], iparams[3], min_t, iparams[4]};
  const bool mt = iparams[5] != 0;
  if (p.stack > kMaxStack || p.stack < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + 127) / 128;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* box = reinterpret_cast<const float4*>(child_box);
    const int4* info = reinterpret_cast<const int4*>(child_info);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    if (K == 2)
      launch<2>(mt, blocks, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err);
    else if (K == 4)
      launch<4>(mt, blocks, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err);
    else if (K == 8)
      launch<8>(mt, blocks, s, o, d, ex, n, box, info, geom, ids, p, best_t, best_tri, pops, err);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
