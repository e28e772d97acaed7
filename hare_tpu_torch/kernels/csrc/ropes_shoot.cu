// B3 ropes_shoot: nearest hit through a KD-tree with ropes, one ray per group
// of G lanes.
//
// Replaces hare_tpu/accel/ropes.py shoot_kdtree_ropes (:272-520), a lockstep
// rope walk that appends packed (start, width) window runs to a buffer, tests
// them in one batched pass per round, and resumes unresolved rays through
// buffer tiers and straggler rounds.  Here each ray carries (node, t,
// position) and walks (Popov et al. 2007):
//   - at an inner node, descend one level by comparing the position with the
//     split, the tie going to the direction's sign (ropes.py:362-371);
//   - at a leaf, test its window run at once (windows.cuh, shared with K1 and
//     B2; the best hit updates live), take the exit face by the three-slab
//     min with x-then-y-then-z tie order (:392-413), snap the exit coordinate
//     onto the face plane (:423-427) and follow the rope; rope -1 is off the
//     tree;
//   - stop once the next leaf's entry t exceeds the best hit (:442; <=, so an
//     equal-t hit with a lower triangle id ahead is still found).
// Entry follows :312-331: t0 = 0 inside the root box, else max(t_near, 0) +
// ENTRY_EPS * char_step.  Positions are o + t*d, the product and the sum
// each rounded as the plain version rounds them (the kernels are built with
// -fmad=false; the walk relies on the snapped and recomputed coordinates the
// plain version computes).  The slab reciprocal uses where(d == 0, 1, d) and
// t = inf for a zero component (:325-326, :396-398); min propagates NaN as
// jnp.minimum does.
//
// What bounds it on the H100: dependent loads.  Each step reads one node
// (int4 + the split, or the leaf's box, window run and ropes), then the
// leaf's window rows; no stack, the per-ray state is a few registers.  The
// first design, one thread per ray, filled the card to an eighth, a warp
// waited for the slowest of its 32 walks, and each window slot was two
// dependent, uncoalesced loads tested by one thread.
//
// The design, as K1's.  The walk is serial per ray, so the G lanes of a
// group carry one ray's (node, position, t) in the same registers: a node
// load is one broadcast address for the group, the exit face, the snap and
// the rope come out identical on every lane, and a leaf's run goes to
// hare::test_run_group (lane k tests slots k, k + G, ..., and a shuffle
// reduction of the hit key leaves every lane with the same best hit), so
// the group never diverges.  The launch is persistent (persistent.cuh).
// G = 16, 128 threads a block and the persistent launch were chosen by
// measurement among G = 8, 256 threads and one group per ray
// (hare_tpu_torch/benchmarks/kernel_sweep.py, PERF.md §6).  The result is
// bit-equal to the plain version's, steps included.
//
// A rope walk has no closed-form step bound; the tree gives one: each leaf is
// entered at most once per ray and each entry descends at most max_depth
// levels, so max_steps = n_leaves * (max_depth + 1).  A ray that reaches it
// sets the error flag (the wrapper raises).
#include <limits>

#include "persistent.cuh"
#include "windows.cuh"

namespace {

constexpr int kGroup = 16;   // lanes per ray
constexpr int kBlock = 128;  // threads per block
static_assert(kBlock % 32 == 0, "whole warps per block");

constexpr float kInf = std::numeric_limits<float>::infinity();

struct RopeP {
  float rmin[3], rmax[3];
  float entry_eps;  // ENTRY_EPS * char_step
  float min_t;
  int win;
  int max_steps;
  int top_index;  // -1 = no topology filter
};

// Ray i, on every lane of its group (lane `lane`, the group's lanes `mask`).
template <bool MT>
__device__ __forceinline__ void shoot_ray(int i, int lane, unsigned mask,
                                          const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const int* __restrict__ ex,
                                          const int4* __restrict__ node_tab,
                                          const float* __restrict__ split,
                                          const float4* __restrict__ box,
                                          const int2* __restrict__ leaf_win,
                                          const int4* __restrict__ ropes,
                                          const float4* __restrict__ win_geom,
                                          const int4* __restrict__ win_ids, const RopeP& p,
                                          float* __restrict__ best_t_out,
                                          int* __restrict__ best_tri_out,
                                          int* __restrict__ steps_out, int* __restrict__ err) {
  const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  float best_t = kInf;
  int best_tri = -1;
  int steps = 0;

  // ---- entry: slab test against the root box (ropes.py:312-331, ray_aabb).
  bool inside = true;
  float t_near = -kInf, t_far = kInf;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool par = dc[c] == 0.f;
    const float inv = 1.f / (par ? 1.f : dc[c]);
    const float t1 = (p.rmin[c] - oc[c]) * inv;
    const float t2 = (p.rmax[c] - oc[c]) * inv;
    const bool in_slab = oc[c] >= p.rmin[c] && oc[c] <= p.rmax[c];
    t_near = hare::nan_max(t_near, par ? (in_slab ? -kInf : kInf) : hare::nan_min(t1, t2));
    t_far = hare::nan_min(t_far, par ? (in_slab ? kInf : -kInf) : hare::nan_max(t1, t2));
    inside = inside && in_slab;
  }
  const float t_near0 = hare::nan_max(t_near, 0.f);
  const bool box_hit = t_far >= t_near0 && t_far >= 0.f;
  const float t0 = inside ? 0.f : (box_hit ? t_near0 + p.entry_eps : kInf);

  if (t0 < kInf) {
    float inv_sd[3], pos[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      inv_sd[c] = 1.f / (dc[c] == 0.f ? 1.f : dc[c]);
      pos[c] = oc[c] + t0 * dc[c];
    }
    const hare::RayC ray = hare::ray_setup(oc[0], oc[1], oc[2], dc[0], dc[1], dc[2]);
    const hare::RunFilter filter{ex[2 * i], ex[2 * i + 1], p.top_index, p.min_t};
    int node = 0;
    bool done = false;
    while (steps < p.max_steps) {
      ++steps;
      const int4 nd = __ldg(&node_tab[node]);  // (axis, is_leaf, lo, hi)
      if (!nd.y) {
        // ---- inner: one-level descent at the carried position.
        const float pa = hare::pick3(nd.x, pos[0], pos[1], pos[2]);
        const float da = hare::pick3(nd.x, dc[0], dc[1], dc[2]);
        const float sv = __ldg(&split[node]);
        node = (pa < sv || (pa == sv && da < 0.f)) ? nd.z : nd.w;
        continue;
      }
      // ---- leaf: its window run, then the exit face and its rope.
      const int2 lw = __ldg(&leaf_win[node]);
      if (lw.y > 0)
        hare::test_run_group<MT, kGroup>(ray, win_geom, win_ids, lw.x, lw.y, p.win, filter,
                                         lane, mask, best_t, best_tri);
      const float4 bmin = __ldg(&box[2 * node]);
      const float4 bmax = __ldg(&box[2 * node + 1]);
      const float lo_c[3] = {bmin.x, bmin.y, bmin.z}, hi_c[3] = {bmax.x, bmax.y, bmax.z};
      float far_c[3], t_ax[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        far_c[c] = dc[c] > 0.f ? hi_c[c] : lo_c[c];
        t_ax[c] = dc[c] == 0.f ? kInf : (far_c[c] - oc[c]) * inv_sd[c];
      }
      const float t_exit = hare::nan_min(hare::nan_min(t_ax[0], t_ax[1]), t_ax[2]);
      const bool ex0 = t_ax[0] <= t_exit;
      const bool ex1 = !ex0 && t_ax[1] <= t_exit;
      const bool ex2 = !ex0 && !ex1;
      const int face = ex0 ? (dc[0] > 0.f) : (ex1 ? 2 + (dc[1] > 0.f) : 4 + (dc[2] > 0.f));
      const int4 r_lo = __ldg(&ropes[2 * node]);  // -x, +x, -y, +y
      const int4 r_hi = __ldg(&ropes[2 * node + 1]);  // -z, +z, -, -
      const int rope = face == 0 ? r_lo.x : face == 1 ? r_lo.y : face == 2 ? r_lo.z
                     : face == 3 ? r_lo.w : face == 4 ? r_hi.x : r_hi.y;
      pos[0] = ex0 ? far_c[0] : oc[0] + t_exit * dc[0];
      pos[1] = ex1 ? far_c[1] : oc[1] + t_exit * dc[1];
      pos[2] = ex2 ? far_c[2] : oc[2] + t_exit * dc[2];
      if (rope < 0 || !(t_exit <= best_t)) {
        done = true;
        break;
      }
      node = rope;
    }
    if (!done && lane == 0) atomicExch(err, 1);
  }
  if (lane == 0) {
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
    if (steps_out) steps_out[i] = steps;
  }
}

// The persistent launch (persistent.cuh): each group takes its next ray from
// the counter until none is left.
template <bool MT>
__global__ void __launch_bounds__(kBlock)
ropes_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const int* __restrict__ ex, int n, const int4* __restrict__ node_tab,
                   const float* __restrict__ split, const float4* __restrict__ box,
                   const int2* __restrict__ leaf_win, const int4* __restrict__ ropes,
                   const float4* __restrict__ win_geom, const int4* __restrict__ win_ids,
                   const RopeP p, float* __restrict__ best_t_out,
                   int* __restrict__ best_tri_out, int* __restrict__ steps_out,
                   int* __restrict__ err, unsigned* __restrict__ counter) {
  const int lane = threadIdx.x % kGroup;
  const unsigned mask = hare::group_mask<kGroup>();
  for (;;) {
    const int i = hare::take_ray<kGroup>(counter, lane, mask);
    if (i >= n) break;  // the whole group
    shoot_ray<MT>(i, lane, mask, o, d, ex, node_tab, split, box, leaf_win, ropes, win_geom,
                  win_ids, p, best_t_out, best_tri_out, steps_out, err);
  }
  hare::group_done<kGroup>(counter, lane);
}

template <bool MT>
void launch(cudaStream_t s, const float* o, const float* d, const int* ex, int n,
            const int4* nd, const float* split, const float4* bx, const int2* lw,
            const int4* rp, const float4* geom, const int4* ids, const RopeP& p,
            float* best_t, int* best_tri, int* steps, int* err, unsigned* counter) {
  const int blocks = hare::persistent_blocks(ropes_shoot_kernel<MT>, n, kGroup, kBlock, 0);
  ropes_shoot_kernel<MT><<<blocks, kBlock, 0, s>>>(o, d, ex, n, nd, split, bx, lw, rp, geom, ids,
                                                   p, best_t, best_tri, steps, err, counter);
}

}  // namespace

// node (rows, 4) i32; split (rows,) f32; box (rows, 8) f32; leaf_win (rows,
// 2) i32; ropes (rows, 8) i32; win_geom (R, win, 12) f32; win_ids (R, win, 4)
// i32.  fparams (host): root_min[3], root_max[3], entry_eps, min_t.  iparams
// (host): win, max_steps, top_index (-1 = none), mt.  steps may be null.
// err: one int the kernel sets to 1 when a ray reaches max_steps.  counter:
// the persistent launch's two unsigned on the device, 0 before the launch
// and left at 0 (persistent.cuh).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hare_ropes_shoot(const float* o, const float* d, const int* ex, int n,
                                const int* node_tab, const float* split, const float* box,
                                const int* leaf_win, const int* ropes, const float* win_geom,
                                const int* win_ids, const float* fparams, const int* iparams,
                                float* best_t, int* best_tri, int* steps, int* err,
                                unsigned* counter, void* stream) {
  RopeP p;
  for (int c = 0; c < 3; ++c) {
    p.rmin[c] = fparams[c];
    p.rmax[c] = fparams[3 + c];
  }
  p.entry_eps = fparams[6];
  p.min_t = fparams[7];
  p.win = iparams[0];
  p.max_steps = iparams[1];
  p.top_index = iparams[2];
  const bool mt = iparams[3] != 0;
  if (n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* nd = reinterpret_cast<const int4*>(node_tab);
    const float4* bx = reinterpret_cast<const float4*>(box);
    const int2* lw = reinterpret_cast<const int2*>(leaf_win);
    const int4* rp = reinterpret_cast<const int4*>(ropes);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    if (mt)
      launch<true>(s, o, d, ex, n, nd, split, bx, lw, rp, geom, ids, p, best_t, best_tri, steps,
                   err, counter);
    else
      launch<false>(s, o, d, ex, n, nd, split, bx, lw, rp, geom, ids, p, best_t, best_tri, steps,
                    err, counter);
  }
  return static_cast<int>(cudaGetLastError());
}
