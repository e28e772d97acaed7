// K1 grid_shoot: nearest hit through the uniform voxel grid, one thread per ray.
//
// Replaces the XLA loops of hare_tpu/accel/voxel.py shoot_grid (:414-867: grid
// entry, the lockstep collect/p1_step DDA march, the resume rounds) and
// hare_tpu/accel/common.py test_windows/_test_windows (:125-274).  On the TPU
// the march and the window test were split (collect-then-test) because an
// in-loop gather restaged its whole table each step; on Hopper each thread
// loads its own rows, so the march and the test are fused and a ray stops as
// soon as the next cell's entry t exceeds its best hit.  The candidate
// buffers, resume rounds, straggler tiers and chunking are not needed.
//
// What bounds it on the H100: dependent loads.  Each step reads one 8-byte
// cell_meta entry, then 64 bytes per candidate triangle (three float4 of
// geometry, one int4 of ids); threads of a warp walk different cells, so the
// loads do not coalesce and the kernel is latency-bound, not bandwidth- or
// FLOP-bound.  The design keeps all per-ray state in registers, reads the
// tables through the read-only path (__ldg), and stops early; the tables of
// the bench scene (0.9 MB of cell_meta, tens of MB of windows) mostly stay in
// the 50 MB L2.  Warp divergence across rays is the known cost left for later.
//
// Semantics (all from the JAX code): entry at max(t_near, 0) + 1e-4*char_step
// for outside rays; masked DDA step where ties advance several axes at once;
// distance-field jump when dist >= 2; acceptance valid & t > min_t &
// tid >= 0 & poly != ex0 & poly != ex1 (& top == top_index when set); the
// nearest t wins, equal t goes to the lowest triangle id.
#include <limits>

#include "intersect.cuh"

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Grid {
  float gmin[3], gmax[3], vox[3], inv_vox[3];
  float entry_eps;  // ENTRY_EPS * char_step (voxel.py:501)
  float min_t;
  int dims[3];
  int win;        // triangles per window row
  int top_index;  // -1 = no topology filter
};

// Parametric t of the cell boundary the ray leaves cell `cl` through, along
// one axis (voxel.py:545-548, :663-666).
__device__ __forceinline__ float boundary_t(const Grid& g, int c, int cl,
                                            float oc, float dc, float inv_sd) {
  const float nxt = g.gmin[c] + static_cast<float>(cl + (dc > 0.f)) * g.vox[c];
  return dc == 0.f ? kInf : (nxt - oc) * inv_sd;
}

template <bool MT>
__global__ void __launch_bounds__(128)
grid_shoot_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const int* __restrict__ ex, int n,
                  const int2* __restrict__ cell_meta,
                  const float4* __restrict__ win_geom,
                  const int4* __restrict__ win_ids, const Grid g,
                  float* __restrict__ best_t_out, int* __restrict__ best_tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float oc[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const float dc[3] = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const int ex0 = ex[2 * i], ex1 = ex[2 * i + 1];
  float best_t = kInf;
  int best_tri = -1;

  // ---- grid entry: slab test against the grid box (voxel.py:494-503).
  bool inside = true;
  float t_near = -kInf, t_far = kInf;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool par = dc[c] == 0.f;
    const float inv = 1.f / (par ? 1.f : dc[c]);
    const float t1 = (g.gmin[c] - oc[c]) * inv;
    const float t2 = (g.gmax[c] - oc[c]) * inv;
    const bool in_slab = oc[c] >= g.gmin[c] && oc[c] <= g.gmax[c];
    t_near = fmaxf(t_near, par ? (in_slab ? -kInf : kInf) : fminf(t1, t2));
    t_far = fminf(t_far, par ? (in_slab ? kInf : -kInf) : fmaxf(t1, t2));
    inside = inside && in_slab;
  }
  const bool box_hit = t_far >= fmaxf(t_near, 0.f) && t_far >= 0.f;
  const float t0 = inside ? 0.f : (box_hit ? fmaxf(t_near, 0.f) + g.entry_eps : kInf);
  if (!(t0 < kInf)) {
    best_t_out[i] = best_t;
    best_tri_out[i] = best_tri;
    return;
  }

  // ---- DDA setup (voxel.py:516-552): zero components get t_delta = inf.
  float inv_sd[3], t_delta[3], t_max[3];
  int step[3], cell[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    inv_sd[c] = 1.f / (dc[c] == 0.f ? 1.f : dc[c]);
    step[c] = dc[c] > 0.f ? 1 : (dc[c] < 0.f ? -1 : 0);
    t_delta[c] = dc[c] == 0.f ? kInf : g.vox[c] * fabsf(inv_sd[c]);
    const float pos = oc[c] + t0 * dc[c];
    const int cl = __float2int_rd((pos - g.gmin[c]) * g.inv_vox[c]);
    cell[c] = min(max(cl, 0), g.dims[c] - 1);
    t_max[c] = boundary_t(g, c, cell[c], oc[c], dc[c], inv_sd[c]);
  }
  const float min_delta = fminf(fminf(t_delta[0], t_delta[1]), t_delta[2]);
  const hare::RayC ray = hare::ray_setup(oc[0], oc[1], oc[2], dc[0], dc[1], dc[2]);

  // A DDA step advances at least one axis and a jump lands beyond the
  // current cell, so a ray visits at most nx + ny + nz - 2 cells.
  const int max_steps = g.dims[0] + g.dims[1] + g.dims[2] + 3;
  for (int s = 0; s < max_steps; ++s) {
    const int2 meta = __ldg(&cell_meta[(cell[0] * g.dims[1] + cell[1]) * g.dims[2] + cell[2]]);
    const int n_wins = static_cast<int>(static_cast<unsigned>(meta.y) >> 8);
    const int dist = meta.y & 0xFF;

    // ---- test every triangle slot of the cell's window rows.
    const int slot_end = (meta.x + n_wins) * g.win;
    for (int slot = meta.x * g.win; slot < slot_end; ++slot) {
      const int4 id = __ldg(&win_ids[slot]);  // (tri, poly, top, -)
      if (id.x < 0 || id.y == ex0 || id.y == ex1 ||
          (g.top_index >= 0 && id.z != g.top_index))
        continue;
      const float4 a = __ldg(&win_geom[3 * slot]);
      const float4 b = __ldg(&win_geom[3 * slot + 1]);
      const float4 c = __ldg(&win_geom[3 * slot + 2]);
      const hare::Tri tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
      float t, u, v;
      if (hare::tri_test<MT, false>(ray, tri, t, u, v) && t > g.min_t &&
          (t < best_t || (t == best_t && id.x < best_tri))) {
        best_t = t;
        best_tri = id.x;
      }
    }

    // ---- advance: masked DDA step, or distance-field jump (voxel.py:641-676).
    const float t_exit = fminf(fminf(t_max[0], t_max[1]), t_max[2]);
    bool off = false;
    float t_enter;
    if (dist >= 2) {
      t_enter = t_exit + static_cast<float>(dist - 1) * min_delta;
      const float t_land = t_enter + 1e-4f * min_delta;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pos = oc[c] + t_land * dc[c];
        const int cl = __float2int_rd((pos - g.gmin[c]) * g.inv_vox[c]);
        off = off || cl < 0 || cl >= g.dims[c];
        cell[c] = min(max(cl, 0), g.dims[c] - 1);
        t_max[c] = boundary_t(g, c, cell[c], oc[c], dc[c], inv_sd[c]);
      }
    } else {
      t_enter = t_exit;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (t_max[c] <= t_exit) {
          cell[c] += step[c];
          t_max[c] += t_delta[c];
        }
        off = off || cell[c] < 0 || cell[c] >= g.dims[c];
        cell[c] = min(max(cell[c], 0), g.dims[c] - 1);
      }
    }
    if (off || !(t_enter <= best_t)) break;
  }
  best_t_out[i] = best_t;
  best_tri_out[i] = best_tri;
}

}  // namespace

// fparams (host): gmin[3], gmax[3], vox[3], inv_vox[3], entry_eps, min_t.
// iparams (host): dims[3], win, top_index (-1 = none), mt (0 watertight, 1 MT).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_grid_shoot(const float* o, const float* d, const int* ex, int n,
                               const int* cell_meta, const float* win_geom,
                               const int* win_ids, const float* fparams,
                               const int* iparams, float* best_t, int* best_tri,
                               void* stream) {
  Grid g;
  for (int c = 0; c < 3; ++c) {
    g.gmin[c] = fparams[c];
    g.gmax[c] = fparams[3 + c];
    g.vox[c] = fparams[6 + c];
    g.inv_vox[c] = fparams[9 + c];
    g.dims[c] = iparams[c];
  }
  g.entry_eps = fparams[12];
  g.min_t = fparams[13];
  g.win = iparams[3];
  g.top_index = iparams[4];
  const bool mt = iparams[5] != 0;
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int2* meta = reinterpret_cast<const int2*>(cell_meta);
    const float4* geom = reinterpret_cast<const float4*>(win_geom);
    const int4* ids = reinterpret_cast<const int4*>(win_ids);
    if (mt)
      grid_shoot_kernel<true><<<blocks, threads, 0, s>>>(o, d, ex, n, meta, geom, ids, g, best_t, best_tri);
    else
      grid_shoot_kernel<false><<<blocks, threads, 0, s>>>(o, d, ex, n, meta, geom, ids, g, best_t, best_tri);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
