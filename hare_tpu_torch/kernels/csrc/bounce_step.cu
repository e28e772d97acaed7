// K4 bounce_step, forward and backward: one bounce applied to the carried
// ray state, after its shoot.
//
// Replaces the body of hare_tpu/trace/bounce.py trace_rays (:175-247), which
// XLA fuses inside its lax.scan, and in the port the ~70 torch kernels a
// bounce (62 more with scattering) of trace/bounce.py bounce_step, its plain
// version, plus their autograd backward.  Per ray, from the hit record:
// the live mask, the normalised normal, the absorption gather and energy
// product (with scattering: the coin's weight 2s / 2(1 - s) and, on diffuse
// lanes, the cosine lobe from the bounce's uniforms), the specular
// reflection, the path distance and time, the six outputs with their -1 and
// inf fills, the coplanar second exclusion (from the record's edge_nbr, or
// tri_meta lanes 1-3 of the hit triangle where the record has none) and the
// next state.
//
// Rounding.  Built with -fmad=false, each operation rounds as the torch op
// of bounce_step does on the card, in the same order:
//   - torch.sum over a trailing axis of 3 on CUDA splits the row between
//     two threads: (x0 + x2) + x1, from a +0.0 identity (red3);
//   - a tensor divided by a Python float on CUDA is a multiply by the float
//     reciprocal (time = dist * (1 / sound_speed)), as is its backward;
//   - 1.0 / x is torch.reciprocal, sqrt, division IEEE-rounded.
// So the forward is bit-equal to bounce_step on CUDA tensors on the
// specular branch.  The lobe's cosf and sinf may differ from torch's by an
// ulp (PERF.md §6 states the bound measured).
//
// The backward repeats autograd through bounce_step: every local
// derivative as derivatives.yaml writes it, and every gradient that several
// ops send to one tensor added in the order the autograd engine adds them
// (the op created last first), signed zeros included: the normal's nine
// contributions through the lobe, the direction's four, a_'s three.  The
// table gradients are not summed here: the kernel writes each ray's d(a)
// and d(s), which the wrapper sums by polygon with the fixed-order scatter
// (accel/scatter.py), as gather_rows' backward does.  A null cotangent is
// one autograd never forms (no add), a null output one not asked for.
//
// What bounds it on the H100: bytes, ~140-160 B a ray forward (the state,
// the record and the next state; bounds.py bounce_step_bound) and fewer
// backward; at 32,768 rays (the bench) ~5 MB, about 1.5 us at 3.35 TB/s,
// below a launch's latency.  The design: one thread a ray, blocks of 128,
// no shared memory: a simple kernel in place of the glue's many launches.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 128;               // rays a block
constexpr float kEdgeEps = 1e-4f;         // bounce.py EDGE_EPS, as torch compares it in f32
constexpr float kTwoPi = 6.28318530717958647692f;  // 2 pi rounded to f32, as torch's scalar

// torch.sum(x, -1) of a (N, 3) f32 tensor on CUDA (also the sum_to_size of
// a broadcast product's gradient): two threads a row, thread 0 adds
// x0 and x2, thread 1 holds x1, each from a +0.0 identity.
__device__ __forceinline__ float red3(float x0, float x1, float x2) {
  return ((x0 + x2) + x1) + 0.0f;
}

// torch.minimum: NaN propagates.
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// normalize(normal) (geom/math.py) and reflect's 2 dot(d, n_hat).
struct Geo {
  float hx, hy, hz;  // n_hat
  bool pos;          // |normal|^2 > 0
  float sq, rc, inv; // sqrt(where(pos, n2, 1)), its reciprocal, where(pos, rc, 0)
  float dt, s2;      // dot(d, n_hat), 2 dt
};

__device__ __forceinline__ Geo geo(float nx, float ny, float nz, float dx, float dy, float dz) {
  Geo g;
  const float n2 = red3(nx * nx, ny * ny, nz * nz);
  g.pos = n2 > 0.f;
  g.sq = sqrtf(g.pos ? n2 : 1.f);
  g.rc = 1.f / g.sq;
  g.inv = g.pos ? g.rc : 0.f;
  g.hx = nx * g.inv;
  g.hy = ny * g.inv;
  g.hz = nz * g.inv;
  g.dt = red3(dx * g.hx, dy * g.hy, dz * g.hz);
  g.s2 = g.dt * 2.f;
  return g;
}

// cosine_lobe (trace/bounce.py) about n_hat, its intermediates kept for
// the backward.  The lobe's dot(incoming, normal) has reflect's inputs, so
// its value is g.dt.
struct Lobe {
  float nsg;                // -sign(dot)
  float n0, n1, n2;         // the oriented normal
  float cz, cphi, sphi;     // sqrt(r1), rr cos(phi), rr sin(phi)
  float sg, rcd, a, b01, b, m1, n1sq;
  float lx, ly, lz;         // the lobe direction
};

__device__ __forceinline__ Lobe lobe(const Geo& g, float r1, float r2) {
  Lobe L;
  const float sgn = static_cast<float>(static_cast<int>(g.dt > 0.f) - static_cast<int>(g.dt < 0.f));
  L.nsg = -sgn;
  L.n0 = g.hx * L.nsg;
  L.n1 = g.hy * L.nsg;
  L.n2 = g.hz * L.nsg;
  L.cz = sqrtf(r1);
  const float rr = sqrtf(fmaxf(1.f - r1, 0.f));
  const float phi = r2 * kTwoPi;
  L.sg = L.n2 >= 0.f ? 1.f : -1.f;
  L.rcd = 1.f / (L.sg + L.n2);
  L.a = L.rcd * -1.f;
  L.b01 = L.n0 * L.n1;
  L.b = L.b01 * L.a;
  L.m1 = L.sg * (L.n0 * L.n0);
  L.n1sq = L.n1 * L.n1;
  const float t1x = (L.m1 * L.a) + 1.f, t1y = L.sg * L.b, t1z = (-L.sg) * L.n0;
  const float t2x = L.b, t2y = L.sg + (L.n1sq * L.a), t2z = -L.n1;
  L.cphi = rr * cosf(phi);
  L.sphi = rr * sinf(phi);
  L.lx = ((L.cphi * t1x) + (L.sphi * t2x)) + (L.cz * L.n0);
  L.ly = ((L.cphi * t1y) + (L.sphi * t2y)) + (L.cz * L.n1);
  L.lz = ((L.cphi * t1z) + (L.sphi * t2z)) + (L.cz * L.n2);
  return L;
}

struct FwdArgs {
  int n;
  float inv_ss;  // float32(1) / float32(sound_speed)
  // The state.
  const float *energy, *dist, *origin, *dir;
  const bool* alive;
  // The record.
  const bool* hit;
  const float *t, *u, *v, *point, *normal;
  const int *poly, *tri, *nbr;  // nbr null: tri_meta lanes 1-3 of tri
  const int* tri_meta;
  // Tables and the bounce's draws (scattering only).
  const float *absorption, *scattering;
  const bool* diffuse;
  const float *r1, *r2;
  // The next state and the outputs.
  float *o_origin, *o_dir;
  int* o_exclude;
  float *o_energy, *o_dist;
  bool* o_live;
  float *o_oe, *o_time;
  int* o_poly;
  float* o_t;
};

template <bool kScatter>
__global__ void __launch_bounds__(kBlock) bounce_fwd_kernel(const FwdArgs p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const long long j = 3LL * i;
  const bool live = p.hit[i] && p.alive[i];
  const float E = p.energy[i], t = p.t[i];
  const int poly = p.poly[i];
  const int pid = max(poly, 0);
  const float dx = p.dir[j], dy = p.dir[j + 1], dz = p.dir[j + 2];
  const Geo g = geo(p.normal[j], p.normal[j + 1], p.normal[j + 2], dx, dy, dz);
  float e = E * (1.f - p.absorption[pid]);
  float rx = dx - g.s2 * g.hx, ry = dy - g.s2 * g.hy, rz = dz - g.s2 * g.hz;
  if (kScatter) {
    const float sc = p.scattering[pid];
    const bool dif = p.diffuse[i];
    e = e * (dif ? 2.f * sc : 2.f * (1.f - sc));
    if (dif) {
      const Lobe L = lobe(g, p.r1[i], p.r2[i]);
      rx = L.lx;
      ry = L.ly;
      rz = L.lz;
    }
  }
  const float en = live ? e : E;
  const float dist = p.dist[i] + (live ? t : 0.f);
  p.o_energy[i] = en;
  p.o_dist[i] = dist;
  p.o_live[i] = live;
  p.o_oe[i] = live ? en : 0.f;
  p.o_time[i] = dist * p.inv_ss;
  p.o_poly[i] = live ? poly : -1;
  p.o_t[i] = live ? t : CUDART_INF_F;

  // Second exclusion: the edge nearest the hit point (edge k joins corners
  // k, k+1; its barycentric distance is the opposite corner's weight).
  int nb0, nb1, nb2;
  if (p.nbr != nullptr) {
    nb0 = p.nbr[j];
    nb1 = p.nbr[j + 1];
    nb2 = p.nbr[j + 2];
  } else {
    const int* row = p.tri_meta + 8LL * max(p.tri[i], 0);
    nb0 = row[1];
    nb1 = row[2];
    nb2 = row[3];
  }
  const float u = p.u[i], v = p.v[i];
  const float b0 = v, b1 = (1.f - u) - v, b2 = u;
  const int n01 = b0 <= b1 ? nb0 : nb1;
  const float d01 = tmin(b0, b1);
  const int nb = d01 <= b2 ? n01 : nb2;
  const bool on_edge = tmin(d01, b2) < kEdgeEps;
  p.o_exclude[2LL * i] = live ? poly : -1;
  p.o_exclude[2LL * i + 1] = (live && on_edge && nb >= 0) ? nb : -1;
  p.o_origin[j] = live ? p.point[j] : p.origin[j];
  p.o_origin[j + 1] = live ? p.point[j + 1] : p.origin[j + 1];
  p.o_origin[j + 2] = live ? p.point[j + 2] : p.origin[j + 2];
  p.o_dir[j] = live ? rx : dx;
  p.o_dir[j + 1] = live ? ry : dy;
  p.o_dir[j + 2] = live ? rz : dz;
}

struct BwdArgs {
  int n;
  float inv_ss;
  const float *energy, *dir, *normal;
  const bool *alive, *hit;
  const int* poly;
  const float *absorption, *scattering;
  const bool* diffuse;
  const float *r1, *r2;
  // Cotangents of the next state's origin, direction, energy and dist and
  // of the outputs energy, time and t; null where autograd has none.
  const float *g_origin, *g_dir, *g_energy, *g_dist, *g_oe, *g_time, *g_t;
  // Per-ray gradients; null where not asked for.
  float *d_energy, *d_dist, *d_origin, *d_dir, *d_normal, *d_point, *d_t, *d_a, *d_s;
};

template <bool kScatter>
__global__ void __launch_bounds__(kBlock) bounce_bwd_kernel(const BwdArgs p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const long long j = 3LL * i;
  const bool live = p.hit[i] && p.alive[i];

  // The energy chain: en = where(live, e1 [* w], E), e1 = E * (1 - a);
  // oe = where(live, en, 0).  The next state's cotangent comes first.
  if (p.d_energy != nullptr || p.d_a != nullptr || p.d_s != nullptr) {
    float g_en;
    if (p.g_energy != nullptr && p.g_oe != nullptr) {
      g_en = p.g_energy[i] + (live ? p.g_oe[i] : 0.f);
    } else if (p.g_energy != nullptr) {
      g_en = p.g_energy[i];
    } else {
      g_en = live ? p.g_oe[i] : 0.f;
    }
    const float g_e = live ? g_en : 0.f, g_E_where = live ? 0.f : g_en;
    const int pid = max(p.poly[i], 0);
    const float E = p.energy[i];
    const float om = 1.f - p.absorption[pid];
    float g_e1 = g_e;
    if (kScatter) {
      const float sc = p.scattering[pid];
      const bool dif = p.diffuse[i];
      const float w = dif ? 2.f * sc : 2.f * (1.f - sc);
      g_e1 = g_e * w;
      const float g_w = g_e * (E * om);
      // where(dif, 2 sc, 2 (1 - sc)): the (1 - sc) branch's op was made
      // last, so its cotangent comes first.
      if (p.d_s != nullptr) p.d_s[i] = (-((dif ? 0.f : g_w) * 2.f)) + ((dif ? g_w : 0.f) * 2.f);
    }
    if (p.d_energy != nullptr) p.d_energy[i] = g_E_where + g_e1 * om;
    if (p.d_a != nullptr) p.d_a[i] = -(g_e1 * E);
  }

  // The distance: dist = D + where(live, t, 0); time = dist / ss;
  // t_out = where(live, t, inf).
  if (p.d_dist != nullptr || p.d_t != nullptr) {
    const bool has_dist = p.g_dist != nullptr || p.g_time != nullptr;
    float g_dist = 0.f;
    if (p.g_dist != nullptr && p.g_time != nullptr) {
      g_dist = p.g_dist[i] + p.g_time[i] * p.inv_ss;
    } else if (p.g_dist != nullptr) {
      g_dist = p.g_dist[i];
    } else if (p.g_time != nullptr) {
      g_dist = p.g_time[i] * p.inv_ss;
    }
    if (p.d_dist != nullptr) p.d_dist[i] = g_dist;
    if (p.d_t != nullptr) {
      const float from_dist = live ? g_dist : 0.f;
      if (p.g_t != nullptr) {
        const float from_t = live ? p.g_t[i] : 0.f;
        p.d_t[i] = has_dist ? from_t + from_dist : from_t;
      } else {
        p.d_t[i] = from_dist;
      }
    }
  }

  // The origin: where(live, point, origin).
  if (p.g_origin != nullptr) {
    for (int k = 0; k < 3; ++k) {
      const float go = p.g_origin[j + k];
      if (p.d_point != nullptr) p.d_point[j + k] = live ? go : 0.f;
      if (p.d_origin != nullptr) p.d_origin[j + k] = live ? 0.f : go;
    }
  }

  // The direction: where(live, new_dir, d), new_dir = reflect(d, n_hat) or,
  // on diffuse lanes, the lobe; n_hat = normalize(normal).
  if (p.g_dir == nullptr || (p.d_dir == nullptr && p.d_normal == nullptr)) return;
  const float d[3] = {p.dir[j], p.dir[j + 1], p.dir[j + 2]};
  const float nr[3] = {p.normal[j], p.normal[j + 1], p.normal[j + 2]};
  const Geo g = geo(nr[0], nr[1], nr[2], d[0], d[1], d[2]);
  const float h[3] = {g.hx, g.hy, g.hz};
  float g_ndir[3], wd[3], g_refl[3], g_lobe[3];
  for (int k = 0; k < 3; ++k) {
    const float gd = p.g_dir[j + k];
    g_ndir[k] = live ? gd : 0.f;
    wd[k] = live ? 0.f : gd;
  }
  bool dif = false;
  if (kScatter) dif = p.diffuse[i];
  for (int k = 0; k < 3; ++k) {
    g_lobe[k] = dif ? g_ndir[k] : 0.f;
    g_refl[k] = (kScatter && dif) ? 0.f : g_ndir[k];
  }
  // reflect: d - (2 dot(d, n_hat))[:, None] * n_hat.
  const float g_sn[3] = {-g_refl[0], -g_refl[1], -g_refl[2]};
  const float g_dt = red3(g_sn[0] * h[0], g_sn[1] * h[1], g_sn[2] * h[2]) * 2.f;
  float gh[3], gdir[3];
  if (kScatter) {
    // The lobe, on every lane (its zeros carry signs autograd adds).
    const Lobe L = lobe(g, p.r1[i], p.r2[i]);
    const float gt1x = g_lobe[0] * L.cphi, gt1y = g_lobe[1] * L.cphi, gt1z = g_lobe[2] * L.cphi;
    const float gt2x = g_lobe[0] * L.sphi, gt2y = g_lobe[1] * L.sphi, gt2z = g_lobe[2] * L.sphi;
    const float c3[3] = {g_lobe[0] * L.cz, g_lobe[1] * L.cz, g_lobe[2] * L.cz};
    // t2 = [b, sg + n1^2 a, -n1], then t1 = [1 + sg n0^2 a, sg b, -sg n0].
    const float g_n1_t2z = -gt2z;
    const float g_n1sq = gt2y * L.a, ga1 = gt2y * L.n1sq;
    const float g_n1_t2y = g_n1sq * (2.f * L.n1);
    const float g_n0_t1z = gt1z * (-L.sg);
    const float g_b = gt2x + gt1y * L.sg;
    const float g_m1 = gt1x * L.a, ga2 = gt1x * L.m1;
    const float g_n0_t1x = (g_m1 * L.sg) * (2.f * L.n0);
    // b = (n0 n1) a; a = -1 / (sg + nz).
    const float g_b01 = g_b * L.a, ga3 = g_b * L.b01;
    const float g_n0_b = g_b01 * L.n1, g_n1_b = g_b01 * L.n0;
    const float ga = (ga1 + ga2) + ga3;
    const float g_nz = (-(ga * -1.f)) * (L.rcd * L.rcd);
    // The oriented normal's gradient: its consumers in the order autograd
    // runs them (the lobe's last product, then t2z, t2y, t1z, t1x, b's n1
    // and n0, nz), each select adding +0.0 to the other two columns.
    const float z = 0.f;
    const float gn[3] = {
        ((((((c3[0] + z) + z) + g_n0_t1z) + g_n0_t1x) + z) + g_n0_b) + z,
        ((((((c3[1] + g_n1_t2z) + g_n1_t2y) + z) + z) + g_n1_b) + z) + z,
        ((((((c3[2] + z) + z) + z) + z) + z) + z) + g_nz,
    };
    // n = n_hat * -sign(dot): sign's gradient is zeros, which reach n_hat
    // and d through dot's product as signed zeros.
    for (int k = 0; k < 3; ++k) {
      gh[k] = (((gn[k] * L.nsg) + (z * d[k])) + (g_sn[k] * g.s2)) + (g_dt * d[k]);
      gdir[k] = ((wd[k] + (z * h[k])) + g_refl[k]) + (g_dt * h[k]);
    }
  } else {
    for (int k = 0; k < 3; ++k) {
      gh[k] = (g_sn[k] * g.s2) + (g_dt * d[k]);
      gdir[k] = (wd[k] + g_refl[k]) + (g_dt * h[k]);
    }
  }
  if (p.d_dir != nullptr) {
    p.d_dir[j] = gdir[0];
    p.d_dir[j + 1] = gdir[1];
    p.d_dir[j + 2] = gdir[2];
  }
  if (p.d_normal != nullptr) {
    // normalize: n_hat = normal * inv, inv = where(pos, 1 / sqrt(where(pos,
    // n2, 1)), 0), n2 = sum(normal * normal).
    const float g_inv = red3(gh[0] * nr[0], gh[1] * nr[1], gh[2] * nr[2]);
    const float g_rc = g.pos ? g_inv : 0.f;
    const float g_sq = (-g_rc) * (g.rc * g.rc);
    const float g_w1 = g_sq / (2.f * g.sq);
    const float g_n2 = g.pos ? g_w1 : 0.f;
    for (int k = 0; k < 3; ++k) {
      const float x = g_n2 * nr[k];
      p.d_normal[j + k] = ((gh[k] * g.inv) + x) + x;
    }
  }
}

int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

// K4 forward.  state: energy, dist (N,) f32, origin, dir (N, 3) f32, alive
// (N,) bool; record: hit (N,) bool, t, u, v (N,) f32, point, normal (N, 3)
// f32, poly, tri (N,) i32, nbr (N, 3) i32 or null (then tri_meta (T, 8)
// i32 lanes 1-3 of tri); absorption (P,) f32; scattering (P,) f32 or null
// (specular), with diffuse (N,) bool and r1, r2 (N,) f32.  Writes the next
// state (origin, dir (N, 3), exclude (N, 2) i32, energy, dist (N,), live
// (N,) bool) and the outputs energy, time (N,) f32, poly (N,) i32, t (N,)
// f32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int hare_bounce_step(
    const float* energy, const float* dist, const float* origin, const float* dir,
    const bool* alive, const bool* hit, const float* t, const float* u, const float* v,
    const float* point, const float* normal, const int* poly, const int* tri, const int* nbr,
    const int* tri_meta, const float* absorption, const float* scattering, const bool* diffuse,
    const float* r1, const float* r2, int n, float inv_ss, float* o_origin, float* o_dir,
    int* o_exclude, float* o_energy, float* o_dist, bool* o_live, float* o_oe, float* o_time,
    int* o_poly, float* o_t, void* stream) {
  if (n > 0) {
    const FwdArgs p{n, inv_ss, energy, dist, origin, dir, alive, hit, t, u, v, point, normal,
                    poly, tri, nbr, tri_meta, absorption, scattering, diffuse, r1, r2,
                    o_origin, o_dir, o_exclude, o_energy, o_dist, o_live, o_oe, o_time, o_poly,
                    o_t};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (scattering != nullptr)
      bounce_fwd_kernel<true><<<blocks_for(n), kBlock, 0, s>>>(p);
    else
      bounce_fwd_kernel<false><<<blocks_for(n), kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 backward.  energy (N,), dir, normal (N, 3) f32, alive, hit (N,) bool,
// poly (N,) i32, the tables and draws as the forward took them; the
// cotangents g_origin, g_dir (N, 3), g_energy, g_dist, g_oe, g_time, g_t
// (N,) f32, each null where absent; writes d_energy, d_dist (N,), d_origin,
// d_dir, d_normal, d_point (N, 3), d_t, d_a, d_s (N,) f32, each null where
// not wanted (d_a, d_s: per ray, before the sum by polygon).  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int hare_bounce_step_bwd(
    const float* energy, const float* dir, const float* normal, const bool* alive,
    const bool* hit, const int* poly, const float* absorption, const float* scattering,
    const bool* diffuse, const float* r1, const float* r2, const float* g_origin,
    const float* g_dir, const float* g_energy, const float* g_dist, const float* g_oe,
    const float* g_time, const float* g_t, int n, float inv_ss, float* d_energy, float* d_dist,
    float* d_origin, float* d_dir, float* d_normal, float* d_point, float* d_t, float* d_a,
    float* d_s, void* stream) {
  if (n > 0) {
    const BwdArgs p{n, inv_ss, energy, dir, normal, alive, hit, poly, absorption, scattering,
                    diffuse, r1, r2, g_origin, g_dir, g_energy, g_dist, g_oe, g_time, g_t,
                    d_energy, d_dist, d_origin, d_dir, d_normal, d_point, d_t, d_a, d_s};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (scattering != nullptr)
      bounce_bwd_kernel<true><<<blocks_for(n), kBlock, 0, s>>>(p);
    else
      bounce_bwd_kernel<false><<<blocks_for(n), kBlock, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
