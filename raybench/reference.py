"""The plain reference: the traced step's semantics in plain PyTorch, worked
out from the faces alone.

It imports nothing of ``hare_tpu_torch`` and takes nothing the program
made: it welds the faces' corners itself, finds each triangle's coplanar
edge neighbours itself, and traces by brute force, every ray against every
triangle, in the precision it is asked for (float64 for the reference,
bfloat16 for the control).

The semantics (those of ``trace_rays`` with ``energy_histogram`` and the
loss as the histogram's sum):

- A ray takes the nearest triangle whose plane it crosses at ``t > 1e-10``
  inside the triangle (edges included), whose polygon is neither of the
  ray's two excluded polygons; of equal ``t`` the lowest triangle.
- A hit multiplies the ray's energy by ``1 - absorption[polygon]``, adds
  ``t`` to its path, reflects it specularly about the triangle's plane and
  restarts it at the hit point, excluding the polygon it hit and, where
  the hit lies within a barycentric ``1e-4`` of an edge, the coplanar
  polygon across that edge.  A ray that misses is dead from then on.
- Each hit's energy falls into the bin ``clip(floor(time / bin_dt), 0,
  bins - 1)`` of its arrival time ``path / sound_speed``; the loss is the
  histogram's sum, and its gradient is taken w.r.t. the absorption.
- Soft bins (``bounce.py:280-293``'s tent rule): with ``pos = time / bin_dt
  - 0.5``, ``i0 = clip(floor(pos), -1, bins - 1)`` and ``frac = clip(pos -
  i0, 0, 1)`` (whose gradient is 1/2 at either bound), ``energy (1 -
  frac)`` falls into bin ``max(i0, 0)`` and ``energy frac`` into ``min(i0 +
  1, bins - 1)``.  The first moment is ``sum_i i h_i``.
- W.r.t. the vertices: the faces' corners are welded as the topology
  documents it, rounded to ``WELD_PRECISION`` decimals and then one vertex
  for each distinct point, held in the scene's stated type (float32).  From
  the program's hits, every lane is replayed in float64 with those vertices
  as leaf tensors: the hit triangle is the one of
  the hit polygon whose least barycentric coordinate at the program's hit
  point is largest; ``t`` is the ray's crossing of that triangle's plane at
  the vertices' positions, then the point, the unit normal, the specular
  reflection, the path and the arrival time, the bins and the loss.  The
  gradient is taken w.r.t. each lane's hit corners, ray by ray, and summed
  at each vertex; beside it each vertex's scale, the sum of the largest
  corner term of each (ray, triangle) that touches it, which the check
  holds the vertex's gap to.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

MIN_T = 1e-10
EDGE_EPS = 1e-4
# The topology's weld: corners rounded to this many decimals are one vertex
# where they are equal (``Topology.build``'s documented default).
WELD_PRECISION = 15
# Elements of one (rays x triangles) block of the brute-force test.
BLOCK = 1 << 25


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def triangles(chunks: Sequence[np.ndarray]):
    """``(corners (T, 3, 3) f64, polygon (T,) i64)``: triangles split off
    the faces in order, a quad's as its corners (0, 1, 2) and (2, 3, 0),
    both of its polygon; polygons are numbered in face order."""
    tris, polys, base = [], [], 0
    for c in chunks:
        c = np.asarray(c, np.float64)
        f = c.shape[0]
        if c.shape[1] == 3:
            tris.append(c)
            polys.append(np.arange(f) + base)
        elif c.shape[1] == 4:
            tris.append(np.stack([c[:, [0, 1, 2]], c[:, [2, 3, 0]]], 1).reshape(-1, 3, 3))
            polys.append(np.repeat(np.arange(f) + base, 2))
        else:
            raise ValueError("faces of 3 or 4 corners only")
        base += f
    return np.concatenate(tris), np.concatenate(polys)


def _vertex_ids(corners: torch.Tensor) -> torch.Tensor:
    """Weld: one id for each distinct point among ``corners`` (M, 3) f64,
    by exact value (-0.0 and 0.0 alike)."""
    bits = (corners + 0.0).contiguous().view(torch.int64)
    order = torch.arange(bits.shape[0], device=bits.device)
    for axis in (2, 1, 0):  # stable sorts, last key first: lexicographic
        order = order[torch.sort(bits[order, axis], stable=True).indices]
    s = bits[order]
    new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    new[1:] = (s[1:] != s[:-1]).any(dim=1)
    ids = torch.empty_like(order)
    ids[order] = torch.cumsum(new.long(), 0) - 1
    return ids


def _plane_keys(tris: torch.Tensor) -> torch.Tensor:
    """Each triangle's plane as four integers: its unit normal ``n`` and
    ``-n . v0``, signed so the last is not negative, in thousandths
    rounded half to even."""
    n = _cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ln = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    n = torch.where(ln > 0, n / torch.where(ln > 0, ln, 1.0), 0.0)
    abcd = torch.cat([n, -_dot(n, tris[:, 0])[:, None]], 1)
    abcd = torch.where(abcd[:, 3:] < 0, -abcd, abcd)
    return torch.round(abcd * 1000.0).to(torch.int64)


def coplanar_neighbours(tris: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """``(T, 3)``: across each edge ``k`` (corners ``k``, ``k + 1``) of each
    triangle, the polygon that shares the edge's two welded corners and lies
    in the same plane, or -1.  Where more than two polygons share an edge,
    the first other polygon in triangle order."""
    t_count = tris.shape[0]
    vid = _vertex_ids(tris.reshape(-1, 3)).reshape(t_count, 3)
    a = vid
    b = vid[:, [1, 2, 0]]
    lo, hi = torch.minimum(a, b).reshape(-1), torch.maximum(a, b).reshape(-1)
    key = lo * (int(vid.max()) + 1 if t_count else 1) + hi
    owner = poly.repeat_interleave(3)
    order = torch.sort(key, stable=True).indices
    k_s, own_s = key[order], owner[order]
    start = torch.ones_like(k_s, dtype=torch.bool)
    start[1:] = k_s[1:] != k_s[:-1]
    run = torch.cumsum(start.long(), 0) - 1
    first = own_s[torch.nonzero(start).squeeze(1)][run]
    differs = own_s != first
    big = torch.iinfo(torch.int64).max
    pos = torch.arange(k_s.shape[0], device=k_s.device)
    first_other = torch.full((int(run[-1]) + 1 if len(run) else 0,), big, dtype=torch.int64,
                             device=k_s.device)
    first_other.scatter_reduce_(0, run[differs], pos[differs], reduce="amin")
    fo = first_other[run]
    second = torch.where(fo < big, own_s[torch.clamp(fo, max=max(len(own_s) - 1, 0))], -1)
    nbr_s = torch.where(differs, first, second)
    nbr = torch.empty_like(nbr_s)
    nbr[order] = nbr_s
    nbr = nbr.reshape(t_count, 3)
    nbr = torch.where(nbr == poly[:, None], -1, nbr)
    keys = _plane_keys(tris)
    n_poly = int(poly.max()) + 1 if t_count else 0
    first_tri = torch.full((n_poly,), t_count, dtype=torch.int64, device=tris.device)
    first_tri.scatter_reduce_(0, poly, torch.arange(t_count, device=tris.device), reduce="amin")
    pkey = keys[first_tri]
    same = (pkey[torch.clamp(nbr, min=0)] == pkey[poly][:, None, :]).all(dim=2)
    return torch.where((nbr >= 0) & same, nbr, -1)


class Scene(NamedTuple):
    """The reference's scene, in one precision: per triangle its polygon,
    coplanar neighbours and the terms of its ray test."""

    poly: torch.Tensor  # (T,) i64
    nbr: torch.Tensor  # (T, 3) i64
    normal: torch.Tensor  # (T, 3) e1 x e2
    c: torch.Tensor  # (T,) normal . v0
    u_axis: torch.Tensor  # (T, 3) (e2 x n) / |n|^2: u = (p - v0) . u_axis
    u0: torch.Tensor  # (T,) v0 . u_axis
    v_axis: torch.Tensor  # (T, 3) (n x e1) / |n|^2
    v0_: torch.Tensor  # (T,) v0 . v_axis
    ok: torch.Tensor  # (T,) bool: a triangle with area


def build(chunks: Sequence[np.ndarray], device, dtype=torch.float64) -> Scene:
    """The reference scene of the faces ``chunks`` on ``device``; welding and
    planes in float64, the ray test's terms in ``dtype``."""
    tris_np, poly_np = triangles(chunks)
    tris = torch.from_numpy(tris_np).to(device)
    poly = torch.from_numpy(poly_np).to(device)
    nbr = coplanar_neighbours(tris, poly)
    t = tris.to(dtype)
    v0, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    n = _cross(e1, e2)
    nn = _dot(n, n)
    ok = nn > 0
    inv = torch.where(ok, 1.0 / torch.where(ok, nn, 1.0), 0.0)
    u_axis = _cross(e2, n) * inv[:, None]
    v_axis = _cross(n, e1) * inv[:, None]
    return Scene(poly, nbr, n, _dot(n, v0), u_axis, _dot(u_axis, v0), v_axis, _dot(v_axis, v0),
                 ok)


def nearest(sc: Scene, o: torch.Tensor, d: torch.Tensor, ex: torch.Tensor):
    """Each ray's nearest accepted triangle: ``(t, tri, u, v)``, ``t`` inf
    and ``tri`` -1 where none; every ray against every triangle, in blocks."""
    n_rays, n_tris = o.shape[0], sc.poly.shape[0]
    dt = o.dtype
    best_t = torch.full((n_rays,), float("inf"), dtype=dt, device=o.device)
    best_tri = torch.full((n_rays,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros(n_rays, dtype=dt, device=o.device)
    best_v = torch.zeros(n_rays, dtype=dt, device=o.device)
    tc = min(n_tris, BLOCK)
    rc = max(1, BLOCK // max(tc, 1))
    for t0 in range(0, n_tris, tc):
        sl = slice(t0, t0 + tc)
        axes = torch.cat([sc.normal[sl], sc.u_axis[sl], sc.v_axis[sl]], 0).T  # (3, 3 Tc)
        poly = sc.poly[sl]
        for r0 in range(0, n_rays, rc):
            rs = slice(r0, r0 + rc)
            m = tc if t0 + tc <= n_tris else n_tris - t0
            od = torch.cat([o[rs], d[rs]], 0) @ axes  # (2 R, 3 Tc)
            r = od.shape[0] // 2
            on, ou, ov = od[:r, :m], od[:r, m:2 * m], od[:r, 2 * m:]
            dn, du, dv = od[r:, :m], od[r:, m:2 * m], od[r:, 2 * m:]
            t = (sc.c[sl] - on) / dn
            u = ou + t * du - sc.u0[sl]
            v = ov + t * dv - sc.v0_[sl]
            acc = (sc.ok[sl] & (dn != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > MIN_T)
                   & (poly != ex[rs, 0:1]) & (poly != ex[rs, 1:2]))
            tm = torch.where(acc, t, float("inf"))
            val, arg = tm.min(dim=1)
            better = val < best_t[rs]
            best_t[rs] = torch.where(better, val, best_t[rs])
            best_tri[rs] = torch.where(better, arg + t0, best_tri[rs])
            best_u[rs] = torch.where(better, u.gather(1, arg[:, None])[:, 0], best_u[rs])
            best_v[rs] = torch.where(better, v.gather(1, arg[:, None])[:, 0], best_v[rs])
    return best_t, best_tri, best_u, best_v


class Trace(NamedTuple):
    """Per bounce and ray, ``(B, N)``: as ``trace_rays`` reports them."""

    hit: torch.Tensor
    poly: torch.Tensor
    t: torch.Tensor
    energy: torch.Tensor
    time: torch.Tensor


def trace(sc: Scene, origin: torch.Tensor, direction: torch.Tensor, absorption: torch.Tensor,
          n_bounces: int, sound_speed: float) -> Trace:
    """Trace the rays ``(origin, direction)`` for ``n_bounces`` bounces in
    the scene's precision."""
    dt = sc.normal.dtype
    o = origin.to(dt)
    d = direction.to(dt)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    a = absorption.to(dt)
    n = o.shape[0]
    ex = torch.full((n, 2), -1, dtype=torch.int64, device=o.device)
    energy = torch.ones(n, dtype=dt, device=o.device)
    dist = torch.zeros(n, dtype=dt, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    rows: List[tuple] = []
    for _ in range(n_bounces):
        t, tri, u, v = nearest(sc, o, d, ex)
        hit = alive & (tri >= 0)
        tri_s = torch.clamp(tri, min=0)
        poly = torch.where(hit, sc.poly[tri_s], -1)
        energy = torch.where(hit, energy * (1.0 - a[torch.clamp(poly, min=0)]), energy)
        dist = dist + torch.where(hit, t, 0.0)
        rows.append((hit, poly, torch.where(hit, t, float("inf")), torch.where(hit, energy, 0.0),
                     dist / sound_speed))
        nrm = sc.normal[tri_s]
        nrm = nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)
        new_d = d - 2.0 * _dot(d, nrm)[:, None] * nrm
        point = o + torch.where(hit, t, 0.0)[:, None] * d
        # The edge nearest the hit: edge k joins corners k and k + 1, and its
        # barycentric distance is the weight of the corner opposite it.
        w = torch.stack([v, 1.0 - u - v, u], 1)
        wmin, k = w.min(dim=1)
        across = sc.nbr[tri_s].gather(1, k[:, None])[:, 0]
        ex2 = torch.where(hit & (wmin < EDGE_EPS) & (across >= 0), across, -1)
        o = torch.where(hit[:, None], point, o)
        d = torch.where(hit[:, None], new_d, d)
        ex = torch.stack([poly, ex2], 1)
        alive = hit
    return Trace(*(torch.stack(x) for x in zip(*rows)))


def lanes(hit: torch.Tensor, poly: torch.Tensor, t: torch.Tensor, absorption: torch.Tensor,
          sound_speed: float):
    """Every lane's energy and arrival time, ``(B, N)`` each, from its hits:
    whether each bounce hit, on which polygon, at what ``t``.  Computed in
    ``absorption``'s precision; differentiable in it."""
    dt = absorption.dtype
    factor = torch.where(hit, 1.0 - absorption[torch.clamp(poly.long(), min=0)], 1.0)
    energy = torch.where(hit, torch.cumprod(factor, dim=0), 0.0)
    time = torch.cumsum(torch.where(hit, t.to(dt), 0.0), dim=0) / sound_speed
    return energy, time


def histogram(energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, bins: int,
              bin_dt: float) -> torch.Tensor:
    """The hard histogram of the hit lanes, in ``energy``'s precision."""
    # Clamped again as integers: bins - 1 need not be exact in a low precision.
    b = torch.clamp(torch.floor(time / bin_dt), 0, bins).long().clamp(max=bins - 1)
    h = torch.zeros(bins, dtype=energy.dtype, device=energy.device)
    return h.index_add(0, b[hit], energy[hit])


def soft_histogram(energy: torch.Tensor, time: torch.Tensor, hit: torch.Tensor, bins: int,
                   bin_dt: float) -> torch.Tensor:
    """The soft (tent) histogram of the hit lanes, in ``energy``'s precision;
    differentiable in ``energy`` and ``time``."""
    pos = time / bin_dt - 0.5
    i0 = torch.clamp(torch.floor(pos.detach()), -1, bins - 1)
    zero, one = pos.new_zeros(()), pos.new_ones(())
    # min(max(.)) and not clamp: their gradient is 1/2 at a bound, clip's.
    frac = torch.minimum(torch.maximum(pos - i0, zero), one)
    # Clamped again as integers: bins - 1 need not be exact in a low precision.
    i0 = i0.long().clamp(-1, bins - 1)
    lo, hi = torch.clamp(i0, min=0), torch.clamp(i0 + 1, max=bins - 1)
    e_hi = energy * frac
    e_lo = energy - e_hi
    h = torch.zeros(bins, dtype=energy.dtype, device=energy.device)
    return h.index_add(0, lo[hit], e_lo[hit]).index_add(0, hi[hit], e_hi[hit])


def loss_of(h: torch.Tensor, first_moment: bool) -> torch.Tensor:
    """The histogram's sum, or its first moment ``sum_i i h_i``."""
    if not first_moment:
        return h.sum()
    return (h * torch.arange(h.shape[0], dtype=h.dtype, device=h.device)).sum()


def loss_and_grad(hit, poly, t, absorption: torch.Tensor, sound_speed: float, bins: int,
                  bin_dt: float, soft: bool = False, first_moment: bool = False):
    """``(energy, time, histogram, d(loss)/d(absorption))`` of the lanes
    given by their hits, in ``absorption``'s precision; the loss is the
    histogram's sum unless ``first_moment``, the bins hard unless
    ``soft``."""
    a = absorption.detach().clone().requires_grad_()
    with torch.enable_grad():
        energy, time = lanes(hit, poly, t, a, sound_speed)
        if soft:
            h = soft_histogram(energy, time, hit, bins, bin_dt)
        else:
            h = histogram(energy, time, hit, bins, bin_dt)
        (g,) = torch.autograd.grad(loss_of(h, first_moment), a)
    return energy.detach(), time.detach(), h.detach(), g


class Mesh(NamedTuple):
    """The faces welded: the vertices (float64) and each triangle's corners
    as vertex ids, with the triangles of each polygon."""

    vertices: torch.Tensor  # (V, 3) f64
    tri_vid: torch.Tensor  # (T, 3) i64
    first_tri: torch.Tensor  # (P,) i64: a polygon's first triangle
    two: torch.Tensor  # (P,) bool: a quad, whose second triangle follows


def weld(chunks: Sequence[np.ndarray], device, precision: int = WELD_PRECISION) -> Mesh:
    """The faces' mesh on ``device``: every corner rounded to ``precision``
    decimals, one vertex for each distinct point."""
    tris_np, poly_np = triangles(chunks)
    corners = torch.round(torch.from_numpy(tris_np).to(device).reshape(-1, 3),
                          decimals=precision)
    ids = _vertex_ids(corners)
    n_v = int(ids.max()) + 1 if ids.numel() else 0
    vertices = torch.zeros(n_v, 3, dtype=torch.float64, device=device)
    vertices[ids] = corners + 0.0
    poly = torch.from_numpy(poly_np).to(device)
    n_t = poly.shape[0]
    n_p = int(poly.max()) + 1 if n_t else 0
    first = torch.full((n_p,), n_t, dtype=torch.int64, device=device)
    first.scatter_reduce_(0, poly, torch.arange(n_t, device=device), reduce="amin")
    count = torch.zeros(n_p, dtype=torch.int64, device=device).index_add_(
        0, poly, torch.ones_like(poly))
    return Mesh(vertices, ids.reshape(n_t, 3), first, count > 1)


def match_vertices(ref: torch.Tensor, prog: torch.Tensor):
    """``perm`` with ``prog[perm[i]]`` the program's vertex at the reference
    vertex ``ref[i]``'s position, both as float32 (the program's vertices'
    type); None where the two sets are not one-to-one."""
    n = ref.shape[0]
    if prog.shape[0] != n:
        return None
    ids = _vertex_ids(torch.cat([ref.float(), prog.to(ref.device).float()]).double())
    ids_r, ids_p = ids[:n], ids[n:]
    if (torch.unique(ids_r).numel() != n or torch.unique(ids_p).numel() != n
            or not torch.equal(torch.sort(ids_r).values, torch.sort(ids_p).values)):
        return None
    at = torch.empty(int(ids.max()) + 1, dtype=torch.int64, device=ids.device)
    at[ids_p] = torch.arange(n, device=ids.device)
    return at[ids_r]


def _least_barycentric(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The least barycentric coordinate of the points ``p`` (N, 3) in the
    plane of the triangles ``c`` (N, 3, 3)."""
    e1, e2, w = c[:, 1] - c[:, 0], c[:, 2] - c[:, 0], p - c[:, 0]
    d11, d12, d22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    dw1, dw2 = _dot(w, e1), _dot(w, e2)
    den = d11 * d22 - d12 * d12
    den = torch.where(den != 0, den, 1.0)
    b1 = (d22 * dw1 - d12 * dw2) / den
    b2 = (d11 * dw2 - d12 * dw1) / den
    return torch.minimum(torch.minimum(b1, b2), 1.0 - b1 - b2)


def hit_triangles(mesh: Mesh, vertices: torch.Tensor, poly: torch.Tensor,
                  point: torch.Tensor) -> torch.Tensor:
    """Each lane's triangle of its polygon ``poly`` (clamped at 0) that
    holds its ``point``: of a quad's two, the one whose least barycentric
    coordinate is larger (the first where equal)."""
    p = torch.clamp(poly.long(), min=0)
    a = mesh.first_tri[p]
    b = torch.where(mesh.two[p], a + 1, a)
    v = vertices.detach()
    pt = point.to(v.dtype)
    wa = _least_barycentric(v[mesh.tri_vid[a]], pt)
    wb = _least_barycentric(v[mesh.tri_vid[b]], pt)
    return torch.where(wb > wa, b, a)


class Replay(NamedTuple):
    """The replay of every lane, ``(B, N)`` each: the arrival time
    (differentiable in the vertices), the hit triangle, and ``|cos|`` of the
    angle at which the ray meets it (1 where the lane did not hit); and the
    hit triangle's corners ``(B, N, 3, 3)``, gathered from the vertices, which
    the lane's terms flow through; once the gradient is taken, ``term``
    ``(B, N)``, the norm of the largest of the ray's terms at those
    corners."""

    time: torch.Tensor
    tri: torch.Tensor
    cos: torch.Tensor
    corners: torch.Tensor
    term: Optional[torch.Tensor] = None


def replay(mesh: Mesh, vertices: torch.Tensor, origin: torch.Tensor, direction: torch.Tensor,
           hit: torch.Tensor, poly: torch.Tensor, point: torch.Tensor,
           sound_speed: float) -> Replay:
    """Every lane replayed from the program's hits (whether each bounce hit,
    the polygon, the point) at ``vertices``, in their precision."""
    dt = vertices.dtype
    o = origin.to(dt)
    d = direction.to(dt)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    dist = torch.zeros(o.shape[0], dtype=dt, device=o.device)
    tri = torch.stack([hit_triangles(mesh, vertices, poly[b], point[b])
                       for b in range(hit.shape[0])])
    corners = vertices[mesh.tri_vid[tri]]
    times, coss = [], []
    for b in range(hit.shape[0]):
        h = hit[b]
        c = corners[b]
        n = _cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
        den = _dot(n, d)
        # Lanes that did not hit keep finite terms, so no NaN reaches the
        # gradient through the branch not taken.
        ok = h & (den != 0)
        t = torch.where(ok, _dot(n, c[:, 0] - o) / torch.where(ok, den, 1.0), 0.0)
        dist = dist + t
        times.append(dist / sound_speed)
        ln = torch.linalg.vector_norm(n, dim=1, keepdim=True)
        nh = n / torch.where(ln > 0, ln, 1.0)
        coss.append(torch.where(h, _dot(d, nh).detach().abs(), 1.0))
        o = torch.where(h[:, None], o + t[:, None] * d, o)
        d = torch.where(h[:, None], d - 2.0 * _dot(d, nh)[:, None] * nh, d)
    return Replay(torch.stack(times), tri, torch.stack(coss), corners)


def vertex_loss_and_grad(mesh: Mesh, origin, direction, hit, poly, t, point,
                         absorption: torch.Tensor, sound_speed: float, bins: int, bin_dt: float,
                         soft: bool = True, first_moment: bool = True, dtype=torch.float64,
                         scene_dtype=torch.float32):
    """``(energy, time, histogram, d(loss)/d(vertices), scale, replay)`` of
    the lanes given by the program's hits, replayed in ``dtype`` at the
    mesh's vertices as the scene's type ``scene_dtype`` holds them: the
    gradient ``(V, 3)`` in the mesh's vertex order, the sum of the terms
    each ray brings to the corners of each triangle it hit; and each
    vertex's ``scale`` ``(V,)``, the sum over those (ray, triangle) pairs
    that touch it of the pair's largest corner term (its norm), which the
    replay carries as ``term``."""
    v = mesh.vertices.to(scene_dtype).to(dtype).detach().requires_grad_()
    with torch.enable_grad():
        energy, _ = lanes(hit, poly, t, absorption.detach().to(dtype), sound_speed)
        rp = replay(mesh, v, origin, direction, hit, poly, point, sound_speed)
        if soft:
            h = soft_histogram(energy, rp.time, hit, bins, bin_dt)
        else:
            h = histogram(energy, rp.time, hit, bins, bin_dt)
        loss = loss_of(h, first_moment)
        (terms,) = (torch.autograd.grad(loss, rp.corners, allow_unused=True)
                    if loss.requires_grad else (None,))
    if terms is None:
        terms = torch.zeros_like(rp.corners)
    ids = mesh.tri_vid[rp.tri].reshape(-1)
    g = torch.zeros_like(v).index_add_(0, ids, terms.reshape(-1, 3))
    largest = torch.linalg.vector_norm(terms, dim=-1).amax(dim=-1, keepdim=True)
    scale = torch.zeros(v.shape[0], dtype=dtype, device=v.device).index_add_(
        0, ids, largest.expand(-1, -1, 3).reshape(-1))
    rp = rp._replace(time=rp.time.detach(), corners=rp.corners.detach(), term=largest[..., 0])
    return energy.detach(), rp.time, h.detach(), g, scale, rp
