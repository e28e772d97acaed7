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
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

MIN_T = 1e-10
EDGE_EPS = 1e-4
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


def loss_and_grad(hit, poly, t, absorption: torch.Tensor, sound_speed: float, bins: int,
                  bin_dt: float):
    """``(energy, time, histogram, d(sum of histogram)/d(absorption))`` of
    the lanes given by their hits, in ``absorption``'s precision."""
    a = absorption.detach().clone().requires_grad_()
    with torch.enable_grad():
        energy, time = lanes(hit, poly, t, a, sound_speed)
        h = histogram(energy, time, hit, bins, bin_dt)
        (g,) = torch.autograd.grad(h.sum(), a)
    return energy.detach(), time.detach(), h.detach(), g
