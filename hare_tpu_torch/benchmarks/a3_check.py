"""A3 ``finalize_hits_bwd`` against its plain version element by element,
and the readings of planted faults: what tells a right A3 from a wrong one
in ``chip_smoke.py`` phase 8.1.

    python -m hare_tpu_torch.benchmarks.a3_check

On the rays of each of the 3 bounces of the bench scene (``bench_scene``:
grid, 32,768 rays), with seeded cotangents, it reads the built kernel
against its plain version (autograd through the watertight shear form) in
float64, and in float32, by :func:`agreement`: for d(origin), d(direction),
the corner cotangents and the vertex gradient (the corners summed by the
ordered scatter), the tolerance each needs and the elements outside
``A3_TOL`` (each ray held to the size of what it sums, its condition
number and the effect of rounding its inputs), the median non-zero |g|
over the largest, and the largest |difference| over the largest |g|.
Against the plain version in float64
it also reads the corner cotangents of each ray and their sums onto the
vertices, of the kernel and of the f32 plain version, and names the ray
and corner where each errs most, with that ray's |det| over |e1| |e2| |d|
(:func:`corner_errors`).  Then each fault of ``FAULTS`` (``finalize_bwd.cu``
with one statement replaced, built apart in a scratch directory under
``_build``) is read against the float64 plain version the same way.  One
line a reading, then one JSON line.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import torch

from ..kernels import build

__all__ = ["A3_PARAMS", "A3_TOL", "FAULTS", "a3_given", "agreement", "condition",
           "corner_errors", "input_sensitivity", "jacobian_mass", "ray_bounds",
           "seeded_cotangents"]

# A3's closed form against the plain version (autograd through the
# watertight shear form) in float64: the kernel's f32 rounding.  A3 sums
# J^T g per ray, so its rounding scales with |J|^T |g| (jacobian_mass, the
# size of what is summed, however the cotangents cancel) times the ray's
# condition number cond = |e1| |e2| |d| / |det| (1 for a ray square to its
# triangle; a grazing ray's det nears 0), and with how far rounding its
# inputs' differences moves the result (input_sensitivity).  Every element
# of a ray's d(origin), d(direction) and corner cotangents lies within
# A3_TOL x that ray's bound (ray_bounds), each vertex sum within A3_TOL x
# the sum of its corners' bounds.  On an H100 the built kernel needs at
# most 1.5e-7 on the bench bounces and config 4's, and each planted fault
# at least 0.37 on every bench bounce (PERF.md).
A3_TOL = 1e-5

# Planted faults of finalize_bwd.cu: (label, ((old, new), ...)), each old
# text occurring once.
FAULTS = (
    ("det's cotangent dropped",
     (("const float a_det = -((gt * t + gu * u) + gv * v) * inv;", "const float a_det = 0.f;"),)),
    ("the point's cotangent kept from t",
     (("const float gt = g_t_i + dot(gp, rd);", "const float gt = g_t_i;"),)),
    ("the normal's e1 partial negated",
     (("V3 ge1 = cross(e2, gn), ge2 = cross(gn, e1);",
       "V3 ge1 = cross(gn, e2), ge2 = cross(gn, e1);"),)),
)

# The parameters of hare_finalize_hits_bwd before the stream, as a fault is
# called.
A3_PARAMS = ("vertices", "tri_meta", "best_tri", "t_fwd", "hit", "o", "d", "g_t", "g_u", "g_v",
             "g_point", "g_normal", "n", "d_o", "d_d", "keys", "d_corner")


def seeded_cotangents(n: int, seed: int, dev):
    """Cotangents of a hit record's t, u, v (N,), point and normal (N, 3)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev)
                 for shape in ((n,), (n,), (n,), (n, 3), (n, 3)))


def condition(vertices, tri_meta, best_tri, d) -> torch.Tensor:
    """Each ray's condition number ``|e1| |e2| |d| / |det|`` (float64, at
    least 1; inf where det is 0) on its winner's triangle (triangle 0 on a
    miss, as A3 takes it)."""
    c = vertices.double()[tri_meta[best_tri.clamp(min=0).long(), 4:7].long()]
    e1, e2, dd = c[:, 1] - c[:, 0], c[:, 2] - c[:, 0], d.double()
    det = (e1 * torch.linalg.cross(dd, e2, dim=1)).sum(1)
    scale = e1.norm(dim=1) * e2.norm(dim=1) * dd.norm(dim=1)
    return torch.where(det == 0, torch.inf, torch.clamp(scale / det.abs(), min=1.0))


def jacobian_mass(args):
    """``|J|^T |g|`` of each ray in float64, where A3 computes ``J^T g``: for
    d(origin), d(direction) and the corner cotangents, the sum over the hit
    record's nine outputs (t, u, v, point, normal) of |the output's
    cotangent| x |its partial|, each partial from the plain version in
    float64 with that output's cotangent one and the others zero.  It is
    the size of the sum A3 rounds, whatever the cotangents cancel."""
    from ..accel.common import finalize_hits_bwd_plain

    *inputs, cts = args
    n = inputs[6].shape[0]
    inputs = [x.double() if x.is_floating_point() else x for x in inputs]
    g = torch.cat([c.double().reshape(n, -1) for c in cts], 1).abs()  # (N, 9)
    mass = None
    for j in range(9):
        one = torch.zeros(n, 9, dtype=torch.float64, device=g.device)
        one[:, j] = 1.0
        part = finalize_hits_bwd_plain(
            *inputs, (one[:, 0], one[:, 1], one[:, 2], one[:, 3:6], one[:, 6:9]))
        terms = (g[:, j, None] * part[0].abs(), g[:, j, None] * part[1].abs(),
                 g[:, j].repeat_interleave(3)[:, None] * part[3].abs())
        mass = terms if mass is None else tuple(a + b for a, b in zip(mass, terms))
    return mass


def input_sensitivity(args):
    """How far A3's float64 result moves when its inputs are rounded as the
    kernel forms them: for d(origin), d(direction) and the corner
    cotangents, the sum over the ray's 15 inputs (origin, direction, three
    corners, each coordinate) of |the change of the plain version in
    float64| when that input moves by a step of 2^-24 of its scale (|o -
    v0| for the origin, |d| for the direction, |v1 - v0| and |v2 - v0| for
    those corners, the largest of the three for v0), over 2^-24.  It holds
    what the condition number misses: an origin all but on the plane it
    hits (t near 0), whose t the rounding of o - v0 moves by far more than
    a rounding of t."""
    from ..accel.common import finalize_hits_bwd_plain

    vertices, tri_meta, best_tri, t, hit, o, d, cts = args
    n = o.shape[0]
    corners = vertices.double()[tri_meta[best_tri.clamp(min=0).long(), 4:7].long()]
    oo, dd = o.double(), d.double()
    meta = torch.zeros(n, 8, dtype=torch.int32, device=o.device)  # each ray its own corners
    meta[:, 4:7] = torch.arange(3 * n, dtype=torch.int32, device=o.device).reshape(n, 3)
    tri = torch.arange(n, dtype=torch.int32, device=o.device)
    cts64 = tuple(c.double() for c in cts)

    def vjp(c, o_, d_):
        out = finalize_hits_bwd_plain(c.reshape(-1, 3), meta, tri, t.double(), hit, o_, d_,
                                      cts64)
        return out[0], out[1], out[3]

    base = vjp(corners, oo, dd)
    s = (oo - corners[:, 0]).norm(dim=1)
    e1 = (corners[:, 1] - corners[:, 0]).norm(dim=1)
    e2 = (corners[:, 2] - corners[:, 0]).norm(dim=1)
    scale = {"o": s, "d": dd.norm(dim=1), 0: torch.maximum(torch.maximum(s, e1), e2), 1: e1,
             2: e2}
    h = 2.0 ** -24
    total = [torch.zeros_like(x) for x in base]
    for which, size in scale.items():
        for c in range(3):
            c2, o2, d2 = corners.clone(), oo.clone(), dd.clone()
            if which == "o":
                o2[:, c] += h * size
            elif which == "d":
                d2[:, c] += h * size
            else:
                c2[:, which, c] += h * size
            for acc, x, y in zip(total, vjp(c2, o2, d2), base):
                acc += (x - y).abs()
    return tuple(x / h for x in total)


def ray_bounds(args):
    """Each element's scale for :func:`agreement`: for d(origin),
    d(direction) and the corner cotangents, the ray's condition number x
    its largest |J|^T |g| element of that output (:func:`jacobian_mass`),
    plus its largest input sensitivity element (:func:`input_sensitivity`),
    broadcast over the ray's elements."""
    vertices, tri_meta, best_tri, _, _, _, d, _ = args
    n = d.shape[0]
    cond = condition(vertices, tri_meta, best_tri, d)
    out = []
    for m, sens in zip(jacobian_mass(args), input_sensitivity(args)):
        rows = (cond * m.reshape(n, -1).amax(1) + sens.reshape(n, -1).amax(1))[:, None]
        out.append(rows.expand(n, m.numel() // n).reshape(m.shape))
    return tuple(out)


def agreement(k, ref, args, bounds) -> dict:
    """A3's outputs ``k`` against ``ref`` (each ``(d_origin, d_direction,
    keys, d_corner)``; ``ref`` in float32 or float64) on ``args``
    (``finalize_hits_bwd``'s), the corners summed onto the vertices (``k``'s
    by the ordered scatter, ``ref``'s in float64); ``bounds`` is
    :func:`ray_bounds` of ``args``.  For each of d_origin, d_direction,
    d_corner and d_vertices: ``needed``, the least A3_TOL it passes (the
    largest |difference| over its element's bound, a vertex's being the sum
    of its corners'); ``outside``, its elements (a non-finite one among
    them) beyond A3_TOL; ``median_over_max`` (of the non-zero |ref|) and
    ``max_diff_over_max``."""
    from ..accel.scatter import scatter_add_ordered

    n_v = args[0].shape[0]

    def vertex_sum(g):
        return torch.zeros(n_v, 3, dtype=torch.float64, device=g.device).index_add_(
            0, ref[2].long(), g.double())

    pairs = {"d_origin": (k[0], ref[0], bounds[0]),
             "d_direction": (k[1], ref[1], bounds[1]),
             "d_corner": (k[3], ref[3], bounds[2]),
             "d_vertices": (scatter_add_ordered(k[2], k[3], n_v), vertex_sum(ref[3]),
                            vertex_sum(bounds[2]))}
    out = {}
    for name, (x, y, scale) in pairs.items():
        mag = y.abs().double()
        top = float(mag.max()) if mag.numel() else 0.0
        diff = (x.double() - y.double()).abs()
        nonzero = mag[mag > 0]
        ratio = torch.where(diff == 0, 0.0, diff / scale)
        out[name] = dict(
            needed=float(ratio.max()) if ratio.numel() else 0.0,
            outside=int((~(diff <= A3_TOL * scale)).sum()),
            median_over_max=float(nonzero.median()) / top if nonzero.numel() else 0.0,
            max_diff_over_max=float(diff.max()) / top if top > 0 else float(diff.max()))
    return out


def corner_errors(outs, ref, vertices, tri_meta, best_tri, d) -> dict:
    """Per-ray corner cotangents against float64 ``ref`` (A3's outputs in
    float64): for each ``name: outputs`` of ``outs``, the largest |error|
    of a corner over the largest |ref| corner, the ray and corner where it
    lies, the errors of that ray's three corners, its |ref| over the
    largest and its |det| over |e1| |e2| |d|."""
    g64 = ref[3]
    top = float(g64.abs().max())
    out = {}
    for name, x in outs.items():
        err = (x[3].double() - g64).abs().amax(dim=1)
        j = int(err.argmax())
        ray, corner = divmod(j, 3)
        iv = tri_meta[int(best_tri[ray].clamp(min=0)), 4:7].long()
        v0, v1, v2 = vertices[iv].double()
        e1, e2, dr = v1 - v0, v2 - v0, d[ray].double()
        det = torch.dot(e1, torch.linalg.cross(dr, e2))
        out[name] = dict(max_err_over_max=float(err[j]) / top, ray=ray, corner=corner,
                         ray_corners_over_max=[float(err[3 * ray + c]) / top for c in range(3)],
                         ray_g_over_max=float(g64[3 * ray:3 * ray + 3].abs().max()) / top,
                         ray_rel_det=float(det.abs() / (e1.norm() * e2.norm() * dr.norm())))
    return out


def a3_given(args):
    """The parameters of ``hare_finalize_hits_bwd`` (by the names its
    source declares) for ``args`` (``finalize_hits_bwd``'s), a ``None``
    cotangent as a null pointer, and the fresh outputs they name:
    ``(given, (d_o, d_d, keys, d_corner))``."""
    vertices, tri_meta, best_tri, t, hit, o, d, cts = args
    n = o.shape[0]
    f = dict(dtype=torch.float32, device=o.device)
    outs = (torch.empty(n, 3, **f), torch.empty(n, 3, **f),
            torch.empty(3 * n, dtype=torch.int32, device=o.device), torch.empty(3 * n, 3, **f))
    given = dict(zip(A3_PARAMS, (vertices, tri_meta, best_tri, t, hit, o, d, *cts, n, *outs)))
    return {k: v.contiguous() if isinstance(v, torch.Tensor) else v
            for k, v in given.items()}, outs


def _fault_call(fn, params, args):
    """One fault's A3 on ``args`` (``finalize_hits_bwd``'s), as the
    wrapper calls the built one."""
    from .kernel_sweep import _caller

    given, outs = a3_given(args)
    _caller(fn, params, dict(given, stream=torch.cuda.current_stream().cuda_stream))()
    return outs


def _line(label, agree) -> str:
    return f"{label}: " + "; ".join(
        f"{name} needed {r['needed']:.3e} (outside {A3_TOL}: {r['outside']}), median/max "
        f"{r['median_over_max']:.3e}, max diff/max {r['max_diff_over_max']:.3e}"
        for name, r in agree.items())


def main() -> dict:
    from ..accel import common, voxel
    from ..accel.scatter import scatter_add_ordered, scatter_add_plain
    from .bench_scene import bench_setup, bounce_rays
    from .kernel_sweep import Variant, _build, variant_source

    if not torch.cuda.is_available():
        raise RuntimeError("A3 runs on the card: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    _, sp, rays, absorption = bench_setup(dev)
    scene, n_v = sp.scene, sp.scene.vertices.shape[0]
    src = (build.CSRC / "finalize_bwd.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rec = {"device": torch.cuda.get_device_name(0), "tol": A3_TOL}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        faults = _build("hare_finalize_hits_bwd",
                        [Variant(label, variant_source(src, reps), build.CSRC, build.NVCC_FLAGS)
                         for label, reps in FAULTS], Path(tmp), "a3_fault")
        for b, r in enumerate(bounce_rays(sp, rays, absorption), 1):
            best_t, best_tri = voxel.grid_shoot(r, sp.struct)
            hr = common.finalize_hits(scene, r, best_t, best_tri)
            cts = seeded_cotangents(r.origin.shape[0], b, dev)
            args = (scene.vertices, scene.tri_meta, best_tri, hr.t, hr.hit, r.origin,
                    r.direction, cts)
            k = common.finalize_hits_bwd(*args)
            p = common.finalize_hits_bwd_plain(*args)
            p64 = common.finalize_hits_bwd_plain(
                *(x.double() if x.is_floating_point() else x for x in args[:-1]),
                tuple(g.double() for g in cts))
            bnd = ray_bounds(args)
            b_rec = rec[f"bounce{b}"] = {"built": agreement(k, p64, args, bnd),
                                         "built vs f32 plain": agreement(k, p, args, bnd)}
            for label in b_rec:
                print(_line(f"a3_check bounce {b} {label}", b_rec[label]))
            dv64 = scatter_add_plain(p64[2], p64[3], n_v)
            b_rec["vertices_vs_f64"] = {
                name: float((scatter_add_ordered(x[2], x[3], n_v).double() - dv64).abs().max())
                / float(dv64.abs().max()) for name, x in (("kernel", k), ("plain", p))}
            print(f"a3_check bounce {b} vertex sums vs float64, of the largest: " + ", ".join(
                f"{name} {e:.3e}" for name, e in b_rec["vertices_vs_f64"].items()))
            b_rec["corners_vs_f64"] = corner_errors(
                {"kernel": k, "plain": p}, p64, scene.vertices, scene.tri_meta, best_tri,
                r.direction)
            for name, c in b_rec["corners_vs_f64"].items():
                corners = ", ".join(f"{e:.3e}" for e in c["ray_corners_over_max"])
                print(f"a3_check bounce {b} corners vs float64, {name}: largest error "
                      f"{c['max_err_over_max']:.3e} of the largest, ray {c['ray']} corner "
                      f"{c['corner']} (its corners {corners}; its |g| {c['ray_g_over_max']:.3e} "
                      f"of the largest; |det| / |e1||e2||d| {c['ray_rel_det']:.3e})")
            for label, (fn, params, _) in faults.items():
                b_rec[label] = agreement(_fault_call(fn, params, args), p64, args, bnd)
                print(_line(f"a3_check bounce {b} fault '{label}'", b_rec[label]))
    print(json.dumps({"a3_check": rec}))
    return rec


if __name__ == "__main__":
    main()
