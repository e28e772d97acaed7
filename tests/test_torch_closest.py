"""Port parity: the proximity queries, the leftover geometry and the topology
extras against the JAX package.

Mirrors ``tests/test_closest.py``, ``tests/test_geom.py::test_math_ops`` and
``::test_is_coplanar``, and ``tests/test_mesh.py::test_multi_topology_packing``,
``::test_set_vertex`` and ``::test_device_aux_arrays``: the same NumPy
inputs, made from a seed, go through the JAX functions (on the CPU that
conftest pins) and the port's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu.geom as jg  # noqa: E402
from hare_tpu.mesh import Topology as JTopology  # noqa: E402
from hare_tpu.mesh import build_scene as j_build_scene  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch.geom as tg  # noqa: E402
from hare_tpu_torch.convert import scene_from_numpy  # noqa: E402
from hare_tpu_torch.mesh import EdgeAux, Topology, merge_topologies, shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run on the CPU.
CPU = "cpu"

# f32 values of the same operations in the same order; XLA and PyTorch may
# contract or fuse otherwise, so a few ulps of the inputs' scale (~1-4).
RTOL, ATOL = 1e-5, 1e-5
# Gradients: each within GRAD_RTOL of the largest gradient of the batch.
GRAD_RTOL = 1e-5

# The seven Voronoi regions of tests/test_closest.py's triangle.
TRI = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
REGION_POINTS = np.array([
    [-1.0, -1.0, 0.5],  # vertex a
    [3.0, -0.5, -0.2],  # vertex b
    [-0.5, 3.0, 1.0],  # vertex c
    [1.0, -1.0, 0.3],  # edge ab
    [-1.0, 1.0, 0.3],  # edge ac
    [2.0, 2.0, 0.3],  # edge bc
    [0.4, 0.4, 0.7],  # interior
], np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(port, jax_out, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_out), rtol=rtol, atol=atol)


def triangle_cases(rng):
    """``name -> (p, a, b, c)``: the region points, a random batch, and
    degenerate triangles (a point, a segment) that the ``safe_div`` guard
    keeps finite."""
    tri = rng.normal(0, 1, (200, 3, 3)).astype(np.float32)
    p = rng.normal(0, 2, (200, 3)).astype(np.float32)
    deg = np.repeat(rng.normal(0, 1, (40, 1, 3)), 3, axis=1).astype(np.float32)
    seg = deg.copy()
    seg[:, 1] += 1.0
    seg[:, 2] = 0.5 * (seg[:, 0] + seg[:, 1])
    q = rng.normal(0, 2, (40, 3)).astype(np.float32)
    n = len(REGION_POINTS)
    return {
        "regions": (REGION_POINTS, *(np.repeat(TRI[None, k], n, 0) for k in range(3))),
        "random": (p, tri[:, 0], tri[:, 1], tri[:, 2]),
        "point": (q, deg[:, 0], deg[:, 1], deg[:, 2]),
        "segment": (q, seg[:, 0], seg[:, 1], seg[:, 2]),
    }


@pytest.mark.parametrize("case", ["regions", "random", "point", "segment"])
def test_closest_point_triangle_matches_jax(rng, case):
    """Values and gradients (of a seeded weighting of the closest point)
    w.r.t. p, a, b, c; the degenerate triangles' gradients stay finite."""
    args = triangle_cases(rng)[case]
    w = rng.normal(size=args[0].shape).astype(np.float32)
    targs = [t(x).requires_grad_() for x in args]
    out = tg.closest_point_triangle(*targs)
    (out * t(w)).sum().backward()

    def f(*xs):
        return jnp.sum(jg.closest_point_triangle(*xs) * w)

    jout = jg.closest_point_triangle(*map(jnp.asarray, args))
    jgrads = jax.grad(f, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    close(out, jout)
    for x, g in zip(targs, jgrads):
        assert bool(torch.isfinite(x.grad).all())
        scale = max(float(np.abs(np.asarray(g)).max()), 1.0)
        close(x.grad, g, rtol=0, atol=GRAD_RTOL * scale)


def test_closest_point_triangle_regions_exact():
    """The region points land where tests/test_closest.py's dense oracle
    puts them (exact here: a vertex, an edge point or the projection)."""
    q = tg.closest_point_triangle(*(t(x) for x in (REGION_POINTS, TRI[0], TRI[1], TRI[2])))
    want = np.array([[0, 0, 0], [2, 0, 0], [0, 2, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                     [0.4, 0.4, 0]], np.float32)
    np.testing.assert_allclose(q.numpy(), want, atol=1e-6)


def test_segment_aabb_plane_queries_match_jax(rng):
    p = rng.normal(0, 3, (64, 3)).astype(np.float32)
    a = rng.normal(0, 1, (64, 3)).astype(np.float32)
    b = a + rng.normal(0, 1, (64, 3)).astype(np.float32)
    b[:4] = a[:4]  # zero-length segments
    close(tg.closest_point_segment(t(p), t(a), t(b)),
          jg.closest_point_segment(*map(jnp.asarray, (p, a, b))))
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    close(tg.closest_point_aabb(t(p), t(lo), t(hi)),
          jg.closest_point_aabb(*map(jnp.asarray, (p, lo, hi))), rtol=0, atol=0)
    n = rng.normal(0, 2, (64, 3)).astype(np.float32)
    n[:3] = 0.0  # zero normals: distance 0, the point itself
    d = rng.normal(0, 1, 64).astype(np.float32)
    close(tg.dist_to_plane(t(p), t(n), t(d)), jg.dist_to_plane(*map(jnp.asarray, (p, n, d))))
    close(tg.closest_point_plane(t(p), t(n), t(d)),
          jg.closest_point_plane(*map(jnp.asarray, (p, n, d))))
    np.testing.assert_array_equal(tg.ray_side(t(p), t(n)).numpy(),
                                  np.asarray(jg.ray_side(jnp.asarray(p), jnp.asarray(n))))
    # tests/test_closest.py's fixed cases.
    assert abs(float(tg.dist_to_plane(t(np.float32([1, 2, 5])), t(np.float32([0, 0, 2])),
                                      torch.tensor(4.0))) - 3.0) < 1e-6


@pytest.mark.parametrize("k", [3, 4])
def test_sq_distance_to_edges_matches_jax(rng, k):
    pts = rng.normal(0, 1, (50, k, 3)).astype(np.float32)
    p = rng.normal(0, 2, (50, 3)).astype(np.float32)
    close(tg.sq_distance_to_edges(t(p), t(pts)),
          jg.sq_distance_to_edges(jnp.asarray(p), jnp.asarray(pts)))
    # The closing edge (2, 0), which the reference's % (n - 1) skips.
    tri = t(np.float32([[0, 0, 0], [2, 0, 0], [0, 2, 0]]))
    assert abs(float(tg.sq_distance_to_edges(t(np.float32([-1, 1, 0])), tri)) - 1.0) < 1e-6


def test_math_ops_match_jax(rng):
    """tests/test_geom.py::test_math_ops and ::test_is_coplanar on the port,
    held against the JAX functions."""
    a, b, c = (rng.normal(size=(16, 3)).astype(np.float32) for _ in range(3))
    close(tg.scalar_triple(t(a), t(b), t(c)), jg.scalar_triple(*map(jnp.asarray, (a, b, c))))
    close(tg.distance(t(a), t(b)), jg.distance(jnp.asarray(a), jnp.asarray(b)))
    sq = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    bent = sq.copy()
    bent[3, 2] = 0.5
    polys = np.concatenate([np.stack([sq, bent]), rng.normal(size=(30, 4, 3)).astype(np.float32)])
    for tol in (1e-6, 1e-2):
        got = tg.is_coplanar(t(polys), tol).numpy()
        np.testing.assert_array_equal(got, np.asarray(jg.is_coplanar(jnp.asarray(polys), tol)))
        assert got[0] and not got[1]


def test_primitives_match_jax(rng):
    o = rng.normal(size=(8, 3)).astype(np.float32)
    d = rng.normal(size=(8, 3)).astype(np.float32)
    s = rng.uniform(0, 5, 8).astype(np.float32)
    jr, tr = jg.Ray.make(o, d), tg.Ray.make(t(o), t(d))
    close(tr.at(t(s)), jr.at(jnp.asarray(s)), rtol=0, atol=0)
    rev = tr.reverse()
    np.testing.assert_array_equal(rev.direction.numpy(), np.asarray(jr.reverse().direction))
    np.testing.assert_array_equal(tr.direction.numpy(), d)  # the batch stays as it was
    jm, tm = jg.HitRecord.miss((2, 3)), tg.HitRecord.miss((2, 3), device=CPU)
    for f in jm._fields:
        x, y = getattr(tm, f), np.asarray(getattr(jm, f))
        assert x.shape == y.shape and str(x.dtype)[6:] == str(y.dtype), f
        np.testing.assert_array_equal(x.numpy(), y, err_msg=f)
    lo = rng.uniform(-1, 0, (5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (5, 3)).astype(np.float32)
    jb, tb = jg.AABB(jnp.asarray(lo), jnp.asarray(hi)), tg.AABB(t(lo), t(hi))
    for f in ("center", "width", "half_width"):
        close(getattr(tb, f), getattr(jb, f), rtol=0, atol=0)
    p = rng.uniform(-1, 2, (5, 3)).astype(np.float32)
    p[0] = lo[0]  # inclusive bounds
    np.testing.assert_array_equal(tb.contains(t(p)).numpy(), np.asarray(jb.contains(jnp.asarray(p))))


def test_poly_box_overlap_area_matches_jax(rng):
    """Bit-equal to the JAX package's NumPy clip on random convex polygons
    and boxes, and tests/test_closest.py's fixed cases."""
    for _ in range(40):
        k = rng.integers(3, 7)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        poly = np.stack([np.cos(ang), np.sin(ang), np.zeros(k)], 1) * rng.uniform(0.5, 2)
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        poly = poly @ rot.T + rng.normal(size=3)
        lo = rng.normal(size=3) - rng.uniform(0, 1, 3)
        hi = lo + rng.uniform(0.2, 3, 3)
        assert tg.poly_box_overlap_area(poly, lo, hi) == jg.poly_box_overlap_area(poly, lo, hi)
    sq = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], float)
    assert abs(tg.poly_box_overlap_area(sq, [0.5, -5, -1], [5, 5, 1]) - 0.5) < 1e-12
    assert tg.poly_box_overlap_area(sq, [2, 2, -1], [3, 3, 1]) == 0.0


@pytest.fixture(scope="module")
def tops():
    """(JAX, port) topologies of tests/test_closest.py's two quads and of the
    shoebox."""
    faces = [
        np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]], float),
        np.array([[5, 0, 0], [7, 0, 0], [5.5, 0.5, 0], [5, 2, 0]], float),
    ]
    return {"quads": (JTopology.build(faces), Topology.build(faces)),
            "room": (JTopology.build(jshapes.shoebox()), Topology.build(shapes.shoebox()))}


@pytest.mark.parametrize("name", ["quads", "room"])
def test_topology_queries_match_jax(tops, rng, name):
    """polygon_area, polygon_centroid and dist_to_plane bit-equal to JAX's
    (the same NumPy); closest_point bit-equal too (both f32 through the
    same region chain: the inputs here are exact)."""
    jt, tt = tops[name]
    pts = np.round(rng.uniform(-2, 8, (6, 3)), 1)
    for pid in range(jt.n_polys):
        assert tt.polygon_area(pid) == jt.polygon_area(pid)
        np.testing.assert_array_equal(tt.polygon_centroid(pid), jt.polygon_centroid(pid))
        for p in pts:
            assert tt.dist_to_plane(p, pid) == jt.dist_to_plane(p, pid)
            np.testing.assert_array_equal(tt.closest_point(p, pid), jt.closest_point(p, pid))
    if name == "quads":
        np.testing.assert_allclose(tt.closest_point([5.0, 5.0, 1.0], 0), [2, 2, 0], atol=1e-6)


def test_poly_frames_and_set_vertex_match_jax(tops):
    for jt, tt in tops.values():
        np.testing.assert_array_equal(tt.poly_frames(), jt.poly_frames())
    jt, tt = JTopology.build(jshapes.shoebox()), Topology.build(shapes.shoebox())
    for top in (jt, tt):
        top.set_vertex(0, (0.5, 0.5, 0.5))
    np.testing.assert_array_equal(tt.vertices, jt.vertices)
    np.testing.assert_allclose(tt.vertices[0], [0.5, 0.5, 0.5])


@pytest.mark.parametrize("faces", ["room", "hall"])
def test_device_aux_matches_jax(faces):
    """Every EdgeAux field bit-equal to the JAX package's, on the device
    asked for; tests/test_mesh.py::test_device_aux_arrays's invariants."""
    make = {"room": lambda s: s.shoebox(), "hall": lambda s: s.concert_hall()}[faces]
    jt, tt = JTopology.build(make(jshapes)), Topology.build(make(shapes))
    ja, ta = jt.device_aux(), tt.device_aux(device=CPU)
    assert isinstance(ta, EdgeAux) and ta._fields == ja._fields
    for f in ja._fields:
        x, y = getattr(ta, f), np.asarray(getattr(ja, f))
        assert x.device.type == CPU and str(x.dtype)[6:] == str(y.dtype), f
        np.testing.assert_array_equal(x.numpy(), y, err_msg=f)
    np.testing.assert_allclose(ta.edge_tributary_area.sum().item(), tt.poly_area.sum(), rtol=1e-5)
    fr = ta.poly_frame.numpy()
    eye = np.einsum("pij,pkj->pik", fr, fr)
    ok = ~tt.poly_degenerate
    np.testing.assert_allclose(eye[ok], np.broadcast_to(np.eye(3), eye[ok].shape), atol=1e-6)


def test_merge_topologies_matches_jax():
    """tests/test_mesh.py::test_multi_topology_packing: every Scene table of
    two packed topologies bit-equal to the JAX package's."""
    jt = [JTopology.build(jshapes.shoebox()), JTopology.build(
        jshapes.icosphere(0, radius=0.5, center=(2, 2, 1)))]
    tt = [Topology.build(shapes.shoebox()), Topology.build(
        shapes.icosphere(0, radius=0.5, center=(2, 2, 1)))]
    sc = merge_topologies(tt, device=CPU)
    want = scene_from_numpy({k: np.asarray(v) for k, v in j_build_scene(jt)._asdict().items()},
                            device=CPU)
    for f in sc._fields:
        np.testing.assert_array_equal(getattr(sc, f).numpy(), getattr(want, f).numpy(), err_msg=f)
    tt_ = sc.tri_top.numpy()
    assert set(tt_[: tt[0].n_tris + tt[1].n_tris].tolist()) == {0, 1}
    assert int(sc.tri_poly[tt[0].n_tris]) == tt[0].n_polys
