"""Port parity: hare_tpu_torch's geometry layer against hare_tpu's.

The same NumPy inputs, made from a seed, go through the JAX functions (on the
CPU that conftest pins) and the port's plain PyTorch versions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu.geom as jg  # noqa: E402
from hare_tpu.accel import SpatialPartition as JSpatialPartition  # noqa: E402
from hare_tpu.geom.intersect import kernel_components as j_kernel_components  # noqa: E402
from hare_tpu.mesh import Topology as JTopology  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch.geom as tg  # noqa: E402
from hare_tpu_torch import Ray, SpatialPartition, Topology  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# f32 results of the same arithmetic in the same order; XLA and PyTorch may
# still fuse or contract differently, so values agree to a few ulps.
RTOL = 1e-5


def random_tris_rays(rng, n):
    """The generator of tests/test_geom.py: half the rays aim near the
    triangle centroid so hits are well sampled."""
    v0 = rng.uniform(-2, 2, (n, 3))
    v1 = v0 + rng.normal(0, 1, (n, 3))
    v2 = v0 + rng.normal(0, 1, (n, 3))
    origin = rng.uniform(-4, 4, (n, 3))
    direction = rng.normal(0, 1, (n, 3))
    half = n // 2
    centroid = (v0 + v1 + v2) / 3.0
    direction[:half] = (centroid[:half] - origin[:half]) + rng.normal(
        0, 0.15, (half, 3)
    )
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    return tuple(a.astype(np.float32) for a in (v0, v1, v2, origin, direction))


def split(a):
    return tuple(a[..., c] for c in range(3))


def test_math_parity(rng):
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    a[3] = 0.0  # zero vector: normalize maps it to 0 with eps = 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jg.dot, tg.dot), (jg.cross, tg.cross)):
        np.testing.assert_allclose(tf(ta, tb).numpy(), np.asarray(jf(a, b)), rtol=RTOL)
    np.testing.assert_allclose(tg.norm(ta).numpy(), np.asarray(jg.norm(a)), rtol=RTOL)
    for eps in (0.0, 1e-3):
        np.testing.assert_allclose(
            tg.normalize(ta, eps).numpy(), np.asarray(jg.normalize(a, eps)),
            rtol=RTOL, atol=1e-7,
        )
    assert not tg.normalize(ta)[3].any()


@pytest.mark.parametrize("unmasked", [False, True])
@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_kernel_components_parity(rng, kernel, unmasked):
    v0, v1, v2, o, d = random_tris_rays(rng, 500)
    tri = split(v0) + split(v1 - v0) + split(v2 - v0)
    jv = [np.asarray(x) for x in j_kernel_components(
        kernel, split(o), split(d), tuple(jnp.asarray(c) for c in tri),
        unmasked=unmasked,
    )]
    tt = [x.numpy() for x in tg.kernel_components(
        kernel, split(torch.from_numpy(o)), split(torch.from_numpy(d)),
        tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in tri),
        unmasked=unmasked,
    )]
    np.testing.assert_array_equal(tt[0], jv[0])  # valid: identical
    assert jv[0].sum() > 20
    np.testing.assert_array_equal(np.isinf(tt[1]), np.isinf(jv[1]))
    fin = np.isfinite(jv[1])
    # u, v grow like 1/det on near-parallel rays: compare them on rays whose
    # determinant is not degenerate, i.e. where t is finite.
    for a, b in zip(tt[1:], jv[1:]):
        np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=1e-5)


def test_watertight_shared_edge_no_cracks(rng):
    """Rays aimed at a shared edge hit at least one of its two triangles
    (tests/test_geom.py::test_watertight_shared_edge, on the port)."""
    a, b = np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])
    c, e = np.array([0.5, 1.0, 0.0]), np.array([0.5, -1.0, 0.0])
    n = 256
    targets = a[None] + rng.uniform(0.05, 0.95, n)[:, None] * (b - a)[None]
    o = np.array([0.3, 0.1, 3.0])[None].repeat(n, 0) + rng.normal(0, 0.2, (n, 3)) * [1, 1, 0]
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o32, d32 = o.astype(np.float32), d.astype(np.float32)

    def valid(t0, t1, t2):
        p0, p1, p2 = (np.tile(t, (n, 1)).astype(np.float32) for t in (t0, t1, t2))
        tri = split(p0) + split(p1 - p0) + split(p2 - p0)
        ours = tg.kernel_components(
            "watertight", split(torch.from_numpy(o32)), split(torch.from_numpy(d32)),
            tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in tri),
        )[0].numpy()
        ref = np.asarray(j_kernel_components(
            "watertight", split(o32), split(d32), tuple(jnp.asarray(x) for x in tri)
        )[0])
        np.testing.assert_array_equal(ours, ref)
        return ours

    hits = valid(a, b, c).astype(int) + valid(b, a, e).astype(int)
    assert np.all(hits >= 1), "crack along shared edge"


def test_ray_aabb_parity(rng):
    n = 400
    box_min = rng.uniform(-2, 0, (n, 3))
    box_max = box_min + rng.uniform(0.1, 3, (n, 3))
    o = rng.uniform(-4, 4, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d[:50, 0] = 0.0  # axis-parallel rays
    d[25:75, 1] = 0.0
    o[75:100, 0] = box_min[75:100, 0]  # origins ON a slab boundary ...
    d[75:100, 0] = 0.0  # ... parallel to it
    args = [a.astype(np.float32) for a in (o, d, box_min, box_max)]
    jh, jn, jf = (np.asarray(x) for x in jg.ray_aabb(*args))
    th, tn, tf = (x.numpy() for x in tg.ray_aabb(*map(torch.from_numpy, args)))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tn, jn)  # min/max of identical products
    np.testing.assert_array_equal(tf, jf)
    assert jh[75:100].any()


def test_tri_box_overlap_equal(rng):
    """The port's NumPy copy of the SAT gives the same bits."""
    tri = rng.uniform(-1.5, 1.5, (500, 3, 3))
    center = rng.uniform(-0.5, 0.5, (500, 3))
    half = rng.uniform(0.1, 0.8, (500, 3))
    np.testing.assert_array_equal(
        tg.tri_box_overlap(tri, center, half), jg.tri_box_overlap(tri, center, half)
    )


def test_ray_make_defaults():
    r = Ray.make(torch.zeros(4, 3), torch.ones(4, 3))
    assert r.exclude_poly.dtype == torch.int32
    assert (r.exclude_poly == tg.NO_POLY).all() and r.exclude_poly.shape == (4, 2)
    j = jg.Ray.make(np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32))
    np.testing.assert_array_equal(r.exclude_poly.numpy(), np.asarray(j.exclude_poly))


@pytest.mark.parametrize("target", ["edges", "vertices"])
def test_grid_no_cracks_parity(target):
    """tests/test_watertight.py on the port's grid: rays exactly through
    shared edges and welded vertices of a closed icosphere all hit, with the
    JAX grid's hits and distances."""
    if target == "edges":
        faces, radius = shapes.icosphere(3, radius=2.0), 2.0
        top = Topology.build(faces)
        shared = np.array([len(p) >= 2 for p in top.edge_polys])
        e = top.edges[shared]
        aim = 0.5 * (top.vertices[e[:, 0]] + top.vertices[e[:, 1]])
    else:
        faces, radius = shapes.icosphere(2, radius=1.5), 1.5
        top = Topology.build(faces)
        aim = top.vertices
    aim = aim.astype(np.float32)
    d = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    o = np.zeros_like(d)
    ours = SpatialPartition(top, accel="grid", device=CPU).shoot(
        Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    )
    jtop = JTopology.build(
        jshapes.icosphere(3, radius=2.0) if target == "edges"
        else jshapes.icosphere(2, radius=1.5)
    )
    ref = jax.tree.map(np.asarray, JSpatialPartition(jtop, accel="grid").shoot(
        jg.Ray.make(o, d)
    ))
    assert ours.hit.all(), f"{int((~ours.hit).sum())} {target} rays missed"
    np.testing.assert_array_equal(ours.hit.numpy(), ref.hit)
    np.testing.assert_allclose(ours.t.numpy(), ref.t, rtol=RTOL)
    assert (ours.t.numpy() <= radius * (1 + 1e-3)).all()
