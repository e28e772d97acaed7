"""Port parity: vertex and ray gradients (the finalize backward, A3).

Mirrors ``tests/test_grad_accel.py`` (vertex gradients through every
backend, the loss under moved vertices, vertex descent on the soft
histogram) and ``tests/test_trace.py::test_grad_vertices_smooth`` on the
port: the same NumPy inputs through the JAX package (``jax.grad``) and the
port's plain versions on the CPU (``backward()``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import shoot_brute as jax_shoot_brute  # noqa: E402
from hare_tpu.accel.common import finalize_hits as jax_finalize_hits  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.common import finalize_hits  # noqa: E402
from hare_tpu_torch.convert import scene_from_numpy  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# The finalize backward on one batch: the same autograd of the same
# arithmetic, summed onto the vertices in another order (index order here,
# XLA's there); atol relative to the largest gradient.
FIN_RTOL, FIN_ATOL = 1e-5, 1e-6
# Whole traces: tests/test_grad_accel.py's tolerance.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
ROOM = (4, 5, 3)
SOURCE = (2.0, 2.5, 1.5)


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def source_rays(seed, n):
    o = np.tile(np.array([SOURCE], np.float32), (n, 1))
    return o, rand_dirs(np.random.default_rng(seed), n)


def jax_scene_np(scene):
    return {k: np.asarray(v) for k, v in scene._asdict().items()}


def test_with_vertices_matches_jax():
    """Refreshed geometry rows bit-equal to the JAX package's lanes 0-8;
    ids untouched; the empty scene keeps its rows."""
    faces = shapes.shoebox(*ROOM) + shapes.icosphere(2, radius=1.0, center=SOURCE)
    jfaces = jshapes.shoebox(*ROOM) + jshapes.icosphere(2, radius=1.0, center=SOURCE)
    js = jh.Topology.build(jfaces).scene()
    ts = th.Topology.build(faces).scene(device=CPU)
    v0 = np.asarray(js.vertices)
    rng = np.random.default_rng(3)
    v1 = (v0 * 1.02 + rng.normal(0, 1e-2, v0.shape)).astype(np.float32)
    jw = js.with_vertices(jnp.asarray(v1))
    tw = ts.with_vertices(torch.from_numpy(v1))
    want = np.ascontiguousarray(np.asarray(jw.tri_geom)[:, :9])
    assert np.array_equal(tw.tri_geom.numpy().view(np.uint32), want.view(np.uint32))
    assert not np.array_equal(tw.tri_geom.numpy(), ts.tri_geom.numpy())
    assert torch.equal(tw.tri_meta, ts.tri_meta) and torch.equal(tw.tri_v, ts.tri_v)
    assert np.array_equal(tw.vertices.numpy(), v1)
    # The same vertices give the build-time rows back.
    same = ts.with_vertices(ts.vertices)
    assert torch.equal(same.tri_geom.view(torch.int32), ts.tri_geom.view(torch.int32))
    empty = th.Topology.build([]).scene(device=CPU)
    je = jh.Topology.build([]).scene().with_vertices(np.zeros((0, 3), np.float32))
    te = empty.with_vertices(torch.zeros(0, 3))
    assert te.vertices.shape == (0, 3)
    assert torch.equal(te.tri_geom, empty.tri_geom)
    assert np.array_equal(te.tri_geom.numpy(), np.asarray(je.tri_geom)[:, :9])


@pytest.mark.parametrize("batch", ["mixed", "all misses", "zero det"])
@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_finalize_backward_matches_jax(kernel, batch):
    """A3's plain version against jax.vjp of the JAX finalize w.r.t.
    (vertices, origin, direction), with seeded cotangents for t, u, v,
    point and normal, on a room with a sphere; an eighth of the rays made
    misses (only their normal's cotangent reaches triangle 0).  Also every
    ray a miss, and an eighth of the rays made hits on a floor triangle
    that their direction lies in (det exactly 0: t, u and v give no
    gradient)."""
    n = 256
    jfaces = jshapes.shoebox(*ROOM) + jshapes.icosphere(1, radius=0.8, center=SOURCE)
    js = jh.Topology.build(jfaces).scene()
    rng = np.random.default_rng(21)
    o = rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (n, 3)).astype(np.float32)
    d = rand_dirs(rng, n)
    hr = jax_shoot_brute(js, jh.Ray.make(o, d), kernel)
    best_t = np.asarray(hr.t).copy()
    best_tri = np.asarray(hr.tri_id).copy()
    assert np.isfinite(best_t).all()
    miss = np.arange(n) % 8 == 5 if batch != "all misses" else np.ones(n, bool)
    best_t[miss], best_tri[miss] = np.inf, -1
    if batch == "zero det":
        flat = np.arange(n) % 8 == 3
        floor = int(np.nonzero(np.all(np.asarray(js.vertices)[np.asarray(js.tri_v)[:, :3]][..., 2]
                                      == 0.0, axis=1))[0][0])
        d[flat] = (0.6, 0.8, 0.0)  # in the floor's plane: d x e2 is normal to e1
        best_t[flat], best_tri[flat] = 1.0, floor
    cts = [rng.normal(size=s).astype(np.float32) for s in ((n,), (n,), (n,), (n, 3), (n, 3))]
    v0 = np.array(js.vertices)

    def jf(v, oo, dd):
        h = jax_finalize_hits(js.with_vertices(v), jh.Ray.make(oo, dd), jnp.asarray(best_t),
                              jnp.asarray(best_tri), kernel)
        return h.t, h.u, h.v, h.point, h.normal

    _, vjp = jax.vjp(jf, jnp.asarray(v0), jnp.asarray(o), jnp.asarray(d))
    # t is inf on misses: its cotangent there multiplies nothing.
    want = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]

    scene = scene_from_numpy(jax_scene_np(js), device=CPU)
    v = torch.from_numpy(v0).requires_grad_()
    ot, dt = (torch.from_numpy(x).requires_grad_() for x in (o, d))
    h = finalize_hits(scene.with_vertices(v), th.Ray.make(ot, dt), torch.from_numpy(best_t),
                      torch.from_numpy(best_tri), kernel)
    outs = (torch.where(h.hit, h.t, 0.0), h.u, h.v, h.point, h.normal)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    assert not bool(h.hit[torch.from_numpy(miss)].any())
    if batch == "all misses":
        assert not bool(h.hit.any())
    for what, got, ref in zip(("vertices", "origin", "direction"), (v.grad, ot.grad, dt.grad), want):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=FIN_RTOL, atol=FIN_ATOL * scale,
                                   err_msg=what)
    # Triangle 0's corners get the misses' normal cotangents, as in JAX.
    assert np.abs(want[0][np.asarray(js.tri_v)[0]]).max() > 0


def jax_partition(accel):
    top = jh.Topology.build(jshapes.shoebox(*ROOM))
    return jh.SpatialPartition(top, accel=accel)


def port_partition(accel):
    return th.SpatialPartition(th.Topology.build(shapes.shoebox(*ROOM)), accel=accel, device=CPU)


# The losses mask t with hit, not multiply: a ray that leaves the moved room
# (its traversal tables keep the build-time walls) has t = inf there.
def jax_t_loss(sp, o, d, bounces, what="t"):
    a = jnp.full(sp.scene.n_polys, 0.2, jnp.float32)

    def loss(verts):
        res = jh.trace_rays(sp.scene.with_vertices(verts), jh.Ray.make(o, d), a, bounces,
                            sp.shoot_fn, aux=sp.aux)
        return jnp.sum(jnp.where(res.hit, getattr(res, what), 0.0) * res.energy)

    return loss


def port_t_loss(sp, o, d, bounces, what="t"):
    a = torch.full((sp.scene.n_polys,), 0.2)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))

    def loss(verts):
        res = th.trace_rays(sp.scene.with_vertices(verts), rays, a, bounces, sp.shoot_fn,
                            aux=sp.aux)
        return torch.sum(torch.where(res.hit, getattr(res, what), 0.0) * res.energy)

    return loss


def port_grad(loss, v0):
    v = v0.clone().requires_grad_()
    loss(v).backward()
    return v.grad.numpy()


@pytest.mark.parametrize("accel", ["brute", "grid", "octree", "kdtree", "kdtree_ropes"])
def test_vertex_grads_match_jax(accel):
    """test_vertex_grads_match_brute: sum(t * energy) on hits over 2 bounces,
    d/d(vertices) through each backend, against JAX's through the same
    backend and against the port's brute force."""
    o, d = source_rays(7, 32)
    jsp = jax_partition(accel)
    g_j = np.asarray(jax.grad(jax_t_loss(jsp, o, d, 2))(jsp.scene.vertices))
    grads = {}
    for which in {accel, "brute"}:
        sp = port_partition(which)
        grads[which] = port_grad(port_t_loss(sp, o, d, 2), sp.scene.vertices)
    g = grads[accel]
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(g, grads["brute"], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("accel", ["grid", "octree", "kdtree", "kdtree_ropes"])
def test_loss_responds_to_vertices(accel):
    """test_loss_responds_to_vertices: with_vertices refreshes the rows, so
    the loss moves with the vertices, and equals JAX's moved loss."""
    o, d = source_rays(5, 64)
    jsp, sp = jax_partition(accel), port_partition(accel)
    v1 = sp.scene.vertices * 1.02
    loss = port_t_loss(sp, o, d, 2)
    with torch.no_grad():
        base, moved = float(loss(sp.scene.vertices)), float(loss(v1))
    assert moved != base
    want = float(jax_t_loss(jsp, o, d, 2)(jnp.asarray(v1.numpy())))
    np.testing.assert_allclose(moved, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_vertex_descent_reduces_loss(accel):
    """test_vertex_descent_reduces_loss: 40 Adam steps (lr 2e-2) on the soft
    histogram's MSE to the histogram of vertices x 1.03 cut the loss below
    0.2 of the first; the first loss and gradient equal JAX's."""
    o, d = source_rays(3, 128)
    n_bins, bin_dt = 64, 2e-3
    jsp, sp = jax_partition(accel), port_partition(accel)
    a_j = jnp.full(jsp.scene.n_polys, 0.2, jnp.float32)
    a = torch.full((sp.scene.n_polys,), 0.2)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))

    def jhist(verts):
        res = jh.trace_rays(jsp.scene.with_vertices(verts), jh.Ray.make(o, d), a_j, 2,
                            jsp.shoot_fn, aux=jsp.aux)
        return jh.energy_histogram(res, n_bins, bin_dt, soft=True)

    def hist(verts):
        res = th.trace_rays(sp.scene.with_vertices(verts), rays, a, 2, sp.shoot_fn, aux=sp.aux)
        return th.energy_histogram(res, n_bins, bin_dt, soft=True)

    v_build = sp.scene.vertices
    j_target = jhist(jnp.asarray(v_build.numpy()) * 1.03)
    l_j, g_j = jax.value_and_grad(lambda v: jnp.mean((jhist(v) - j_target) ** 2))(
        jnp.asarray(v_build.numpy()))
    with torch.no_grad():
        target = hist(v_build * 1.03)
    v = v_build.clone().requires_grad_()
    opt = torch.optim.Adam([v], lr=2e-2)
    losses = []
    for step in range(40):
        opt.zero_grad()
        loss = torch.mean((hist(v) - target) ** 2)
        loss.backward()
        if step == 0:
            np.testing.assert_allclose(loss.item(), float(l_j), rtol=GRAD_RTOL)
            g = v.grad.numpy()
            np.testing.assert_allclose(g, np.asarray(g_j), rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * float(np.abs(g).max()))
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])


def test_grad_vertices_smooth():
    """test_grad_vertices_smooth: d/d(vertices) of sum(time * energy * hit)
    through brute force over 2 bounces: JAX's gradient, and finite
    differences on its three largest entries (that test's tolerance)."""
    o, d = source_rays(3, 16)
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    jsc = jh.Topology.build(jshapes.shoebox(*ROOM)).scene()
    a_j = jnp.full(jsc.n_polys, 0.2, jnp.float32)

    def jloss(verts):
        res = jh.trace_rays(jsc.with_vertices(verts), jh.Ray.make(o, d), a_j, 2, jax_shoot_brute)
        return jnp.sum(res.time * res.energy * res.hit)

    a = torch.full((sc.n_polys,), 0.2)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))

    def loss(verts):
        res = th.trace_rays(sc.with_vertices(verts), rays, a, 2, th.shoot_brute)
        return torch.sum(res.time * res.energy * res.hit)

    g_j = np.asarray(jax.grad(jloss)(jsc.vertices))
    g = port_grad(loss, sc.vertices)
    assert np.isfinite(g).all() and (np.abs(g) > 0).any()
    np.testing.assert_allclose(g, g_j, rtol=GRAD_RTOL, atol=GRAD_RTOL * float(np.abs(g).max()))
    with torch.no_grad():
        f0 = float(loss(sc.vertices))
        for idx in np.argsort(np.abs(g).ravel())[-3:]:
            i, j = divmod(int(idx), 3)
            v = sc.vertices.clone()
            v[i, j] += 1e-3
            fd = (float(loss(v)) - f0) / 1e-3
            np.testing.assert_allclose(g[i, j], fd, rtol=0.08, atol=1e-5)
