"""Port parity: structures built from a ``Scene``, the per-topology grid
behind ``SpatialPartition.shoot(rays, top_index)``, ``det_eps`` and the
scene ``dtype``, against the JAX package on the CPU.

The same topologies (``shoebox()`` and ``icosphere(1, r=0.8)`` inside it)
and the same seeded NumPy rays go through both packages: tables bit-equal,
the filtered shoot's ``tri_id`` equal and ``t`` within ``RTOL``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import build_kdtree as j_build_kdtree  # noqa: E402
from hare_tpu.accel import build_octree as j_build_octree  # noqa: E402
from hare_tpu.accel import build_voxel_grid as j_build_voxel_grid  # noqa: E402
from hare_tpu.accel import shoot_brute as j_shoot_brute  # noqa: E402
from hare_tpu.accel.ropes import build_kdtree_ropes as j_build_ropes  # noqa: E402
from hare_tpu.geom import intersect as jx  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel import kdtree, octree, ropes, voxel  # noqa: E402
from hare_tpu_torch.geom import intersect as tx  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# The same f32 test, re-solved by two compilers: a few ulps apart.
RTOL, ATOL = 1e-5, 1e-6
N_RAYS = 512


def faces(s):
    """The room and the object in it, as two topologies."""
    return [s.shoebox(), s.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5))]


@pytest.fixture(scope="module")
def pair():
    """(JAX topologies, port topologies, JAX scene, port scene)."""
    jt = [jh.Topology.build(f) for f in faces(jshapes)]
    tt = [th.Topology.build(f) for f in faces(shapes)]
    jsc, sc = jh.build_scene(jt), th.build_scene(tt, device=CPU)
    for f in ("vertices", "tri_v", "tri_poly", "tri_top"):
        np.testing.assert_array_equal(getattr(sc, f).numpy(), np.asarray(getattr(jsc, f)),
                                      err_msg=f)
    return jt, tt, jsc, sc


@pytest.fixture(scope="module")
def rays():
    """Seeded rays from inside the room: most start outside the sphere's
    own box and enter it through a face."""
    rng = np.random.default_rng(17)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


GRID_FIELDS = ("cell_meta", "win_data", "grid_min", "voxel_size")
GRID_STATICS = ("dims", "char_step", "max_cell_wins", "n_tris")
# name -> (JAX builder, port table builder, keywords, array fields, statics)
BUILDS = {
    "octree": (j_build_octree, octree.build_octree_tables, {},
               ("node_rows", "win_data", "root_min", "root_max"),
               ("branch", "max_depth", "row_width", "max_node_need")),
    "kdtree": (j_build_kdtree, kdtree.build_kdtree_tables, {},
               ("node_rows", "win_data", "root_min", "root_max"),
               ("branch", "max_depth", "row_width", "max_node_need")),
    "ropes": (j_build_ropes, ropes.build_kdtree_ropes_tables, {},
              ("node_rows", "win_data", "root_min", "root_max"),
              ("max_depth", "char_step", "max_leaf_wins", "n_tris")),
}
for _src in ("scene", "topologies"):
    for _only in (None, 0, 1):
        BUILDS[f"grid-{_src}-only_top={_only}"] = (
            j_build_voxel_grid, voxel.build_grid_tables, dict(domain=8, only_top=_only),
            GRID_FIELDS, GRID_STATICS)
BUILDS["grid-scene-adaptive-only_top=1"] = (
    j_build_voxel_grid, voxel.build_grid_tables, dict(domain=None, only_top=1),
    GRID_FIELDS, GRID_STATICS)


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_tables_bit_equal(pair, name):
    """Every builder takes a ``Scene`` (its f32 corners widened, pad rows
    dropped) or the topologies, with and without ``only_top``, and makes
    JAX's tables from the same source bit for bit."""
    jt, tt, jsc, sc = pair
    j_build, t_build, kw, fields, statics = BUILDS[name]
    jsrc, src = (jt, tt) if "topologies" in name else (jsc, sc)
    jtab, tab = j_build(jsrc, **kw), t_build(src, **kw)
    for f in fields:
        np.testing.assert_array_equal(tab[f], np.asarray(getattr(jtab, f)), err_msg=f)
    for f in statics:
        assert tab[f] == getattr(jtab, f), f
    if kw.get("only_top") is not None:
        # Only that topology's triangles, under their global ids.
        _, ids = voxel.repack_windows(tab["win_data"])
        live = ids[..., 0] >= 0
        assert set(np.unique(ids[..., 2][live])) == {kw["only_top"]}
        want = np.nonzero(sc.tri_top.numpy() == kw["only_top"])[0]
        assert set(np.unique(ids[..., 0][live])) == set(want)


@pytest.mark.parametrize("case", ["empty topology", "out of range"])
def test_only_top_raises_for_a_topology_without_triangles(pair, case):
    """``only_top`` on a topology with no triangles raises ``ValueError``,
    as JAX's does."""
    jt, tt, _, _ = pair
    if case == "empty topology":
        jsrc, src, i = [jt[0], jh.Topology.build([])], [tt[0], th.Topology.build([])], 1
    else:
        jsrc, src, i = jt, tt, 2
    with pytest.raises(ValueError, match="no triangles"):
        j_build_voxel_grid(jsrc, domain=4, only_top=i)
    with pytest.raises(ValueError, match="no triangles"):
        voxel.build_grid_tables(src, domain=4, only_top=i)
    with pytest.raises(ValueError, match="no triangles"):
        voxel.build_voxel_grid(src, domain=4, only_top=i, device=CPU)


@pytest.mark.parametrize("top_index", [0, 1, 5])
def test_filtered_shoot_walks_a_cached_per_topology_grid(pair, rays, top_index):
    """``SpatialPartition.shoot(rays, top_index)`` on a two-topology grid
    builds the per-topology grid once, caches it, and answers as JAX does
    (``tri_id`` equal, ``t`` within RTOL / ATOL) and as the combined grid's
    test-time filter does; an out-of-range index caches None and misses on
    every ray.  JAX's answer for the sphere is its facade's per-topology
    grid; for the room and the missing topology it is JAX's brute force
    with the same ``top_index`` (the referee of JAX's own per-topology test,
    ``tests/test_voxel.py``): each JAX grid shoot compiles for about 13 s
    on the CPU."""
    jt, tt, jsc, _ = pair
    o, d = rays
    sp = th.SpatialPartition(tt, accel="grid", domain=8, device=CPU)
    jrays = jh.Ray.make(jnp.asarray(o), jnp.asarray(d))
    if top_index == 1:
        jsp = jh.SpatialPartition(jt, accel="grid", domain=8)
        want = jsp.shoot(jrays, top_index=top_index)
        assert top_index in jsp._top_grids
    else:
        want = j_shoot_brute(jsc, jrays, top_index=top_index)
    want = jax.tree.map(np.asarray, want)
    trays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    got = sp.shoot(trays, top_index)
    np.testing.assert_array_equal(got.hit.numpy(), want.hit)
    np.testing.assert_array_equal(got.tri_id.numpy(), want.tri_id)
    np.testing.assert_array_equal(got.poly_id.numpy(), want.poly_id)
    hit = want.hit
    np.testing.assert_allclose(got.t.numpy()[hit], want.t[hit], rtol=RTOL, atol=ATOL)

    assert set(sp._top_grids) == {top_index}
    grid = sp._top_grids[top_index]
    combined = voxel.grid_shoot(trays, sp.struct, top_index=top_index)
    if top_index == 5:
        assert grid is None and not bool(got.hit.any())
        assert not bool(torch.isfinite(combined[0]).any())
        return
    # Every ray hits the closed room; some rays hit the sphere.
    assert int(got.hit.sum()) == N_RAYS if top_index == 0 else 0 < int(got.hit.sum()) < N_RAYS
    # The per-topology grid: that topology's box, and its rows alone.
    assert tuple(grid.dims) == (8, 8, 8) and grid.cell_meta.device.type == CPU
    live = grid.win_ids[..., 0] >= 0
    assert set(grid.win_ids[..., 2][live].tolist()) == {top_index}
    box = tt[top_index].vertices
    np.testing.assert_allclose(grid.grid_min.numpy(), box.min(0) - 1e-3, rtol=1e-6)
    # K1 on it equals K1 on the combined grid with the test-time filter:
    # the same rows of that topology, the same test.
    mine = voxel.grid_shoot(trays, grid)
    assert torch.equal(mine[1], got.tri_id) and torch.equal(mine[1], combined[1])
    torch.testing.assert_close(mine[0], combined[0], rtol=RTOL, atol=0.0)
    # A second call builds nothing and gives the same answer.
    again = sp.shoot(trays, top_index)
    assert sp._top_grids[top_index] is grid
    assert torch.equal(again.tri_id, got.tri_id) and torch.equal(again.t, got.t)


def near_edge_on(rng, n):
    """Triangles of sizes 10^-4.5 to 1 and rays nearly in their planes: each
    ray crosses the plane at a point near the triangle (barycentrics in
    [-0.2, 1.2]) after a length in [0.5, 3], at a slope 10^-8 to 10^-1 off
    the plane, so |det| spans about 1e-16 to 1e-1 around both cutoffs."""
    scale = 10.0 ** rng.uniform(-4.5, 0.0, (n, 1))
    v0 = rng.uniform(-1, 1, (n, 3))
    e1, e2 = rng.normal(0, 1, (n, 3)) * scale, rng.normal(0, 1, (n, 3)) * scale
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    p = rng.normal(0, 1, (n, 3))
    p -= np.sum(p * nrm, axis=1, keepdims=True) * nrm
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    slope = 10.0 ** rng.uniform(-8, -1, (n, 1)) * rng.choice([-1.0, 1.0], (n, 1))
    d = p + slope * nrm
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    b = rng.uniform(-0.2, 1.2, (n, 2))
    target = v0 + b[:, :1] * e1 + b[:, 1:] * e2
    o = target - rng.uniform(0.5, 3.0, (n, 1)) * d
    return tuple(a.astype(np.float32) for a in (v0, v0 + e1, v0 + e2, o, d))


def _split(a):
    return tuple(a[..., c] for c in range(3))


def _components(fns, kernel, v0, v1, v2, o, d, **kw):
    tri = _split(v0) + _split(v1 - v0) + _split(v2 - v0)
    return fns.kernel_components(kernel, _split(o), _split(d), tri, **kw)


# name -> (call on a module (JAX's or the port's) and arrays, kernel)
DET_CALLS = {
    "kernel_components-mt": (lambda m, a, **kw: _components(m, "mt", *a, **kw), "mt"),
    "kernel_components-watertight": (
        lambda m, a, **kw: _components(m, "watertight", *a, **kw), "watertight"),
    "ray_triangle_mt": (lambda m, a, **kw: m.ray_triangle_mt(*a[3:], *a[:3], **kw), "mt"),
    "ray_triangle_watertight": (
        lambda m, a, **kw: m.ray_triangle_watertight(*a[3:], *a[:3], **kw), "watertight"),
}


@pytest.mark.parametrize("det_eps", [None, 0.0, 1e-12, 1e-6])
@pytest.mark.parametrize("call", sorted(DET_CALLS))
def test_det_eps(call, det_eps):
    """``det_eps`` with JAX's defaults (None -> ``DET_EPS`` for MT, 0 for
    watertight; ``ray_triangle_mt`` ``DET_EPS``, ``ray_triangle_watertight``
    0) and meaning: the same ``valid`` and ``t`` as JAX on near-edge-on
    triangles, where the cutoff decides."""
    fn, kernel = DET_CALLS[call]
    arrays = near_edge_on(np.random.default_rng(29), 2000)
    kw = {} if det_eps is None else dict(det_eps=det_eps)
    jv = [np.asarray(x) for x in fn(jx, [jnp.asarray(a) for a in arrays], **kw)]
    tv = [x.numpy() for x in fn(tx, [torch.from_numpy(a) for a in arrays], **kw)]
    np.testing.assert_array_equal(tv[0], jv[0])
    np.testing.assert_array_equal(np.isinf(tv[1]), np.isinf(jv[1]))
    fin = np.isfinite(jv[1])
    np.testing.assert_allclose(tv[1][fin], jv[1][fin], rtol=RTOL)
    # The cutoff in force rejects in-bounds rays that a zero cutoff keeps.
    eps = det_eps if det_eps is not None else (tx.DET_EPS if kernel == "mt" else 0.0)
    zero = fn(tx, [torch.from_numpy(a) for a in arrays], det_eps=0.0)[0].numpy()
    assert 100 < int(zero.sum()) < len(zero)
    assert (int((zero & ~tv[0]).sum()) > 0) == (eps > 0), eps
    assert not bool((tv[0] & ~zero).any())


@pytest.mark.parametrize("make", ["Topology.scene", "build_scene"])
def test_scene_dtype(pair, make):
    """``dtype`` float32 (numpy's or torch's) is the default and changes
    nothing; ``top_index`` and ``n_topologies`` are accepted and ignored, as
    JAX's ``Topology.scene`` ignores them; any other dtype raises, since
    the kernels read f32 scenes (JAX, never in x64, makes f32 arrays for
    ``np.float64`` too)."""
    jt, tt, _, _ = pair
    top = tt[1]
    if make == "Topology.scene":
        base = top.scene(device=CPU)
        same = [top.scene(dtype=np.float32, top_index=3, n_topologies=2, device=CPU),
                top.scene(np.float32, 128, 3, 2, device=CPU),
                top.scene(dtype=torch.float32, device=CPU)]

        def other(dtype):
            return top.scene(dtype=dtype, device=CPU)
        jbase = jt[1].scene(dtype=np.float32, top_index=3, n_topologies=2)
    else:
        base = th.build_scene([top], device=CPU)
        same = [th.build_scene([top], np.float32, 128, device=CPU),
                th.build_scene([top], dtype="float32", device=CPU)]

        def other(dtype):
            return th.build_scene([top], dtype=dtype, device=CPU)
        jbase = jh.build_scene([jt[1]], dtype=np.float32)
    for sc in same:
        for f in base._fields:
            assert torch.equal(getattr(sc, f), getattr(base, f)), f
    np.testing.assert_array_equal(base.vertices.numpy(), np.asarray(jbase.vertices))
    assert base.vertices.dtype == torch.float32 and jbase.vertices.dtype == jnp.float32
    for dtype in (np.float64, torch.float64, np.float16):
        with pytest.raises(ValueError, match="float32"):
            other(dtype)
