"""Port parity: hare_tpu_torch's host builders and grid shoot against hare_tpu's.

Host tables (topology, scene, grid) must be bit-equal.  Shoots run the JAX
``shoot_grid`` and the port's plain version on identical tables (handed over
as NumPy through ``hare_tpu_torch.convert``) and identical rays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import build_voxel_grid as j_build_voxel_grid  # noqa: E402
from hare_tpu.accel import shoot_grid as j_shoot_grid  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.voxel import build_grid_tables, grid_shoot, shoot_grid  # noqa: E402
from hare_tpu_torch.convert import grid_from_numpy, scene_from_numpy  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# Same nearest hit, re-solved in f32 by two compilers: a few ulps apart.
RTOL = ATOL = 1e-5
# Rays whose tri_id differs while both t agree (an equal-t tie between two
# triangles, resolved on last-ulp differences) may be at most this share.
MAX_TIE_SHARE = 1e-3

SCENES = {
    "shoebox": (lambda s: s.shoebox(4, 5, 3), dict(domain=4)),
    "icosphere": (lambda s: s.icosphere(2), dict(domain=8)),
    "soup": (lambda s: s.random_soup(300, seed=11), dict(domain=None, avg_polys=8.0)),
    "concert_hall": (lambda s: s.concert_hall(), dict(domain=None)),
}


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _grouped(g):
    return (g.values, g.start)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_tables_bit_equal(name):
    """Topology.build + build_scene + the grid build make the JAX arrays."""
    make, grid_kw = SCENES[name]
    jt, tt = jh.Topology.build(make(jshapes)), th.Topology.build(make(shapes))
    for f in ("vertices", "tri_v", "tri_poly", "poly_plane", "planes", "edges",
              "poly_normal", "poly_centroid", "poly_area", "poly_convex",
              "poly_degenerate", "vertex_normals", "bbox_min", "bbox_max"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    for f in ("poly_verts", "plane_members", "edge_polys", "edge_tributary_area",
              "edge_tributary_length", "edge_tangents", "poly_edges", "vertex_polys"):
        for a, b in zip(_grouped(getattr(tt, f)), _grouped(getattr(jt, f))):
            np.testing.assert_array_equal(a, b, err_msg=f)

    js, ts = jt.scene(), tt.scene(device=CPU)
    for f in ("vertices", "tri_v", "tri_poly", "tri_top", "poly_plane",
              "tri_edge_poly", "tri_meta"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    jgeom = np.asarray(js.tri_geom)
    np.testing.assert_array_equal(ts.tri_geom.numpy(), jgeom[:, :9])
    np.testing.assert_array_equal(ts.tri_meta.numpy()[:, :7], jgeom[:, 9:].view(np.int32))

    jgrid = j_build_voxel_grid(jt, **grid_kw)
    tab = build_grid_tables(tt, **grid_kw)
    for f in ("cell_meta", "win_data", "grid_min", "voxel_size"):
        np.testing.assert_array_equal(tab[f], np.asarray(getattr(jgrid, f)), err_msg=f)
    for f in ("dims", "char_step", "max_cell_wins", "n_tris"):
        assert tab[f] == getattr(jgrid, f), f

    # The tri-major repack keeps every row's triangles, order and ids.
    g = th.accel.build_voxel_grid(tt, device=CPU, **grid_kw)
    win = g.win_geom.shape[1]
    wd = tab["win_data"]
    np.testing.assert_array_equal(
        g.win_geom.numpy()[..., :9].transpose(0, 2, 1).reshape(len(wd), 9 * win),
        wd[:, : 9 * win],
    )
    np.testing.assert_array_equal(
        g.win_ids.numpy()[..., :3].transpose(0, 2, 1).reshape(len(wd), 3 * win),
        wd.view(np.int32)[:, 9 * win :],
    )
    assert not g.win_geom[..., 9:].any() and not g.win_ids[..., 3].any()


def _tables(faces_fn, grid_kw):
    top = jh.Topology.build(faces_fn(jshapes))
    jsc = top.scene()
    jgrid = j_build_voxel_grid(top, **grid_kw)
    tsc = scene_from_numpy({k: np.asarray(v) for k, v in jsc._asdict().items()}, device=CPU)
    tgrid = grid_from_numpy(
        {k: np.asarray(getattr(jgrid, k)) for k in ("cell_meta", "win_data", "grid_min", "voxel_size")},
        jgrid.dims, jgrid.char_step, jgrid.max_cell_wins, jgrid.n_tris, device=CPU,
    )
    return jsc, jgrid, tsc, tgrid


@pytest.fixture(scope="module")
def shoebox_tables():
    return _tables(lambda s: s.shoebox(4, 5, 3), dict(domain=4))


@pytest.fixture(scope="module")
def icosphere_tables():
    return _tables(lambda s: s.icosphere(2), dict(domain=8))


@pytest.fixture(scope="module")
def soup_tables():
    return _tables(lambda s: s.random_soup(300, seed=11), dict(domain=None, avg_polys=8.0))


def compare_shoot(tables, o, d, ex=None, kernel="watertight", top_index=None):
    """JAX shoot_grid vs the port's plain shoot on identical tables."""
    jsc, jgrid, tsc, tgrid = tables
    o, d = o.astype(np.float32), d.astype(np.float32)
    jr = jh.Ray.make(o, d, ex)
    hj = jax.tree.map(np.asarray, j_shoot_grid(jsc, jr, jgrid, kernel=kernel, top_index=top_index))
    tr = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d),
                     None if ex is None else torch.from_numpy(np.asarray(ex, np.int32)))
    ht = shoot_grid(tsc, tr, tgrid, kernel=kernel, top_index=top_index)
    ht = ht._replace(edge_nbr=None)
    ht = type(ht)(*(None if x is None else x.numpy() for x in ht))

    np.testing.assert_array_equal(ht.hit, hj.hit)
    h = hj.hit
    np.testing.assert_allclose(ht.t[h], hj.t[h], rtol=RTOL, atol=ATOL)
    same = ht.tri_id == hj.tri_id
    ties = ~same & h
    assert np.allclose(ht.t[ties], hj.t[ties], rtol=RTOL, atol=ATOL)
    assert ties.sum() <= MAX_TIE_SHARE * len(h), f"{ties.sum()} tie flips"
    both = same & h
    for f in ("u", "v", "point", "normal"):
        np.testing.assert_allclose(getattr(ht, f)[both], getattr(hj, f)[both],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(ht.poly_id[both], hj.poly_id[both])
    return hj, ht


def test_shoot_grid_parity_shoebox(shoebox_tables, rng):
    o = rng.uniform((0.2, 0.2, 0.2), (3.8, 4.8, 2.8), (300, 3))
    hj, _ = compare_shoot(shoebox_tables, o, rand_dirs(rng, 300))
    assert hj.hit.all()


def test_shoot_grid_parity_outside_rays(icosphere_tables, rng):
    """Rays from outside the grid enter at the clipped entry point."""
    o = rng.uniform(-4, 4, (200, 3))
    o[np.linalg.norm(o, axis=1) < 1.5] *= 3.0
    d = -o + rng.normal(0, 0.3, (200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hj, _ = compare_shoot(icosphere_tables, o, d)
    assert hj.hit.sum() > 50


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_shoot_grid_parity_soup(soup_tables, rng, kernel):
    o = rng.uniform(-1, 11, (300, 3))
    hj, _ = compare_shoot(soup_tables, o, rand_dirs(rng, 300), kernel=kernel)
    assert hj.hit.sum() > 50


def test_shoot_grid_parity_exclusion(shoebox_tables, rng):
    """First shoot without exclusion, then exclude each ray's hit polygon
    (300 rays, as above, so JAX reuses its compiled shoot)."""
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (300, 3))
    d = rand_dirs(rng, 300)
    hj0, _ = compare_shoot(shoebox_tables, o, d)
    ex = np.stack([hj0.poly_id, np.full(300, -1)], axis=1).astype(np.int32)
    _, ht = compare_shoot(shoebox_tables, o, d, ex=ex)
    assert (ht.poly_id[ht.hit] != ex[ht.hit, 0]).all()


def test_top_index_parity(rng):
    """A topology filter on a two-topology model: the port's test-time
    filter answers as the JAX facade's per-topology grid does (for the
    sphere; each JAX top_index compiles its own shoot, so one is checked)."""
    faces = [lambda s: s.shoebox(), lambda s: s.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5))]
    jsp = jh.SpatialPartition([jh.Topology.build(f(jshapes)) for f in faces], domain=8)
    tsp = th.SpatialPartition([th.Topology.build(f(shapes)) for f in faces], domain=8, device=CPU)
    o = rng.uniform((0.5, 0.5, 0.5), (3.5, 4.5, 2.5), (100, 3)).astype(np.float32)
    d = rand_dirs(rng, 100).astype(np.float32)
    for ti in (1,):
        hj = jax.tree.map(np.asarray, jsp.shoot(jh.Ray.make(o, d), top_index=ti))
        ht = tsp.shoot(th.Ray.make(torch.from_numpy(o), torch.from_numpy(d)), top_index=ti)
        np.testing.assert_array_equal(ht.hit.numpy(), hj.hit)
        np.testing.assert_allclose(ht.t.numpy()[hj.hit], hj.t[hj.hit], rtol=RTOL)
        np.testing.assert_array_equal(ht.poly_id.numpy(), hj.poly_id)


def test_grid_shoot_misses_and_degenerate_rays(shoebox_tables):
    """Rays that miss the grid box, and a zero direction, return (inf, -1)."""
    _, _, _, tgrid = shoebox_tables
    o = torch.tensor([[10.0, 10.0, 10.0], [2.0, 2.0, 1.0], [-1.0, 2.0, 1.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    best_t, best_tri = grid_shoot(th.Ray.make(o, d), tgrid)
    assert torch.isinf(best_t).all() and (best_tri == -1).all()


def test_grid_boundary_origin_parallel_ray():
    """tests/test_voxel.py::test_grid_boundary_origin_parallel_ray on the
    port: an origin exactly ON the grid's min-x face (pad=0), moving
    parallel to it from outside, still finds the y=0 wall at t = 1."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    sp = th.SpatialPartition(top, domain=4, pad=0.0, device=CPU)
    assert sp.struct.grid_min[0].item() == 0.0
    hr = sp.shoot(th.Ray.make(torch.tensor([[0.0, -1.0, 1.5]]), torch.tensor([[0.0, 1.0, 0.0]])))
    assert bool(hr.hit[0])
    np.testing.assert_allclose(hr.t.numpy()[0], 1.0, rtol=1e-5)
