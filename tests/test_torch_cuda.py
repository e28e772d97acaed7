"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped on hosts without an NVIDIA GPU.  The machine with the
card has no JAX, so run these without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.brute import brute_shoot, brute_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.common import (  # noqa: E402
    finalize_hits,
    finalize_hits_bwd,
    finalize_hits_bwd_plain,
    finalize_hits_plain,
)
from hare_tpu_torch.accel.kdtree import build_kdtree  # noqa: E402
from hare_tpu_torch.accel.octree import build_octree  # noqa: E402
from hare_tpu_torch.accel.ropes import build_kdtree_ropes, ropes_shoot, ropes_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.scatter import (  # noqa: E402
    CHUNK,
    pass2_plan,
    scatter_add_ordered,
    scatter_add_plain,
    scratch_words,
)
from hare_tpu_torch.accel.tree import tree_shoot, tree_shoot_plain  # noqa: E402
from hare_tpu_torch.accel import voxel  # noqa: E402
from hare_tpu_torch.accel.voxel import build_voxel_grid, grid_shoot, grid_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import a3_check  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe as probes  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402
from hare_tpu_torch.geom.intersect import ray_triangle_mt, ray_triangle_watertight  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import (  # noqa: E402
    hard_histogram_bwd,
    hard_histogram_bwd_plain,
    histogram_kernel,
    histogram_plain,
    soft_histogram_bwd,
    soft_histogram_bwd_plain,
    soft_histogram_plain,
)
from hare_tpu_torch.utils import tracing  # noqa: E402

pytestmark = pytest.mark.cuda


def launches(*entries):
    """The launches of these C entry points counted so far
    (``kernels.build.launch``: ``launches.<entry point>``)."""
    counters = tracing.snapshot().counters
    return sum(counters.get(f"launches.{e}", 0) for e in entries)


GATHER_ENTRIES = ("hare_gather_sum_f32", "hare_gather_sum_i32", "hare_gather_sum_i32_f32")

# Every traversal kernel rounds each operation as its plain version does
# (kernels/build.py builds with -fmad=false): the two agree to the bit
# (assert_bit_equal).  RTOL / ATOL hold a kernel against B1, whose table
# rounds edges otherwise, and K2's u, v, point and normal.
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rays_of(rng, lo, hi, n, dev, ex=None):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return th.Ray.make(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                       None if ex is None else torch.as_tensor(ex, device=dev))


def assert_bit_equal(kernel_out, plain_out):
    """Kernel and plain version agree on every ray: best_t to the bit,
    best_tri, and pops or steps where given."""
    for what, a, b in zip(("best_t", "best_tri", "pops or steps"), kernel_out, plain_out):
        a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (a, b))
        differ = int((a != b).sum())
        assert differ == 0, f"{what} differs on {differ} of {a.numel()} rays"


def assert_same_nearest(kernel_out, plain_out, tie_share=1e-3):
    (tk, ik), (tp, ip) = kernel_out, plain_out
    hit = torch.isfinite(tp)
    assert torch.equal(torch.isfinite(tk), hit)
    torch.testing.assert_close(tk[hit], tp[hit], rtol=RTOL, atol=ATOL)
    flips = (ik != ip) & hit
    assert int(flips.sum()) <= max(1, int(hit.numel() * tie_share))  # equal-t ties only


def assert_agrees_with_referee(kernel_out, referee_out, share=1e-3, ties=False):
    """At most ``share`` of the rays with another hit mask, a t beyond RTOL /
    ATOL or (unless ``ties``) another triangle.  Returns the mask of the
    rays that agree."""
    (tk, ik), (tb, ib) = kernel_out, referee_out
    hit_k, hit_b = torch.isfinite(tk), torch.isfinite(tb)
    off = (hit_k != hit_b) | (hit_b & ((tk - tb).abs() > ATOL + RTOL * tb.abs()))
    if not ties:
        off |= hit_b & (ik != ib)
    assert int(off.sum()) <= max(1, int(tb.numel() * share))
    return ~off


def assert_ties_genuine(sc, rays, kernel_out, plain_out, kernel):
    """Where kernel and plain version pick different triangles, each pick is
    a hit of that ray, by the plain triangle test on the scene's vertices, at
    the t both report, and its polygon is not excluded: an equal-t tie."""
    (_, ik), (tp, ip) = kernel_out, plain_out
    f = (ik != ip) & torch.isfinite(tp)
    test = ray_triangle_watertight if kernel == "watertight" else ray_triangle_mt
    o, d, ex = rays.origin[f], rays.direction[f], rays.exclude_poly[f]
    for tri in (ik[f].long(), ip[f].long()):
        v = sc.vertices[sc.tri_v[tri].long()]  # (m, 3, 3)
        valid, t, _, _ = test(o, d, v[:, 0], v[:, 1], v[:, 2])
        assert bool(valid.all())
        torch.testing.assert_close(t, tp[f], rtol=RTOL, atol=ATOL)
        assert not bool((sc.tri_poly[tri][:, None] == ex).any())


SCENES = [
    ("shoebox", lambda: shapes.shoebox(4, 5, 3), dict(domain=4), (0.2, 4.8)),
    ("icosphere", lambda: shapes.icosphere(2), dict(domain=8), (-4.0, 4.0)),
    ("soup", lambda: shapes.random_soup(300, seed=11), dict(avg_polys=8.0), (-1.0, 11.0)),
    # Eval config 3's hall: coplanar stage, balcony and wall faces.
    ("hall", shapes.concert_hall, dict(domain=16), (0.5, 17.5)),
]
@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_grid_shoot_matches_plain(dev, name, faces, kw, box, kernel):
    """K1 against its plain version, to the bit; the hall's coincident faces
    (the stage's underside on the floor, the balconies' backs on the walls)
    tie on equal t between polygons, and both pick the lowest id."""
    top = th.Topology.build(faces())
    grid = build_voxel_grid(top, device=dev, **kw)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    assert_bit_equal(grid_shoot(rays, grid, kernel), grid_shoot_plain(rays, grid, kernel))


# Origins inside the closed scenes, so that most rays reflect on every bounce.
INSIDE = {"shoebox": (0.2, 2.8), "icosphere": (-0.5, 0.5)}
# Against B1, whose table rounds the edges otherwise: reflected rays in the
# hall end on its coincident floor and stage bottom far more often than rays
# from anywhere, and up to 17% of them tie there (on an H100), each a
# genuine equal-t tie (assert_ties_genuine); and a grazing ray turns the
# edges' last bits into a larger dt, on at most OFF_SHARE of the rays.
REFLECTED_TIE_SHARE = {"hall": 0.25}
OFF_SHARE = 2e-3


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_grid_shoot_reflected_rays(dev, name, faces, kw, box, kernel):
    """K1 on the rays of bounces 2 and 3 of a trace (reflected rays, with
    their exclusions) against its plain version, to the bit, and against
    B1."""
    top = th.Topology.build(faces())
    sp = th.SpatialPartition(top, kernel=kernel, device=dev, **kw)
    box = INSIDE.get(name, box)
    rays = rays_of(np.random.default_rng(5), box[0], box[1], 4096, dev)
    a = torch.full((top.n_polys,), 0.3, device=dev)
    share = REFLECTED_TIE_SHARE.get(name, 1e-3)
    for r in bounce_rays(sp, rays, a)[1:]:
        # The rays that hit on the bounce before (their polygon excluded);
        # the others left the scene and are no longer traced.
        r = th.Ray(*(x[r.exclude_poly[:, 0] >= 0] for x in r))
        assert r.origin.shape[0] > 500
        k = grid_shoot(r, sp.struct, kernel)
        # Rays that start where two faces coincide (the hall's stage on its
        # floor) and meet the face they do not exclude at t ~ 0 included.
        assert_bit_equal(k, grid_shoot_plain(r, sp.struct, kernel))
        # B1 reads the scene's edges (differences of f32 corners), K1 the
        # grid's (f64 differences rounded once): a grazing ray turns the
        # last bits into a larger dt, on at most OFF_SHARE of the rays.  On
        # the rest t agrees, and a differing triangle is a genuine equal-t
        # tie.
        b = brute_shoot(sp.scene, r, kernel)
        near = assert_agrees_with_referee(k, b, OFF_SHARE, ties=True)
        k_b, b_b = (k[0][near], k[1][near]), (b[0][near], b[1][near])
        assert_same_nearest(k_b, b_b, share)
        assert_ties_genuine(sp.scene, th.Ray(*(x[near] for x in r)), k_b, b_b, kernel)


# Three of the directions config 5's sustained run lost on bounce 1.
NEAR_AXIS_LOST = [[0.8620668053627014, -0.5067946314811707, -5.960464477539063e-08],
                  [0.3428290784358978, -1.035315051467478e-07, -0.9393978118896484],
                  [-1.643455647126757e-07, 0.5825172066688538, 0.8128184080123901]]


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_grid_shoot_on_a_256_grid(dev, kernel):
    """Eval config 5's grid (domain 256: 16.8M cells) over config 4's
    655,372-triangle scene: K1 bit-equal to its plain version on 2^16 rays
    from the scene's centre, as config 5 shoots them, on the rays of their
    second bounce (their polygon excluded), and on rays from anywhere in the
    shell.  A ray without an exclusion hits the closed shell; one reflected
    where two walls meet may leave it (the reference's exclusion rule)."""
    from hare_tpu_torch.benchmarks.configs import big_scene

    top = th.Topology.build(big_scene("650k"))
    sp = th.SpatialPartition(top, accel="grid", domain=256, kernel=kernel, device=dev)
    assert sp.struct.dims == (256, 256, 256)
    d = th.uniform_sphere(1 << 16, torch.Generator().manual_seed(0), device=dev)
    centre = th.Ray.make(torch.full_like(d, 20.0), d)
    a = torch.full((top.n_polys,), 0.3, device=dev)
    batches = bounce_rays(sp, centre, a, 2) + [rays_of(np.random.default_rng(6), 0.5, 39.5,
                                                       1 << 16, dev)]
    for r in batches:
        k = grid_shoot(r, sp.struct, kernel)
        assert_bit_equal(k, grid_shoot_plain(r, sp.struct, kernel))
        free = r.exclude_poly[:, 0] < 0
        assert bool(torch.isfinite(k[0][free]).all())
    # From the centre, on a cell boundary along every axis, the reference's
    # march loses a ray with a direction component within ~1e-7 of zero
    # (tests/test_torch_configs.py): K1 loses these as its plain version does.
    lost = torch.tensor(NEAR_AXIS_LOST, device=dev)
    lost = th.Ray.make(torch.full_like(lost, 20.0), lost)
    k = grid_shoot(lost, sp.struct, kernel)
    assert_bit_equal(k, grid_shoot_plain(lost, sp.struct, kernel))
    assert not bool(torch.isfinite(k[0]).any())


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_grid_shoot_cells_of_many_rows(dev, kernel):
    """A coarse grid over a dense sphere: cells of many window rows, which
    the lanes of a group share slot by slot."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3) + shapes.icosphere(4, 1.2, (2.0, 2.5, 1.5)))
    grid = build_voxel_grid(top, domain=3, device=dev)
    assert grid.max_cell_wins >= 8
    rays = rays_of(np.random.default_rng(6), 0.2, 2.8, 4096, dev)
    k = grid_shoot(rays, grid, kernel)
    assert_bit_equal(k, grid_shoot_plain(rays, grid, kernel))
    assert_agrees_with_referee(k, brute_shoot(top.scene(device=dev), rays, kernel))


def floor_tris(n):
    """An n x n floor of unit squares at z = 0, two triangles each."""
    out = []
    for i in range(n):
        for j in range(n):
            q = np.array([[i, j, 0], [i + 1, j, 0], [i + 1, j + 1, 0], [i, j + 1, 0]], float)
            out += [q[[0, 1, 2]], q[[2, 3, 0]]]
    return out


def downward_rays(rng, lo, hi, z, n, dev):
    o = np.stack([rng.uniform(lo[0], hi[0], n), rng.uniform(lo[1], hi[1], n),
                  rng.uniform(*z, n)], 1)
    d = np.stack([rng.normal(0, 0.2, n), rng.normal(0, 0.2, n), -np.ones(n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return th.Ray.make(torch.from_numpy(o.astype(np.float32)).to(dev),
                       torch.from_numpy(d.astype(np.float32)).to(dev))


def assert_lowest_id_on_ties(rays, sp, kernel):
    """Shot again with the winner's polygon excluded, a ray that finds the
    same t finds a higher triangle id.  Returns the number of such ties."""
    t, tri = grid_shoot(rays, sp.struct, kernel)
    assert bool(torch.isfinite(t).all())
    poly = sp.scene.tri_poly[tri.long()]
    ex = torch.stack([poly, torch.full_like(poly, -1)], 1).int()
    t2, tri2 = grid_shoot(rays._replace(exclude_poly=ex), sp.struct, kernel)
    tie = t2 == t
    assert bool((tri[tie] < tri2[tie]).all())
    return int(tie.sum())


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("domain", [2, 8])
def test_grid_shoot_ties_go_to_the_lowest_id(dev, domain, kernel):
    """Two topologies hold the same 8 x 8 floor, the second in reverse
    order, so every ray ends on an exact tie between twins in different
    lanes (and, with domain 2, different rows) of one cell: the group's
    reduction keeps the first topology's, lower, id."""
    floor = floor_tris(8)
    top_corner = np.array([[0.0, 0.0, 4.0], [0.1, 0.0, 4.0], [0.0, 0.1, 4.0]])  # the grid's height
    tops = [th.Topology.build(floor), th.Topology.build(floor[::-1] + [top_corner])]
    sp = th.SpatialPartition(tops, domain=domain, kernel=kernel, device=dev)
    assert domain == 8 or sp.struct.max_cell_wins >= 4
    rays = downward_rays(np.random.default_rng(8), (1.0, 1.0), (7.0, 7.0), (0.5, 2.0), 4096, dev)
    n_first = tops[0].n_tris
    _, tri = grid_shoot(rays, sp.struct, kernel)
    assert bool((tri < n_first).all())  # the first topology's twin wins
    assert assert_lowest_id_on_ties(rays, sp, kernel) == 4096
    assert_same_nearest(grid_shoot(rays, sp.struct, kernel),
                        brute_shoot(sp.scene, rays, kernel), tie_share=0.0)


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("domain", [4, 16])
def test_grid_shoot_hall_floor_ties(dev, domain, kernel):
    """Rays from inside the concert hall's stage riser, downward, end on
    z = 0, where the floor's and the stage's bottom triangles coincide; on
    the rays whose two t come out equal the lowest id wins, and K1 agrees
    with its plain version to the bit."""
    top = th.Topology.build(shapes.concert_hall())
    sp = th.SpatialPartition(top, domain=domain, kernel=kernel, device=dev)
    rays = downward_rays(np.random.default_rng(9), (5.5, 1.5), (24.5, 8.5), (0.2, 1.0), 4096, dev)
    assert assert_lowest_id_on_ties(rays, sp, kernel) > 0
    assert_bit_equal(grid_shoot(rays, sp.struct, kernel), grid_shoot_plain(rays, sp.struct, kernel))


def test_grid_shoot_exclusion_and_topology_filter(dev):
    tops = [th.Topology.build(shapes.shoebox()),
            th.Topology.build(shapes.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5)))]
    sp = th.SpatialPartition(tops, domain=8, device=dev)
    rng = np.random.default_rng(4)
    rays = rays_of(rng, 0.5, 2.5, 2048, dev)
    first = sp.shoot(rays)
    ex = torch.stack([first.poly_id, torch.full_like(first.poly_id, -1)], dim=1)
    rays = rays._replace(exclude_poly=ex.to(torch.int32))
    for top_index in (None, 0, 1):
        assert_bit_equal(grid_shoot(rays, sp.struct, top_index=top_index),
                         grid_shoot_plain(rays, sp.struct, top_index=top_index))


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_grid_shoot_per_topology_grid(dev, kernel):
    """``SpatialPartition.shoot(rays, top_index)`` builds each per-topology
    grid on the card once and caches it; K1 on it is bit-equal to its plain
    version and gives the combined grid's filtered answer; an out-of-range
    topology misses on every ray."""
    tops = [th.Topology.build(shapes.shoebox()),
            th.Topology.build(shapes.icosphere(2, radius=0.8, center=(2.0, 2.5, 1.5)))]
    sp = th.SpatialPartition(tops, domain=8, kernel=kernel, device=dev)
    rays = rays_of(np.random.default_rng(6), 0.5, 2.5, 4096, dev)
    for top_index in (0, 1):
        hits = sp.shoot(rays, top_index)
        grid = sp._top_grids[top_index]
        assert grid.cell_meta.is_cuda and grid.win_geom.is_cuda
        mine = grid_shoot(rays, grid, kernel)
        assert_bit_equal(mine, grid_shoot_plain(rays, grid, kernel))
        combined = grid_shoot(rays, sp.struct, kernel, top_index=top_index)
        assert torch.equal(mine[1], combined[1]) and torch.equal(hits.tri_id, mine[1])
        torch.testing.assert_close(mine[0], combined[0], rtol=RTOL, atol=0.0)
        assert bool(hits.hit.all()) if top_index == 0 else 0 < int(hits.hit.sum()) < 4096
        sp.shoot(rays, top_index)
        assert sp._top_grids[top_index] is grid
    assert not bool(sp.shoot(rays, 5).hit.any()) and sp._top_grids[5] is None


def trimmed(sc, rows):
    """The scene's first ``rows`` triangle rows, padding and all: n_tris
    need not be a multiple of B1's tile."""
    return sc._replace(tri_geom=sc.tri_geom[:rows].contiguous(),
                       tri_meta=sc.tri_meta[:rows].contiguous(), tri_v=sc.tri_v[:rows].contiguous())


def b1_scene(faces, box, n, rows=None):
    def make(dev, seed):
        sc = th.Topology.build(faces()).scene(device=dev)
        return (sc if rows is None else trimmed(sc, rows)), rays_of(
            np.random.default_rng(seed), box[0], box[1], n, dev)
    return make


def b1_twin_floors(dev, seed):
    """Two topologies hold the same 66 x 66 floor, the second in reverse
    order (17,424 triangles, 137 tiles): with 4,096 rays B1 cuts them into
    slabs, and every ray ends on an exact tie between twins in two slabs."""
    floor = floor_tris(66)
    sc = th.build_scene([th.Topology.build(floor), th.Topology.build(floor[::-1])], device=dev)
    rays = downward_rays(np.random.default_rng(seed), (1.0, 1.0), (65.0, 65.0), (0.5, 2.0), 4096,
                         dev)
    return sc, rays


# B1's cases: the four scenes; n_tris 1, below one tile and not a multiple
# of it (most rays miss); N of 1 (one ray block, a slab a tile) and 1M
# (one slab); equal-t ties across slabs.
B1_CASES = {name: b1_scene(faces, box, 4096) for name, faces, _, box in SCENES}
B1_CASES.update({
    "hall_1_row": b1_scene(shapes.concert_hall, (0.5, 17.5), 4096, rows=1),
    "hall_100_rows": b1_scene(shapes.concert_hall, (0.5, 17.5), 4096, rows=100),
    "hall_1000_rows": b1_scene(shapes.concert_hall, (0.5, 17.5), 4096, rows=1000),
    "hall_1_ray": b1_scene(shapes.concert_hall, (0.5, 17.5), 1),
    "shoebox_1M_rays": b1_scene(lambda: shapes.shoebox(4, 5, 3), (0.2, 4.8), 1_000_000),
    "twin_floors": b1_twin_floors,
})


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("case", list(B1_CASES))
def test_brute_shoot_matches_plain(dev, case, kernel):
    """B1 against its plain version, to the bit, with and without
    exclusions, and with each top_index; on the twin floors, the lower
    twin wins every ray."""
    sc, rays = B1_CASES[case](dev, 3)

    def agree(rays, top_index=None):
        k = brute_shoot(sc, rays, kernel, top_index=top_index)
        assert_bit_equal(k, brute_shoot_plain(sc, rays, kernel, tri_tile=256,
                                              top_index=top_index))
        return k

    first = agree(rays)
    for top_index in (0, 1):
        agree(rays, top_index)
    poly = torch.where(first[1] >= 0, sc.tri_poly[first[1].clamp(min=0).long()], -1)
    agree(rays._replace(exclude_poly=torch.stack([poly, torch.full_like(poly, -1)], 1).int()))
    if case == "twin_floors":
        n_first = int((sc.tri_top == 0).sum())
        assert bool(torch.isfinite(first[0]).all()) and bool((first[1] < n_first).all())


# name -> builder of a B2 tree (K = 8, 2, 2, 8 and 4) or a B3 rope tree.
TREES = {
    "octree": lambda top, dev, **kw: build_octree(top, device=dev, **kw),
    "kdtree": lambda top, dev, **kw: build_kdtree(top, device=dev, **kw),
    "kdtree_median": lambda top, dev, **kw: build_kdtree(top, split="median", device=dev, **kw),
    "kdtree_levels3": lambda top, dev, **kw: build_kdtree(top, levels=3, device=dev, **kw),
    "kdtree_levels2": lambda top, dev, **kw: build_kdtree(top, levels=2, device=dev, **kw),
    "ropes": lambda top, dev, **kw: build_kdtree_ropes(top, device=dev, **kw),
    "ropes_median": lambda top, dev, **kw: build_kdtree_ropes(top, split="median", device=dev, **kw),
}


def walk_pair(which, rays, tree, kernel, **kw):
    """(kernel, plain version) outputs of B2 or B3 with stats."""
    if which.startswith("ropes"):
        return (ropes_shoot(rays, tree, kernel, with_stats=True, **kw),
                ropes_shoot_plain(rays, tree, kernel, with_stats=True, **kw))
    return (tree_shoot(rays, tree, kernel, with_stats=True, **kw),
            tree_shoot_plain(rays, tree, kernel, with_stats=True, **kw))


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("which", sorted(TREES))
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_tree_walks_match_plain(dev, name, faces, kw, box, which, kernel):
    """B2 (K = 2, 4, 8) and B3 against their plain versions, to the bit,
    the pops or steps included.  Rays that miss the root box take no rope
    step."""
    top = th.Topology.build(faces())
    tree = TREES[which](top, dev, max_tris_per_node=4)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    k, p = walk_pair(which, rays, tree, kernel)
    assert_bit_equal(k, p)
    assert int(k[2].max()) >= 1


def plane_rays(tree, lo, hi, n, dev):
    """Rays on the tree's own planes: origins with one coordinate snapped
    onto a node face (split planes and root-box faces), moving inside that
    plane (a zero direction component) or along an axis."""
    rng = np.random.default_rng(12)
    box = tree.box if hasattr(tree, "ropes") else tree.child_box.reshape(-1, 8)
    faces = box[:, [0, 1, 2, 4, 5, 6]].cpu().numpy().reshape(-1, 2, 3)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n)
    for i in range(n):
        vals = faces[:, :, ax[i]].ravel()
        vals = vals[np.isfinite(vals) & (vals >= lo) & (vals <= hi)]
        o[i, ax[i]] = rng.choice(vals)
        if i % 2:  # in the plane
            d[i, ax[i]] = 0.0
        else:  # along an axis
            d[i] = 0.0
            d[i, rng.integers(0, 3)] = rng.choice([-1.0, 1.0])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return th.Ray.make(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))


# Rays in a plane that holds the icosphere's vertices and edges (the
# octree's and the median KD tree's centre planes) tie on equal t often.
# Against brute force, which rounds the geometry otherwise (f32 corners
# subtracted), such ties may flip often; against its own plain version (the
# same tables and tie rule) a walk agrees to the bit.
PLANE_TIE_SHARE = 1e-2


@pytest.mark.parametrize("which", sorted(TREES))
def test_tree_walks_on_planes(dev, which):
    """Split-plane and face-parallel rays (pad 0, so the root box lies on the
    walls): kernel and plain version take the same walk.  Off the root-box
    faces, they hit what brute force hits; a ray lying in a root-box max face
    with a zero direction component there leaves the stack walk's slab test
    at t = 0 (``where(d == 0, 1e-30, d)``, as in the JAX package), so those
    rays are held to the plain version only.  These rays cross edges and
    vertices on purpose, so the test is the watertight one: Möller-Trumbore
    has no edge rule, and brute force rounds the edges otherwise."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3) + shapes.icosphere(2, 0.8, (2.0, 2.5, 1.5)))
    sc = top.scene(device=dev)
    tree = TREES[which](top, dev, pad=0.0, max_tris_per_node=4)
    rays = plane_rays(tree, 0.0, 3.0, 4096, dev)
    o = rays.origin
    inner = ~((o == tree.root_min) | (o == tree.root_max)).any(dim=1)
    assert int(inner.sum()) > 2000
    sub = th.Ray(*(x[inner] for x in rays))
    assert_bit_equal(*walk_pair(which, rays, tree, "watertight"))
    k = walk_pair(which, sub, tree, "watertight")[0]
    assert_same_nearest(k[:2], brute_shoot(sc, sub), PLANE_TIE_SHARE)


def test_walk_bounds_raise(dev):
    """A stack or step bound below what the walk needs sets the kernel's
    error flag, and the wrapper raises; nothing is truncated."""
    top = th.Topology.build(shapes.random_soup(300, seed=17))
    rays = rays_of(np.random.default_rng(3), -1.0, 11.0, 1024, dev)
    kd = build_kdtree(top, max_tris_per_node=4, device=dev)
    with pytest.raises(RuntimeError, match="stack"):
        tree_shoot(rays, kd._replace(stack=2))
    rp = build_kdtree_ropes(top, max_tris_per_node=4, device=dev)
    with pytest.raises(RuntimeError, match="steps"):
        ropes_shoot(rays, rp._replace(max_steps=3))
    tree_shoot(rays, kd), ropes_shoot(rays, rp)  # the flag is per launch


def every_traversal(top, dev, kernel, **kw):
    """(label, kernel call, plain call) of K1, B1, B2 with K = 8, 2 and 4,
    and B3 on one topology: each call takes the rays and returns best_t,
    best_tri and, for the walks, the pops or steps."""
    sc = top.scene(device=dev)
    grid = build_voxel_grid(top, device=dev, **kw)
    out = [("K1", lambda r: grid_shoot(r, grid, kernel), lambda r: grid_shoot_plain(r, grid, kernel)),
           ("B1", lambda r: brute_shoot(sc, r, kernel), lambda r: brute_shoot_plain(sc, r, kernel))]
    for which in ("octree", "kdtree", "kdtree_levels2", "ropes"):
        tree = TREES[which](top, dev, max_tris_per_node=4)
        out.append((which, lambda r, w=which, t=tree: walk_pair(w, r, t, kernel)[0],
                     lambda r, w=which, t=tree: walk_pair(w, r, t, kernel)[1]))
    return out


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_kernels_round_as_plain(dev, name, faces, kw, box, kernel):
    """Every traversal kernel (K1, B1, B2 with K = 2, 4 and 8, B3) against
    its plain version, to the bit, on rays from anywhere and on every ray
    of bounces 2 and 3 of a trace from inside: the reflected rays, the
    hall's coincident faces among them, and (the soup's) the rays that
    missed on the bounce before and exclude nothing.  Built with nvcc's FMA contraction,
    the kernels rounded a * b + c once where the plain versions round
    twice, and some of these rays (near-zero hits, equal-t ties) came out
    otherwise."""
    top = th.Topology.build(faces())
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    sp = th.SpatialPartition(top, kernel=kernel, device=dev, **kw)
    lo, hi = INSIDE.get(name, box)
    inside = rays_of(np.random.default_rng(5), lo, hi, 4096, dev)
    batches = [rays] + bounce_rays(sp, inside, torch.full((top.n_polys,), 0.3, device=dev))[1:]
    for label, fn, plain in every_traversal(top, dev, kernel, **kw):
        for b, r in enumerate(batches):
            k = fn(r)
            assert bool(torch.isfinite(k[0]).any()), (label, b)
            try:
                assert_bit_equal(k, plain(r))
            except AssertionError as e:
                raise AssertionError(f"{label}, ray set {b}: {e}") from None


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("which", sorted(TREES))
def test_tree_walks_ties_go_to_the_lowest_id(dev, which, kernel):
    """Two topologies hold the same 8 x 8 floor, the second in reverse
    order, so a ray down onto it meets exact equal-t twins in different
    slots, rows and lanes of a leaf's run; rays straight down onto the unit
    grid's lines meet up to four triangles at one exact t (integer corners,
    dyadic origins), in the leaves on either side of a split.  The walk
    keeps the lowest id, as B1 does, to the bit."""
    floor = floor_tris(8)
    top_corner = np.array([[0.0, 0.0, 4.0], [0.1, 0.0, 4.0], [0.0, 0.1, 4.0]])
    tops = [th.Topology.build(floor), th.Topology.build(floor[::-1] + [top_corner])]
    sc = th.build_scene(tops, device=dev)
    tree = TREES[which](tops, dev, max_tris_per_node=4)
    tilted = downward_rays(np.random.default_rng(8), (1.0, 1.0), (7.0, 7.0), (0.5, 2.0), 2048, dev)
    g = np.stack(np.meshgrid(np.arange(1, 8), np.arange(4, 29) / 4, indexing="ij"), -1).reshape(-1, 2)
    g = np.concatenate([g, g[:, ::-1]])  # on the lines x = i and y = j
    o = np.concatenate([g, np.full((len(g), 1), 1.5)], 1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (len(g), 1))
    straight = th.Ray.make(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    n_first = tops[0].n_tris
    for rays in (tilted, straight):
        k, p = walk_pair(which, rays, tree, kernel)
        assert_bit_equal(k, p)
        assert bool(torch.isfinite(k[0]).all()) and bool((k[1] < n_first).all())
        assert_bit_equal(k[:2], brute_shoot(sc, rays, kernel))
    assert bool((k[0] == 1.5).all())


def min_stack(rays, tree):
    """The least stack bound with which the plain walk does not raise."""
    lo, hi = 1, tree.stack  # raises at lo - 1 (none at 0), not at hi
    while lo < hi:
        mid = (lo + hi) // 2
        try:
            tree_shoot_plain(rays, tree._replace(stack=mid))
            hi = mid
        except RuntimeError:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("which", ["octree", "kdtree", "kdtree_levels2"])
def test_tree_walk_reaches_its_stack_bound(dev, which):
    """A stack bound S that some ray's walk fills exactly: no raise, and the
    walk is the plain version's; one below raises, and the next launch on
    the stream is clean."""
    top = th.Topology.build(shapes.random_soup(300, seed=17))
    rays = rays_of(np.random.default_rng(3), -1.0, 11.0, 1024, dev)
    tree = TREES[which](top, dev, max_tris_per_node=2)
    s = min_stack(rays, tree)
    assert 2 <= s < tree.stack
    exact = tree._replace(stack=s)
    assert_bit_equal(tree_shoot(rays, exact, with_stats=True),
                     tree_shoot_plain(rays, exact, with_stats=True))
    with pytest.raises(RuntimeError, match="stack"):
        tree_shoot(rays, tree._replace(stack=s - 1))
    assert_bit_equal(tree_shoot(rays, exact), tree_shoot_plain(rays, exact))


def test_persistent_counter_shared_in_turn(dev):
    """K1, B2 and B3 share one ray counter per device and stream, each
    launch leaving it at zero: run in turn on the concert hall with no ray,
    one, fewer than the card holds groups, and config 3's 1M, each agrees
    with its plain version to the bit."""
    from hare_tpu_torch.accel.common import ray_counter

    top = th.Topology.build(shapes.concert_hall())
    grid = build_voxel_grid(top, device=dev)
    octree = build_octree(top, device=dev)
    rope = build_kdtree_ropes(top, device=dev)
    d = th.uniform_sphere(1_000_000, torch.Generator().manual_seed(0), device=dev)
    big = th.Ray.make(torch.tensor([15.0, 24.0, 8.0], device=dev).expand_as(d).contiguous(), d)
    for n in (0, 1, 100, 1_000_000, 1, 0, 100):
        rays = th.Ray(*(x[:n] for x in big))
        for k, p in ((grid_shoot(rays, grid), grid_shoot_plain(rays, grid)),
                     (tree_shoot(rays, octree, with_stats=True),
                      tree_shoot_plain(rays, octree, with_stats=True)),
                     (ropes_shoot(rays, rope, with_stats=True),
                      ropes_shoot_plain(rays, rope, with_stats=True))):
            assert k[0].shape == (n,)
            assert_bit_equal(k, p)
            assert torch.equal(ray_counter(grid.cell_meta.device).cpu(),
                               torch.zeros(2, dtype=torch.int32))


def assert_order_is_plain(rays, grid, got):
    """The kernels' order: keys equal to the plain version's to the bit, a
    permutation of the rays, its keys non-decreasing."""
    keys, order = got
    plain_keys, plain_order = voxel.grid_order_plain(rays, grid)
    assert torch.equal(keys, plain_keys)
    assert torch.equal(torch.sort(order.long()).values, torch.arange(keys.numel(), device=keys.device))
    assert torch.equal(keys[order.long()], plain_keys[plain_order.long()])


@pytest.fixture(scope="module")
def bench_2p20(dev):
    """The bench scene's grid (48^3, its tables inside L2) and the rays of
    the two bounces of 2^20 rays."""
    from hare_tpu_torch.benchmarks.bench_scene import bench_setup

    _, sp, rays, a = bench_setup(dev, 1 << 20)
    return sp.struct, bounce_rays(sp, rays, a, 2)


@pytest.mark.parametrize("bounce", [1, 2])
def test_grid_order_bit_equal(dev, bench_2p20, bounce):
    """K1 taking 2^20 rays in the order of their keys gives every ray the
    bits it gets in index order and from its plain version; the kernels'
    keys equal the plain version's and their order sorts them."""
    grid, batches = bench_2p20
    r = batches[bounce - 1]
    t, tri, got = voxel._grid_shoot_card(r, grid, ordered=True)
    assert_order_is_plain(r, grid, got)
    t0, tri0, none = voxel._grid_shoot_card(r, grid, ordered=False)
    assert none is None
    assert_bit_equal((t, tri), (t0, tri0))
    assert_bit_equal((t, tri), grid_shoot_plain(r, grid))


@pytest.mark.parametrize("n", [0, 1, 2, 3000])
def test_grid_order_small_and_one_key(dev, bench_2p20, n):
    """No ray, one, and shots whose rays all share one key (one origin and
    one direction): the order is a permutation, the hits as in index order;
    then a full shot after them finds its counts at zero."""
    grid, batches = bench_2p20
    r = batches[0]
    same = th.Ray(*(x[:1].expand(n, *x.shape[1:]).contiguous() for x in r))
    for rays in (th.Ray(*(x[:n] for x in r)), same):
        t, tri, got = voxel._grid_shoot_card(rays, grid, ordered=True)
        assert_order_is_plain(rays, grid, got)
        assert_bit_equal((t, tri), voxel._grid_shoot_card(rays, grid, ordered=False)[:2])
    t, tri, got = voxel._grid_shoot_card(r, grid, ordered=True)
    assert_order_is_plain(r, grid, got)
    assert_bit_equal((t, tri), voxel._grid_shoot_card(r, grid, ordered=False)[:2])


def test_grid_order_engages_by_shape(dev, bench_2p20):
    """On the card, grid_shoot orders the bench grid's 2^20 rays (many
    waves of the rays K1 runs at once) and leaves the bench's 32,768 in
    index order, one launch of hare_grid_shoot a shot either way."""
    grid, batches = bench_2p20
    resident, fixed = voxel.card_capacity(dev)
    assert 0 < resident * voxel.ORDER_MIN_WAVES <= 1 << 20 and fixed > 0
    tracing.reset()
    k1 = launches("hare_grid_shoot")
    for rays in (batches[0], th.Ray(*(x[:32768] for x in batches[0]))):
        grid_shoot(rays, grid)
    assert launches("hare_grid_shoot") - k1 == 2
    assert tracing.snapshot().counters.get("rays.ordered", 0) == 1 << 20


@pytest.mark.parametrize("which", ["kdtree", "ropes", "hall_octree"])
def test_tree_walks_deep_trees(dev, which):
    """The KD tree at its default depth limit of 22 (one triangle a leaf,
    so the build reaches it; B2's stack bound S = 28) and the concert
    hall's octree (config 3's): kernel and plain version agree to the bit."""
    if which == "hall_octree":
        top = th.Topology.build(shapes.concert_hall())
        tree = build_octree(top, device=dev)
        rays = rays_of(np.random.default_rng(4), 0.5, 17.5, 4096, dev)
    else:
        top = th.Topology.build(shapes.random_soup(600, seed=19))
        tree = TREES[which](top, dev, max_depth=22, max_tris_per_node=1)
        assert tree.max_depth == 22
        rays = rays_of(np.random.default_rng(4), -1.0, 11.0, 4096, dev)
    k, p = walk_pair("ropes" if which == "ropes" else "tree", rays, tree, "watertight")
    assert_bit_equal(k, p)
    assert int(k[2].max()) > (22 if which != "hall_octree" else 2)


def test_tree_walks_exclusion_and_topology_filter(dev):
    tops = [th.Topology.build(shapes.shoebox()),
            th.Topology.build(shapes.icosphere(1, radius=0.8, center=(2.0, 2.5, 1.5)))]
    sc = th.build_scene(tops, device=dev)
    rays = rays_of(np.random.default_rng(4), 0.5, 2.5, 2048, dev)
    first = brute_shoot(sc, rays)
    poly = sc.tri_poly[first[1].long()]
    rays = rays._replace(exclude_poly=torch.stack([poly, torch.full_like(poly, -1)], 1).int())
    for which in ("octree", "kdtree", "kdtree_levels3", "ropes"):
        tree = TREES[which](tops, dev, max_tris_per_node=8)
        for top_index in (None, 0, 1):
            k, p = walk_pair(which, rays, tree, "watertight", top_index=top_index)
            assert_bit_equal(k, p)
            assert_same_nearest(k[:2], brute_shoot(sc, rays, top_index=top_index))


@pytest.mark.parametrize("accel", ["brute", "octree", "kdtree", "kdtree_ropes"])
def test_backend_trace_on_card_matches_cpu(dev, accel):
    """Each new backend's main path on the card (B1/B2/B3, K2, K3) against
    the plain versions on the CPU."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    out = {}
    for where in ("cpu", dev):
        sp = th.SpatialPartition(top, accel=accel, device=where)
        rays = rays_of(np.random.default_rng(6), 0.3, 2.7, 2048, where)
        a = torch.full((top.n_polys,), 0.3, device=where, requires_grad=True)
        res = th.trace_rays(sp.scene, rays, a, 4, sp.shoot_fn, aux=sp.aux)
        hist = th.energy_histogram(res, 64)
        hist.sum().backward()
        out[str(where)] = [x.detach().cpu() for x in (res.hit, res.poly_id, res.energy, hist, a.grad)]
    c, k = out["cpu"], out[str(dev)]
    assert torch.equal(c[0], k[0]) and torch.equal(c[1], k[1])
    for a, b in zip(c[2:], k[2:]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_finalize_matches_plain(dev, kernel):
    top = th.Topology.build(shapes.concert_hall())
    sp = th.SpatialPartition(top, avg_polys=12.0, kernel=kernel, device=dev)
    rays = rays_of(np.random.default_rng(5), 2.0, 16.0, 4096, dev)
    best_t, best_tri = grid_shoot(rays, sp.struct, kernel)
    hk = finalize_hits(sp.scene, rays, best_t, best_tri, kernel)
    hp = finalize_hits_plain(sp.scene, rays, best_t, best_tri, kernel)
    for f in ("hit", "poly_id", "tri_id", "edge_nbr"):
        assert torch.equal(getattr(hk, f), getattr(hp, f)), f
    for f in ("t", "u", "v", "point", "normal"):
        torch.testing.assert_close(getattr(hk, f), getattr(hp, f), rtol=RTOL, atol=ATOL)


def test_histogram_matches_plain(dev):
    """K3, hard and soft bins, one tile of bins and many (any n_bins fits),
    against its plain version; two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(0)
    energy = torch.rand(3, 50_000, generator=g, device=dev)
    time = torch.rand(3, 50_000, generator=g, device=dev) * 1.2 - 0.1
    hit = torch.rand(3, 50_000, generator=g, device=dev) < 0.9
    for soft, plain in ((False, histogram_plain), (True, soft_histogram_plain)):
        for n_bins in (1024, 2048, 20_000):
            hk = histogram_kernel(energy, time, hit, n_bins, 1e-3, soft=soft)
            hp = plain(energy, time, hit, n_bins, 1e-3)
            # K3 sums in a fixed order of its own, index_add_ in index order:
            # per-bin sums agree to f32 rounding of the bin total.
            torch.testing.assert_close(hk, hp, rtol=1e-5, atol=1e-5 * float(hp.abs().max()))
            again = histogram_kernel(energy, time, hit, n_bins, 1e-3, soft=soft)
            assert torch.equal(hk.view(torch.int32), again.view(torch.int32))


def test_soft_histogram_bwd_matches_plain(dev):
    """The soft backward against autograd through the plain soft histogram,
    times at bin centres (JAX's clip gradient, 1/2) included; two launches
    give the same bits."""
    g = torch.Generator(device=dev).manual_seed(1)
    n_bins = 512
    energy = torch.rand(3, 40_000, generator=g, device=dev)
    time = torch.rand(3, 40_000, generator=g, device=dev) * 0.6 - 0.01
    time[0, :100] = (torch.arange(100, device=dev, dtype=torch.float32) + 0.5) * 2.0 ** -10
    hit = torch.rand(3, 40_000, generator=g, device=dev) < 0.9
    hit[0, :100] = True
    grad = torch.randn(n_bins, generator=g, device=dev)
    bin_dt = 2.0 ** -10  # bin centres exact in f32
    dk = soft_histogram_bwd(energy, time, hit, grad, n_bins, bin_dt)
    dp = soft_histogram_bwd_plain(energy, time, hit, grad, n_bins, bin_dt)
    for k, p in zip(dk, dp):
        torch.testing.assert_close(k, p, rtol=1e-6, atol=1e-6 * float(p.abs().max()))
    again = soft_histogram_bwd(energy, time, hit, grad, n_bins, bin_dt)
    for k, a in zip(dk, again):
        assert torch.equal(k.view(torch.int32), a.view(torch.int32))
    # At a bin centre: half of energy (G[hi] - G[lo]) / bin_dt.
    lo = torch.arange(100, device=dev)
    half = 0.5 * energy[0, :100] * (grad[torch.clamp(lo + 1, max=n_bins - 1)] - grad[lo]) / bin_dt
    torch.testing.assert_close(dk[1][0, :100], half, rtol=1e-5, atol=1e-3)


# (m, n_keys, keys): zipf-skewed keys (long runs and many short ones,
# unused keys), one key holding every value (eval config 3's wall), keys
# partly outside [0, n_keys), or uniform keys with a tenth of the values on
# three keys ("wide").  5,000,000 and 5,242,892 keys take the sort's 64-bit
# pairs.  Pass 2 lists (range, chunk) pairs where n_chunks x n_ranges >
# 2^20 (scatter.cu plan()): 100,000 values (98 chunks) into 2,738,944 keys
# (10,699 ranges of 256) still search, one key more lists
# (test_scatter_plan_sides); 1,200,000 values into 300,000 keys list, and
# the range of keys 0-255, met by all 1,172 chunks, is searched (more than
# the 1,024 pairs a block ranks).
SCATTER_CASES = [
    (0, 4, "zipf"), (1, 4, "zipf"), (CHUNK - 1, 100, "zipf"), (CHUNK, 100, "zipf"),
    (CHUNK + 1, 100, "zipf"), (5000, 3, "zipf"), (100_000, 1, "zipf"),
    (98_304, 81_932, "zipf"), (98_304, 327_698, "zipf"), (300_000, 40_000, "zipf"),
    (1_000_000, 200, "zipf"), (147_389, 1_608, "one"), (50_000, 1000, "outside"),
    (100_000, 5_000_000, "zipf"), (300_001, 5_242_892, "wide"), (100_000, 2_738_944, "wide"),
    (100_000, 2_738_945, "wide"), (1_200_000, 300_000, "zipf"),
]
RULE_SIDES = ((100_000, 2_738_944, False), (100_000, 2_738_945, True))


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("m, n_keys, keys", SCATTER_CASES)
def test_scatter_matches_cpu(dev, m, n_keys, keys, cols):
    """The fixed-order scatter on the card equals its plain version on the
    CPU to the bit (index_add_ a chunk of original positions, the chunks in
    order); keys outside [0, n_keys) are dropped, as a +0.0 added to key 0
    would be; two launches give the same bits."""
    rng = np.random.default_rng(m + cols)
    if keys == "one":
        k = np.full(m, n_keys - 1, np.int32)
    elif keys == "outside":
        k = rng.integers(-5, n_keys + 5, m).astype(np.int32)
    elif keys == "wide":
        k = rng.integers(0, n_keys, m)
        k[: m // 10] = n_keys - 1 - rng.integers(0, 3, m // 10)
        k = rng.permutation(k).astype(np.int32)
    else:
        k = (rng.zipf(1.5, m) % n_keys).astype(np.int32)  # skewed: long runs
    values = rng.normal(size=(m,) if cols == 1 else (m, cols)).astype(np.float32)
    k_t, v_t = torch.from_numpy(k), torch.from_numpy(values)
    inside = (k_t >= 0) & (k_t < n_keys)
    want = scatter_add_plain(torch.where(inside, k_t, 0),
                             torch.where(inside.view((m,) + (1,) * (cols > 1)), v_t, 0.0), n_keys)
    got = scatter_add_ordered(k_t.to(dev), v_t.to(dev), n_keys)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    again = scatter_add_ordered(k_t.to(dev), v_t.to(dev), n_keys)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_scatter_plan_sides(dev):
    """The n_keys of SCATTER_CASES that straddle the rule picking how pass 2
    finds its entries (searched below, listed pairs above) do straddle it,
    with ranges of 256 keys."""
    for m, n_keys, listed in RULE_SIDES:
        assert pass2_plan(m, n_keys) == (256, listed)


# Eval config 5's absorption gradient: 2^20 values into its 5,242,892
# polygons, above the 2^22 - 1 keys that the sort's 32-bit pairs hold.
CONFIG5_POLYS = 5_242_892


@pytest.mark.parametrize("keys", ["sparse", "dense", "spread", "one a chunk"])
def test_scatter_at_config5_keys(dev, keys):
    """The scatter at config 5's width, 2^20 values into 5,242,892 keys:
    sparse as a bounce's hits spread over the spheres (most keys unused,
    a few runs), dense (every value on the top 65,536 keys, keys above
    2^22, 16 a key), spread (the most pairs: each chunk's 1,024 values in
    1,024 ranges of 256 keys, each such range met by all 1,024 chunks), or
    sparse with one key in every chunk (its range met by all 1,024 chunks);
    equal to its plain version on the CPU to the bit, and two launches give
    the same bits."""
    rng = np.random.default_rng(14)
    m = 1 << 20
    assert pass2_plan(m, CONFIG5_POLYS) == (256, True)
    if keys == "sparse":
        k = rng.integers(0, CONFIG5_POLYS, m)
        k[: m // 8] = rng.integers(0, 12, m // 8)  # the shell's few walls: long runs
        k = rng.permutation(k)
    elif keys == "one a chunk":
        k = rng.integers(0, CONFIG5_POLYS, m)
        k[500::CHUNK] = 7
    elif keys == "spread":
        k = np.arange(m) % CHUNK * (CONFIG5_POLYS // CHUNK) + rng.integers(0, 256, m)
    else:
        k = CONFIG5_POLYS - 1 - rng.integers(0, 1 << 16, m)
    k_t = torch.from_numpy(k.astype(np.int32))
    v_t = torch.from_numpy(rng.normal(size=m).astype(np.float32))
    want = scatter_add_plain(k_t, v_t, CONFIG5_POLYS)
    got = scatter_add_ordered(k_t.to(dev), v_t.to(dev), CONFIG5_POLYS)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    again = scatter_add_ordered(k_t.to(dev), v_t.to(dev), CONFIG5_POLYS)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("chunk, short", [(CHUNK // 2, 0), (CHUNK, 1)])
def test_scatter_refuses_another_layout(dev, chunk, short):
    """The kernel owns the scratch layout: a chunk size other than its own,
    or a scratch one word short, is refused before anything launches."""
    m, cols, n_keys = 3000, 3, 50
    keys = torch.zeros(m, dtype=torch.int32, device=dev)
    values = torch.ones(m, cols, device=dev)
    words = scratch_words(m, cols, n_keys) - short
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    out = torch.empty(n_keys, cols, device=dev)
    with pytest.raises(RuntimeError, match="invalid argument"):
        build.launch("hare_scatter_add_ordered", keys, values, m, cols, n_keys, chunk, scratch,
                     words, out)


def bwd_inputs(dev, kernel, n=4096, seed=5):
    """The hall's grid winners of ``n`` rays and seeded cotangents."""
    top = th.Topology.build(shapes.concert_hall())
    sp = th.SpatialPartition(top, avg_polys=12.0, kernel=kernel, device=dev)
    rays = rays_of(np.random.default_rng(seed), 2.0, 16.0, n, dev)
    best_t, best_tri = grid_shoot(rays, sp.struct, kernel)
    hr = finalize_hits(sp.scene, rays, best_t, best_tri, kernel)
    g = torch.Generator(device=dev).manual_seed(seed)
    cts = tuple(torch.randn(shape, generator=g, device=dev)
                for shape in ((n,), (n,), (n,), (n, 3), (n, 3)))
    return sp.scene, rays, best_tri, hr, cts


# A3's closed form against autograd through the plain triangle test: the
# same VJP in another order of operations; relative to the largest
# cotangent, where a grazing ray (det near 0) magnifies the rounding.
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
def test_finalize_backward_matches_plain(dev, kernel):
    """A3 against its plain version on the card: per ray d(origin),
    d(direction), the vertex ids and the corner cotangents, and the
    scattered vertex gradient; every element within a3_check's bound of
    the plain version in float64; two launches give the same bits."""
    scene, rays, best_tri, hr, cts = bwd_inputs(dev, kernel)
    args = (scene.vertices, scene.tri_meta, best_tri, hr.t, hr.hit, rays.origin, rays.direction,
            cts)
    k = finalize_hits_bwd(*args, kernel)
    p = finalize_hits_bwd_plain(*args, kernel)
    assert torch.equal(k[2], p[2].to(torch.int32))
    p64 = finalize_hits_bwd_plain(
        *(x.double() if x.is_floating_point() else x for x in args[:-1]),
        tuple(g.double() for g in cts), kernel)
    agree = a3_check.agreement(k, p64, args, a3_check.ray_bounds(args))
    assert all(r["outside"] == 0 for r in agree.values()), agree
    for a, b in zip((k[0], k[1], k[3]), (p[0], p[1], p[3])):
        torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL * float(b.abs().max()))
    n_v = scene.vertices.shape[0]
    dv_k = scatter_add_ordered(k[2], k[3], n_v)
    dv_p = scatter_add_plain(p[2], p[3], n_v)
    torch.testing.assert_close(dv_k, dv_p, rtol=BWD_RTOL, atol=BWD_ATOL * float(dv_p.abs().max()))
    again = finalize_hits_bwd(*args, kernel)
    for a, b in zip(k, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def unaligned(x):
    """``x``'s values in a contiguous tensor whose storage starts one
    element past a 16-byte boundary (a view at an odd storage offset)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 != 0
    return out


# A3 at the edges of its launch: one ray, a ray count that is not a whole
# number of blocks, every ray a miss, rays lying in their triangle's plane
# (det exactly 0), (N, 3) rows at an unaligned storage offset, and absent
# cotangents (an output no loss reaches).
A3_EDGES = ["n = 1", "n = 1000", "all misses", "zero det", "unaligned rows", "absent u and v",
            "all absent"]


def a3_edge_args(dev, case):
    """``finalize_hits_bwd``'s arguments for one case of ``A3_EDGES``."""
    if case == "zero det":
        # Every ray hits the floor triangle; every other ray lies in its plane.
        sc = th.Topology.build(shapes.shoebox(4, 5, 3)).scene(device=dev)
        floor = int(torch.nonzero((sc.vertices[sc.tri_v.long()][..., 2] == 0).all(1))[0])
        n = 512
        rng = np.random.default_rng(9)
        o = torch.tensor(rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (n, 3)),
                         dtype=torch.float32, device=dev)
        d = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
        d[:, 2] = -d[:, 2].abs() - 0.1
        d[::2] = torch.tensor((0.6, 0.8, 0.0), device=dev)
        d = d / d.norm(dim=1, keepdim=True)
        best_tri = torch.full((n,), floor, dtype=torch.int32, device=dev)
        return (sc.vertices, sc.tri_meta, best_tri, o[:, 2] / d[:, 2].abs(),
                torch.ones(n, dtype=torch.bool, device=dev), o, d,
                a3_check.seeded_cotangents(n, 9, dev))
    n = {"n = 1": 1, "n = 1000": 1000}.get(case, 4096)
    scene, rays, best_tri, hr, cts = bwd_inputs(dev, "watertight", n=n, seed=7)
    t, hit, o, d = hr.t, hr.hit, rays.origin, rays.direction
    if case == "all misses":
        best_tri = torch.full_like(best_tri, -1)
        t, hit = torch.full_like(t, float("inf")), torch.zeros_like(hit)
    elif case == "unaligned rows":
        o, d = unaligned(o), unaligned(d)
        cts = cts[:3] + tuple(unaligned(g) for g in cts[3:])
    elif case == "absent u and v":
        cts = (cts[0], None, None, cts[3], cts[4])
    elif case == "all absent":
        cts = (None,) * 5
    return scene.vertices, scene.tri_meta, best_tri, t, hit, o, d, cts


def zero_filled(args):
    """``args`` with each absent cotangent as zeros."""
    *inputs, cts = args
    n = inputs[5].shape[0]
    return (*inputs, tuple(torch.zeros(sh, device=inputs[5].device) if g is None else g
                           for g, sh in zip(cts, ((n,), (n,), (n,), (n, 3), (n, 3)))))


def a3_whole_blocks(args):
    """A3 on the same rays padded with misses to a multiple of 1024 rays
    (whole blocks at any block size up to 1024), every input in a fresh
    16-byte-aligned tensor, an absent cotangent as zeros: the launch whose
    blocks all move their rows through shared memory."""
    vertices, tri_meta, best_tri, t, hit, o, d, cts = zero_filled(args)
    n = o.shape[0]
    m = -(-n // 1024) * 1024

    def pad(x, fill):
        out = torch.full((m,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:n] = x
        return out

    out = finalize_hits_bwd(vertices, tri_meta, pad(best_tri, -1), pad(t, float("inf")),
                            pad(hit, False), pad(o, 0.0), pad(d, 0.0),
                            tuple(pad(g, 0.0) for g in cts))
    return out[0][:n], out[1][:n], out[2][:3 * n], out[3][:3 * n]


@pytest.mark.parametrize("case", A3_EDGES)
def test_finalize_backward_edge_cases(dev, case):
    """A3 on each edge case: every element within a3_check's bound of the
    plain version in float64, the vertex ids equal; bit-equal to itself
    over two launches and to the same rays launched as one aligned batch
    of whole blocks (so the per-ray path and the staged one agree to the
    bit, and an absent cotangent reads as zeros)."""
    args = a3_edge_args(dev, case)
    k = finalize_hits_bwd(*args)
    for x, y, z in zip(k, finalize_hits_bwd(*args), a3_whole_blocks(args)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        assert torch.equal(x.view(torch.int32), z.view(torch.int32))
    full = zero_filled(args)
    p64 = finalize_hits_bwd_plain(
        *(x.double() if x.is_floating_point() else x for x in full[:-1]),
        tuple(g.double() for g in full[-1]))
    assert torch.equal(k[2], p64[2].to(torch.int32))
    bounds = a3_check.ray_bounds(full)
    if case == "zero det":
        # A ray in its triangle's plane meets it at t = inf: its d(direction),
        # t d(point), need not be finite, in the plain version or the
        # kernel (and its condition number is inf).  Every other element
        # is held as in every other case.
        flat = torch.isinf(a3_check.condition(*full[:3], full[6]))
        bad = ~(torch.isfinite(k[1]) & torch.isfinite(p64[1]))
        assert bool(bad.any()) and not bool(bad[~flat].any())
        k = (k[0], torch.where(bad, 0.0, k[1]), k[2], k[3])
        p64 = (p64[0], torch.where(bad, 0.0, p64[1]), p64[2], p64[3])
        bounds = tuple(torch.where(torch.isnan(b), torch.inf, b) for b in bounds)
    agree = a3_check.agreement(k, p64, full, bounds)
    assert all(r["outside"] == 0 for r in agree.values()), agree
    if case == "all absent":
        assert not any(bool(x.any()) for x in (k[0], k[1], k[3]))


# K3 at the edges of its launch: (lanes, n_bins, kind): no lane, fewer or
# a few more than a warp's 32, every lane in one bin (a group of 32 in
# every step), every lane dead, one bin, bins around one tile of 1024 and
# many tiles, and 3,145,728 lanes (three bounces of 2^20 rays, past eval
# config 3's 3,000,000).
K3_EDGES = [(0, 1024, "random"), (1, 1024, "random"), (31, 1024, "random"),
            (33, 1024, "random"), (50_000, 1024, "one bin"), (50_000, 1024, "dead"),
            (50_000, 1, "random"), (50_000, 1000, "random"), (50_000, 1024, "random"),
            (50_000, 1025, "random"), (50_000, 20_000, "random"), (3_145_728, 1024, "random")]


def k3_lanes(dev, n, n_bins, kind):
    """Seeded (energy, time, hit) lanes: times spread over the window and
    a little beyond it on both sides, a tenth of the lanes dead."""
    rng = np.random.default_rng(n + n_bins)
    energy = rng.uniform(0, 1, n).astype(np.float32)
    time = (rng.uniform(-0.1, 1.1, n) * n_bins * 1e-3).astype(np.float32)
    hit = rng.uniform(size=n) < 0.9
    if kind == "one bin":
        time[:], hit[:] = 7.5e-3, True
    elif kind == "dead":
        hit[:] = False
    return tuple(torch.from_numpy(x).to(dev) for x in (energy, time, hit))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("n, n_bins, kind", K3_EDGES)
def test_histogram_edge_cases(dev, n, n_bins, kind, soft):
    """K3 on each edge case: two launches give the same bits, every bin
    within 1e-5 of the total of its plain version (the same values summed
    in another order; exactly where the total is 0), and the total the
    live lanes' energy."""
    energy, time, hit = k3_lanes(dev, n, n_bins, kind)
    hk = histogram_kernel(energy, time, hit, n_bins, 1e-3, soft=soft)
    again = histogram_kernel(energy, time, hit, n_bins, 1e-3, soft=soft)
    assert torch.equal(hk.view(torch.int32), again.view(torch.int32))
    hp = (soft_histogram_plain if soft else histogram_plain)(energy, time, hit, n_bins, 1e-3)
    total = float(hp.double().sum())
    assert float((hk - hp).abs().max()) <= 1e-5 * total
    live = float(energy[hit].double().sum())
    assert abs(float(hk.double().sum()) - live) <= 1e-5 * live


def test_histogram_on_two_streams(dev):
    """K3 in turn on two streams gives the bits of the default stream's
    launch, hard and soft."""
    lanes = k3_lanes(dev, 200_000, 1024, "random")
    want = [histogram_kernel(*lanes, 1024, 1e-3, soft=soft) for soft in (False, True)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams + streams:
        with torch.cuda.stream(s):
            got = [histogram_kernel(*lanes, 1024, 1e-3, soft=soft) for soft in (False, True)]
        s.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def same_bits(a, b):
    """Two like tensors equal to the bit (floats through their int32 bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


# K2 at the edges of its launch: no ray, one, ray counts that are not a
# whole number of blocks (a tail block), 10^5 rays and more, (N, 3) rows at
# an unaligned storage offset, every ray a miss, and the MT test.
K2_EDGES = ["n = 0", "n = 1", "n = 1000", "n = 300,007", "unaligned rows", "all misses", "mt"]


def k2_edge_args(dev, case):
    """``finalize_hits``' arguments for one case of ``K2_EDGES``: the hall's
    grid winners of seeded rays (some miss)."""
    kernel = "mt" if case == "mt" else "watertight"
    n = {"n = 0": 0, "n = 1": 1, "n = 1000": 1000}.get(case, 300_007)
    top = th.Topology.build(shapes.concert_hall())
    sp = th.SpatialPartition(top, avg_polys=12.0, kernel=kernel, device=dev)
    rays = rays_of(np.random.default_rng(3), 2.0, 16.0, n, dev)
    best_t, best_tri = grid_shoot(rays, sp.struct, kernel)
    if case == "all misses":
        best_t, best_tri = torch.full_like(best_t, float("inf")), torch.full_like(best_tri, -1)
    elif case == "unaligned rows":
        rays = th.Ray(unaligned(rays.origin), unaligned(rays.direction), rays.exclude_poly)
    return sp.scene, rays, best_t, best_tri, kernel


def k2_whole_blocks(scene, rays, best_t, best_tri, kernel):
    """K2 on the same rays padded with misses to a multiple of 1024 rays
    (whole blocks at any block size up to 1024), every input in a fresh
    tensor."""
    n = best_t.shape[0]
    m = -(-n // 1024) * 1024

    def pad(x, fill):
        out = torch.full((m,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:n] = x
        return out

    out = finalize_hits(scene, th.Ray(pad(rays.origin, 0.0), pad(rays.direction, 1.0),
                                      pad(rays.exclude_poly, -1)),
                        pad(best_t, float("inf")), pad(best_tri, -1), kernel)
    return [x[:n] for x in out]


@pytest.mark.parametrize("case", K2_EDGES)
def test_finalize_edge_cases(dev, case):
    """K2 on each edge case: hit, poly_id, tri_id and edge_nbr equal to the
    plain version's, t, u, v, point and normal within RTOL / ATOL of it;
    every field bit-equal to itself over two launches, to the same rays
    launched as one batch of whole blocks (a tail block agrees with a
    whole one) and, from 4096 rays, to its first 4096 rays launched alone
    (a ray's record does not depend on the launch's size)."""
    scene, rays, best_t, best_tri, kernel = k2_edge_args(dev, case)
    hk = finalize_hits(scene, rays, best_t, best_tri, kernel)
    hp = finalize_hits_plain(scene, rays, best_t, best_tri, kernel)
    for f in ("hit", "poly_id", "tri_id", "edge_nbr"):
        assert torch.equal(getattr(hk, f), getattr(hp, f)), f
    for f in ("t", "u", "v", "point", "normal"):
        torch.testing.assert_close(getattr(hk, f), getattr(hp, f), rtol=RTOL, atol=ATOL)
    again = finalize_hits(scene, rays, best_t, best_tri, kernel)
    whole = k2_whole_blocks(scene, rays, best_t, best_tri, kernel)
    for f, x, y, z in zip(hk._fields, hk, again, whole):
        assert same_bits(x, y) and same_bits(x, z), f
    m = 4096
    if best_t.shape[0] >= m:
        part = finalize_hits(scene, th.Ray(*(x[:m] for x in rays)), best_t[:m], best_tri[:m],
                             kernel)
        for f, x, y in zip(hk._fields, hk, part):
            assert same_bits(x[:m], y), f
    if case == "all misses":
        assert not bool(hk.hit.any()) and bool((hk.tri_id == -1).all())


# K3's backward at the edges of its launch: no lane, a few, the bench's
# 98,304, an unaligned view of every lane array, the gradient of a sum (one
# value broadcast, stride 0), every lane dead, times outside the window;
# and from 2^20 lanes (four lanes a thread) lane counts that are whole
# words of four lanes and that are not (the per-lane tail) and an
# unaligned view (lane by lane).
HB_EDGES = [(0, "random"), (1, "random"), (3, "random"), (4, "random"), (98_304, "random"),
            (98_307, "random"), (50_001, "unaligned"), (50_000, "broadcast"), (50_000, "dead"),
            (50_000, "outside"), (1_048_576, "random"), (1_048_579, "random"),
            (1_048_579, "unaligned"), (1_048_576, "broadcast")]


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("n, kind", HB_EDGES)
def test_histogram_bwd_edge_cases(dev, n, kind, soft):
    """K3's backward on each edge case: hard bit-equal to the torch glue it
    replaced (its plain version), soft within 1e-6 of the largest gradient
    of autograd through the plain soft histogram; two launches give the
    same bits."""
    n_bins = 1024
    energy, time, hit = k3_lanes(dev, n, n_bins, "dead" if kind == "dead" else "random")
    if kind == "outside":
        time = time * 4.0 - 1.5 * n_bins * 1e-3
    elif kind == "unaligned":
        energy, time, hit = unaligned(energy), unaligned(time), unaligned(hit)
    g = torch.Generator(device=dev).manual_seed(n)
    grad = torch.randn(n_bins, generator=g, device=dev)
    if kind == "broadcast":
        grad = torch.ones((), device=dev).expand(n_bins)
        assert grad.stride(0) == 0

    def run():
        if soft:
            return soft_histogram_bwd(energy, time, hit, grad, n_bins, 1e-3)
        return (hard_histogram_bwd(time, hit, grad, n_bins, 1e-3),)

    k = run()
    for x, y in zip(k, run()):
        assert same_bits(x, y)
    if soft:
        for x, p in zip(k, soft_histogram_bwd_plain(energy, time, hit, grad, n_bins, 1e-3)):
            top = float(p.abs().max()) if p.numel() else 0.0
            torch.testing.assert_close(x, p, rtol=1e-6, atol=1e-6 * top)
    else:
        assert same_bits(k[0], hard_histogram_bwd_plain(time, hit, grad, n_bins, 1e-3))


@pytest.mark.parametrize("accel", ["brute", "grid", "octree", "kdtree", "kdtree_ropes"])
def test_vertex_grads_on_card_match_cpu(dev, accel):
    """d/d(vertices) of the soft histogram's first moment and of sum(t *
    energy) on hits, 2 bounces, through each backend on the card (A3, the
    scatter, K3 soft and its backward) against the plain versions on the
    CPU; the card's gradient repeats to the bit."""
    faces = shapes.shoebox(4, 5, 3) + shapes.icosphere(2, radius=0.7, center=(2.0, 3.5, 1.2))
    top = th.Topology.build(faces)
    out = {}
    for where in ("cpu", dev):
        sp = th.SpatialPartition(top, accel=accel, device=where)
        rays = rays_of(np.random.default_rng(9), 0.3, 2.7, 2048, where)
        a = torch.full((top.n_polys,), 0.3, device=where)
        w = torch.arange(64, dtype=torch.float32, device=where)

        def grads():
            v = sp.scene.vertices.clone().requires_grad_()
            res = th.trace_rays(sp.scene.with_vertices(v), rays, a, 2, sp.shoot_fn, aux=sp.aux)
            h = th.energy_histogram(res, 64, 1e-3, soft=True)
            loss = (h * w).sum() + torch.where(res.hit, res.t, 0.0).mul(res.energy).sum()
            loss.backward()
            return h.detach(), v.grad

        out[str(where)] = [x.cpu() for x in grads()]
        if where != "cpu":
            again = grads()
            assert all(torch.equal(x.view(torch.int32), y.cpu().view(torch.int32))
                       for x, y in zip(out[str(where)], again))
    for c, k in zip(out["cpu"], out[str(dev)]):
        assert bool(torch.isfinite(k).all())
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4 * float(c.abs().max()))


def test_trace_on_card_matches_cpu(dev):
    """The slice on the card (K1, K2, K3) against the plain versions on the CPU."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    out = {}
    for where in ("cpu", dev):
        sp = th.SpatialPartition(top, domain=4, device=where)
        rays = rays_of(np.random.default_rng(6), 0.3, 2.7, 2048, where)
        a = torch.full((top.n_polys,), 0.3, device=where, requires_grad=True)
        res = th.trace_rays(sp.scene, rays, a, 4, sp.shoot_fn, aux=sp.aux)
        hist = th.energy_histogram(res, 64)
        hist.sum().backward()
        out[str(where)] = [x.detach().cpu() for x in (res.hit, res.poly_id, res.energy, hist, a.grad)]
    c, k = out["cpu"], out[str(dev)]
    assert torch.equal(c[0], k[0]) and torch.equal(c[1], k[1])
    for a, b in zip(c[2:], k[2:]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def scattering_step(sp, rays, n_polys, bounces, remat=False, seed=4):
    """A scattering step (coefficients 0.2-0.8 across the polygons, draws
    from a CPU generator, so the same on every device): the record, the
    histogram and the gradients w.r.t. absorption and scattering."""
    where = rays.origin.device
    a = torch.full((n_polys,), 0.3, device=where, requires_grad=True)
    s = torch.linspace(0.2, 0.8, n_polys, device=where).requires_grad_()
    res = th.trace_rays(sp.scene, rays, a, bounces, sp.shoot_fn, aux=sp.aux, scattering=s,
                        generator=torch.Generator().manual_seed(seed), remat=remat)
    hist = th.energy_histogram(res, 64)
    hist.sum().backward()
    return [x.detach().cpu() for x in res] + [hist.detach().cpu(), a.grad.cpu(), s.grad.cpu()]


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_scattering_trace_on_card_matches_cpu(dev, accel):
    """The scattering step on the card (the traversal, K2, K3, the scatter
    of both gradients) against the plain versions on the CPU, on the same
    draws."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    out = {}
    for where in ("cpu", dev):
        sp = th.SpatialPartition(top, accel=accel, device=where)
        rays = rays_of(np.random.default_rng(6), 0.3, 2.7, 2048, where)
        out[str(where)] = scattering_step(sp, rays, top.n_polys, 4)
    c, k = out["cpu"], out[str(dev)]
    assert bool(c[0].all())
    assert torch.equal(c[0], k[0]) and torch.equal(c[3], k[3])  # hit, poly_id
    for i in (1, 2, 6, 7, 8):  # energy, time, histogram, both gradients
        torch.testing.assert_close(k[i], c[i], rtol=1e-4, atol=1e-4 * float(c[i].abs().max()))


def test_remat_on_card_is_bitwise(dev):
    """Per-bounce remat with scattering on the card: every output and both
    gradients equal to the plain trace's to the bit, K1 and K2 launched
    twice a bounce."""
    faces = shapes.shoebox(4, 5, 3) + shapes.icosphere(2, radius=0.7, center=(2.0, 3.5, 1.2))
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, device=dev)
    rays = rays_of(np.random.default_rng(9), 0.3, 2.7, 4096, dev)
    plain = scattering_step(sp, rays, top.n_polys, 6)
    k1, k2 = launches("hare_grid_shoot"), launches("hare_finalize_hits")
    remat = scattering_step(sp, rays, top.n_polys, 6, remat=True)
    assert launches("hare_grid_shoot") - k1 == launches("hare_finalize_hits") - k2 == 12
    for x, y in zip(plain, remat):
        assert torch.equal(x, y)
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_scene_surface_points_on_card(dev):
    """Area-weighted points on the card: on the room's walls, one seed the
    same points, and the CPU's points for that seed."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    sc = top.scene(device=dev)
    pts = th.scene_surface_points(sc, 100_000, torch.Generator().manual_seed(4))
    assert pts.device.type == "cuda" and pts.shape == (100_000, 3)
    assert torch.equal(pts, th.scene_surface_points(sc, 100_000, torch.Generator().manual_seed(4)))
    size = torch.tensor([4.0, 5.0, 3.0], device=dev)
    assert bool(((pts >= -1e-5) & (pts <= size + 1e-5)).all())
    on = (pts.abs() < 1e-5) | ((pts - size).abs() < 1e-5)
    assert bool(on.any(dim=1).all())
    cpu = th.scene_surface_points(top.scene(device="cpu"), 100_000,
                                  torch.Generator().manual_seed(4), device="cpu")
    torch.testing.assert_close(pts.cpu(), cpu, rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows, cols", [(100, 192), (200_000, 192), (3000, 8)])
def test_column_sum_matches_plain(dev, rows, cols):
    """P1, one band and many bands of rows (each thread several rows)."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(rows, cols)).astype(np.float32)).to(dev)
    before = launches("hare_column_sum")
    out = probes.column_sum(x)
    assert launches("hare_column_sum") == before + 1
    assert probes.sums_agree(out, probes.column_sum_plain(x), probes.column_sum_plain(x.abs()))
    ones = torch.ones(rows, cols, device=dev)
    assert torch.equal(probes.column_sum(ones), probes.column_sum_plain(ones))


# (table rows, width, table dtype, sum dtype, indices, iters).  What the two
# passes make risky (tests/test_torch_probes.py holds the plain version to
# NumPy on the same shapes): no pass 1, one output, row sums that no window
# reaches, rows of 1, 2 and 6 elements (tables ending inside a 16-byte
# word), an int32 table summed in float32 at a wide width, windows that
# wrap more than twice.
GATHER_EDGES = [
    ("iters_0", 50, 8, np.float32, torch.float32, 40, 0),
    ("iters_0_i32", 50, 2, np.int32, torch.int32, 40, 0),
    ("one_output", 300, 192, np.float32, torch.float32, 1, 50),
    ("windows_sparse", 5000, 192, np.float32, torch.float32, 7, 3),
    ("width_1", 1001, 1, np.int32, torch.int32, 300, 17),
    ("width_1_f32", 999, 1, np.float32, torch.float32, 200, 9),
    ("width_2_tail", 1001, 2, np.int32, torch.int32, 500, 9),
    ("width_6", 501, 6, np.float32, torch.float32, 300, 11),
    ("width_6_i32", 77, 6, np.int32, torch.int32, 300, 11),
    ("i32_f32_wide", 400, 384, np.int32, torch.float32, 256, 5),
    ("wrap_4x", 7, 8, np.float32, torch.float32, 100, 30),
    ("wrap_5x_i32", 3, 2, np.int32, torch.int32, 50, 16),
]

# Two shapes for each probe, the second with iters > rows (the wrap), some
# others, and the edges.
GATHERS = [
    ("p2", 23793, 192, np.float32, torch.float32, 1024, 50),
    ("p2_wrap", 7, 192, np.float32, torch.float32, 300, 20),
    ("p3", 110592, 2, np.int32, torch.int32, 32768, 50),
    ("p3_wrap", 13, 2, np.int32, torch.int32, 1000, 40),
    ("p4_meta", 110592, 2, np.int32, torch.float32, 4096, 32),
    ("p4_win", 4096, 384, np.float32, torch.float32, 4096, 8),
    ("p4_ctx_wrap", 5, 8, np.float32, torch.float32, 777, 12),
    ("odd_width", 300, 33, np.float32, torch.float32, 500, 6),
    ("i32_wide", 500, 64, np.int32, torch.int32, 300, 7),
    *GATHER_EDGES,
]


@pytest.mark.parametrize("case", GATHERS, ids=[g[0] for g in GATHERS])
def test_gather_sum_matches_plain(dev, case):
    _, n, width, dtype, out_dtype, n_idx, iters = case
    rng = np.random.default_rng(9)
    if dtype == np.int32:  # full range where the sums wrap, else exact in float32
        hi = 2**31 if out_dtype == torch.int32 else 1000
        tab = rng.integers(-hi, hi, size=(n, width)).astype(np.int32)
    else:
        tab = rng.normal(size=(n, width)).astype(np.float32)
    tab = torch.from_numpy(tab).to(dev)
    idx = torch.from_numpy(rng.integers(-n, n, size=n_idx).astype(np.int32)).to(dev)
    before = launches(*GATHER_ENTRIES)
    out = probes.gather_sum(tab, idx, iters, out_dtype)
    assert launches(*GATHER_ENTRIES) == before + 1
    plain = probes.gather_sum_plain(tab, idx, iters, out_dtype)
    assert out.dtype == plain.dtype == out_dtype
    if out_dtype == torch.int32:  # int32 sums that wrap: exact
        assert torch.equal(out, plain)
    else:
        absolute = probes.gather_sum_plain(tab.abs(), idx, iters, torch.float32)
        assert probes.sums_agree(out, plain, absolute)


@pytest.mark.parametrize("case", [g for g in GATHERS if g[0] in ("p2", "p3", "p4_meta", "p4_win",
                                                                  "odd_width", "width_1")],
                         ids=lambda g: g[0])
def test_gather_sum_repeats_bitwise(dev, case):
    """Two calls on the same inputs give the same bits: each row sum and
    each window is added in one order, with no atomics."""
    _, n, width, dtype, out_dtype, n_idx, iters = case
    rng = np.random.default_rng(10)
    tab = (rng.integers(-1000, 1000, size=(n, width)) if dtype == np.int32
           else rng.normal(size=(n, width))).astype(dtype)
    tab = torch.from_numpy(tab).to(dev)
    idx = torch.from_numpy(rng.integers(-n, n, size=n_idx).astype(np.int32)).to(dev)
    a = probes.gather_sum(tab, idx, iters, out_dtype)
    b = probes.gather_sum(tab, idx, iters, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------- K4
# K4's lobe calls cosf and sinf built with -fmad=false, torch's cos and sin
# may round another way: a diffuse lane's direction within an ulp or two of
# a unit vector's component, and the gradients through the lobe within a
# few ulps of the largest.
K4_LOBE_ATOL = 1e-6
K4_LOBE_GRAD_RTOL = 1e-5


def k4_inputs(dev, scattering, n=8192, bounces=3):
    """Each bounce's step inputs of a grid trace on the card: the room with a
    sphere, rays from inside, per-polygon absorption and scattering."""
    from hare_tpu_torch.benchmarks.bench_scene import bounce_inputs

    faces = shapes.shoebox(4, 5, 3) + shapes.icosphere(2, radius=0.7, center=(2.0, 3.5, 1.2))
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, device=dev)
    rays = rays_of(np.random.default_rng(12), 0.3, 2.7, n, dev)
    a = torch.linspace(0.1, 0.6, top.n_polys, device=dev)
    s = torch.linspace(0.8, 0.2, top.n_polys, device=dev) if scattering else None
    kw = dict(scattering=s, generator=torch.Generator().manual_seed(2)) if scattering else {}
    return sp, a, s, bounce_inputs(sp, rays, a, bounces, **kw)


def k4_cotangents(dev, n, seed):
    g = torch.Generator().manual_seed(seed)
    shapes_ = [(n, 3), (n, 3), (n,), (n,), (n,), (n,), (n,)]
    return tuple(torch.randn(sh, generator=g).to(dev) for sh in shapes_)


@pytest.mark.parametrize("scattering", [False, True], ids=["specular", "scattering"])
def test_bounce_kernel_matches_plain(dev, scattering):
    """K4 forward against bounce_step on the same card tensors, each bounce:
    every output to the bit, the direction of a diffuse lane (the lobe's
    cos and sin) within K4_LOBE_ATOL; two launches bitwise equal; a record
    without edge_nbr reads tri_meta to the same bits."""
    from hare_tpu_torch.trace import bounce

    sp, a, s, steps = k4_inputs(dev, scattering)
    for state, hr, draws, ss, tri_meta in steps:
        k = bounce.bounce_kernel(state, hr, a, s, draws, ss, tri_meta)
        p = bounce.bounce_step(state, hr, a, s, draws, ss)
        again = bounce.bounce_kernel(state, hr._replace(edge_nbr=None), a, s, draws, ss, tri_meta)
        for x, y, z in zip(list(k[0]) + list(k[1]), list(p[0]) + list(p[1]),
                           list(again[0]) + list(again[1])):
            assert same_bits(x, z)
            if x is k[0].direction and scattering:
                dif = draws[0]
                assert same_bits(x[~dif], y[~dif])
                torch.testing.assert_close(x[dif], y[dif], rtol=0, atol=K4_LOBE_ATOL)
            else:
                assert same_bits(x, y)


@pytest.mark.parametrize("wanted", ["energy", "geometry", "all"])
@pytest.mark.parametrize("scattering", [False, True], ids=["specular", "scattering"])
def test_bounce_bwd_kernel_matches_plain(dev, scattering, wanted):
    """K4's backward against autograd through bounce_step on the same card
    tensors, from seeded cotangents: the energy chain (energy, the tables
    summed by polygon) and the distance, origin and point to the bit; the
    direction and normal to the bit on the specular branch, within
    K4_LOBE_GRAD_RTOL of the largest with scattering; absent cotangents
    and gradients not asked for stay None."""
    from hare_tpu_torch.trace import bounce

    sp, a, s, steps = k4_inputs(dev, scattering)
    flags = {"energy": (1, 0, 0, 0, 0, 0, 0, 1, 1), "geometry": (0, 1, 1, 1, 1, 1, 1, 0, 0),
             "all": (1,) * 9}[wanted]
    want = tuple(bool(f) and not (k == 8 and s is None) for k, f in enumerate(flags))
    for b, (state, hr, draws, ss, _) in enumerate(steps):
        cot = k4_cotangents(dev, state.energy.shape[0], b)
        if b == len(steps) - 1:  # the last bounce: no next state
            cot = (None, None, None, None) + cot[4:]
        args = (state, hr, a, s, draws, cot, want, ss)
        k = bounce.bounce_step_bwd(*args)
        p = bounce.bounce_bwd_plain(*args)
        assert all(same_bits(x, y) for x, y in zip(k, bounce.bounce_step_bwd(*args))
                   if x is not None)
        for name, x, y in zip(bounce.GRADS, k, p):
            assert (x is None) == (y is None), name
            if x is None:
                continue
            if scattering and name in ("direction", "normal"):
                torch.testing.assert_close(x, y, rtol=0,
                                           atol=K4_LOBE_GRAD_RTOL * float(y.abs().max()))
            else:
                assert same_bits(x, y), name


def test_bounce_kernel_launches_and_remat(dev):
    """A trace on the card launches K4 once a bounce forward and once a
    bounce backward; with remat the forward twice; the same bits."""
    from hare_tpu_torch.trace import bounce

    sp, a, s, _ = k4_inputs(dev, True, n=4096, bounces=1)
    rays = rays_of(np.random.default_rng(13), 0.3, 2.7, 4096, dev)
    out = []
    for remat in (False, True):
        fwd, bwd = launches("hare_bounce_step"), launches("hare_bounce_step_bwd")
        aa, ss_ = a.clone().requires_grad_(), s.clone().requires_grad_()
        res = th.trace_rays(sp.scene, rays, aa, 5, sp.shoot_fn, aux=sp.aux, scattering=ss_,
                            generator=torch.Generator().manual_seed(1), remat=remat)
        th.energy_histogram(res, 64).sum().backward()
        torch.cuda.synchronize()
        assert launches("hare_bounce_step") - fwd == (10 if remat else 5)
        assert launches("hare_bounce_step_bwd") - bwd == 5
        out.append([res.energy.detach(), res.time.detach(), aa.grad, ss_.grad])
    assert all(same_bits(x, y) for x, y in zip(*out))


@pytest.mark.parametrize("accel, site, walk", [("octree", "tree_flag", "hare_tree_shoot"),
                                                ("kdtree_ropes", "ropes_flag", "hare_ropes_shoot")])
def test_step_counters_on_card(dev, accel, site, walk):
    """A fwd+bwd trace of k bounces through a tree walk reads the walk's
    flag k times (syncs.<site>, each a hare.sync span holding its read),
    and counts each entry point's launches as the wrappers' own counters
    did: the walk, K2, K4 and its backward and the absorption scatter once
    a bounce, K3 and its backward once, in its hard mode, nothing else."""
    k, n = 3, 4096
    faces = shapes.shoebox(4, 5, 3) + shapes.icosphere(2, radius=0.7, center=(2.0, 3.5, 1.2))
    top = th.Topology.build(faces)
    sp = th.SpatialPartition(top, accel=accel, device=dev)
    rays = rays_of(np.random.default_rng(5), 0.3, 2.7, n, dev)
    a = torch.full((top.n_polys,), 0.3, device=dev, requires_grad=True)
    th.energy_histogram(th.trace_rays(sp.scene, rays, a, k, sp.shoot_fn, aux=sp.aux), 64).sum()
    torch.cuda.synchronize()
    tracing.reset()
    tracing.enable()
    try:
        res = th.trace_rays(sp.scene, rays, a, k, sp.shoot_fn, aux=sp.aux)
        th.energy_histogram(res, 64).sum().backward()
        torch.cuda.synchronize()
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    want = {walk: k, "hare_finalize_hits": k, "hare_bounce_step": k, "hare_bounce_step_bwd": k,
            "hare_scatter_add_ordered": k, "hare_energy_histogram": 1, "hare_histogram_bwd": 1}
    assert snap.counters == {f"syncs.{site}": k, "rays.shot": k * n, "histogram_bwd.hard": 1,
                             **{f"launches.{e}": c for e, c in want.items()}}
    syncs = [s for s in snap.spans if s.name == "hare.sync"]
    assert [s.attrs["site"] for s in syncs] == [site] * k
    traverse = {s.seq: s for s in snap.spans if s.name == "hare.traverse"}
    assert len(traverse) == k and all(s.parent in traverse for s in syncs)


def test_nccl_world_one_train_step_is_unsharded(dev):
    """make_train_step over a one-rank NCCL group: two Adam steps equal the
    same steps without the group (trace, histogram, loss, backward, Adam) to
    the bit."""
    import socket

    import torch.distributed as tdist

    from hare_tpu_torch import dist as hd

    sp, a, _, _ = k4_inputs(dev, False, n=4096, bounces=1)
    rays = rays_of(np.random.default_rng(14), 0.3, 2.7, 4096, dev)
    n_polys = a.shape[0]
    with torch.no_grad():
        target = th.energy_histogram(th.trace_rays(sp.scene, rays, a, 3, sp.shoot_fn,
                                                   aux=sp.aux), 64)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    hd.init_distributed("cuda", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        p1 = {"absorption": torch.zeros(n_polys, device=dev, requires_grad=True)}
        opt1 = torch.optim.Adam(p1.values(), lr=0.1)
        step = hd.make_train_step(sp.shoot_fn, opt1, 3, 64)
        sharded = [step(p1, sp.scene, rays, target, sp.aux) for _ in range(2)]
    finally:
        tdist.destroy_process_group()
    p2 = torch.zeros(n_polys, device=dev, requires_grad=True)
    opt2 = torch.optim.Adam([p2], lr=0.1)
    plain = []
    for _ in range(2):
        opt2.zero_grad(set_to_none=True)
        res = th.trace_rays(sp.scene, rays, torch.sigmoid(p2), 3, sp.shoot_fn, aux=sp.aux)
        loss = torch.sum((th.energy_histogram(res, 64) - target) ** 2) / 64
        loss.backward()
        opt2.step()
        plain.append(loss.detach())
    assert all(same_bits(x, y) for x, y in zip(sharded, plain))
    assert same_bits(p1["absorption"].detach(), p2.detach())
    assert float(sharded[1]) < float(sharded[0])


@pytest.fixture
def nccl_group(dev):
    """An NCCL group of one, as the programs join it, destroyed after."""
    from hare_tpu_torch.examples._group import join_group, leave_group

    made = join_group(dev)
    yield
    leave_group(made)


def small_config(**kw):
    from hare_tpu_torch.utils import HareConfig

    return HareConfig(n_rays=2048, n_bounces=3, n_bins=64, **kw)


def test_fit_absorption_on_card_matches_cpu(dev):
    """chip_smoke.py phase 11 at a small size: the program's loop on the
    card (an NCCL group of one) against the same loop on the CPU (a gloo
    group of one) on the same rays: the parameters within 1e-4 (f32 sums
    in another order); each step's loss within 1e-3, since K2's floats
    agree with its plain version's within 1e-5, not to the bit, so a lane
    whose arrival time sits at a bin edge may bin apart (chip_smoke.py's
    CPU references mask such lanes; here one moved the loss by 1.9e-4)."""
    from hare_tpu_torch.examples import fit_absorption as fa
    from hare_tpu_torch.examples._group import join_group, leave_group

    cfg = small_config()
    out = {}
    for where in (dev, torch.device("cpu")):
        made = join_group(where)
        try:
            out[where.type] = fa.fit(fa.setup(cfg, False, where), cfg, 3, where, time_iters=0)
        finally:
            leave_group(made)
    card, host = out["cuda"], out["cpu"]
    np.testing.assert_allclose(card["losses"], host["losses"], rtol=1e-3)
    for k, v in host["params"].items():
        np.testing.assert_allclose(card["params"][k].cpu().numpy(), v.numpy(), rtol=0, atol=1e-4)


def test_fit_programs_on_card_repeat_and_resume(dev, nccl_group, tmp_path):
    """One step of each program repeats to the bit (determinism_check);
    torch.rand of the card's generator does not; an absorption fit with
    scattering interrupted at step 2 and resumed from its checkpoint
    (parameters, Adam's state, the generator's state, the cursor) ends
    bit-equal, its parameters restored onto the card."""
    from hare_tpu_torch.examples import fit_absorption as fa
    from hare_tpu_torch.examples import fit_vertices as fv
    from hare_tpu_torch.utils import determinism_check

    cfg = small_config()
    prob = fa.setup(cfg, True, dev)
    prob_v = fv.setup(cfg, dev)
    assert determinism_check(lambda: fa.fit(prob, cfg, 1, dev, time_iters=0)["params"])
    assert determinism_check(lambda: fv.fit(prob_v, cfg, 1, 25, dev, time_iters=0)["params"])
    with pytest.raises(AssertionError, match="differs"):
        determinism_check(lambda: torch.rand(100, device=dev))
    ref = fa.fit(prob, cfg, 4, dev, time_iters=0)
    ck = cfg.replace(checkpoint_dir=str(tmp_path / "ck"))

    def fail(i):
        if i == 2:
            raise RuntimeError("injected")

    with pytest.raises(RuntimeError, match="injected"):
        fa.fit(prob, ck, 4, dev, on_step=fail, time_iters=0)
    resumed = fa.fit(prob, ck, 4, dev, time_iters=0)
    assert resumed["start"] == 1 and resumed["losses"] == ref["losses"][1:]
    for k, v in ref["params"].items():
        assert same_bits(resumed["params"][k], v) and resumed["params"][k].device.type == "cuda"


def test_restore_state_places_on_the_template_device(dev, tmp_path):
    """restore_state puts each tensor on its template tensor's device (the
    card where the template is there), never on the CPU instead; timed
    synchronises the result's device."""
    from hare_tpu_torch.utils import restore_state, save_state, timed

    x = torch.arange(6.0, device=dev)
    save_state(str(tmp_path), 0, {"x": x, "y": torch.ones(2), "n": 3})
    out = restore_state(str(tmp_path), {"x": torch.zeros(6, device=dev), "y": torch.zeros(2),
                                        "n": 0})
    assert out["x"].device == x.device and out["y"].device.type == "cpu"
    assert torch.equal(out["x"], x) and out["n"] == 3
    only = restore_state(str(tmp_path), {"x": torch.zeros(6, device=dev),
                                         "y": torch.zeros(2, device=dev), "n": 0})
    assert only["y"].device.type == "cuda"
    dt, y = timed(lambda: x * 2, iters=3)
    assert dt > 0 and y.device.type == "cuda"
