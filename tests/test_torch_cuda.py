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
from hare_tpu_torch.accel.scatter import scatter_add_ordered, scatter_add_plain  # noqa: E402
from hare_tpu_torch.accel.tree import tree_shoot, tree_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.voxel import build_voxel_grid, grid_shoot, grid_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import a3_check  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe as probes  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402
from hare_tpu_torch.geom.intersect import ray_triangle_mt, ray_triangle_watertight  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import (  # noqa: E402
    histogram_kernel,
    histogram_plain,
    soft_histogram_bwd,
    soft_histogram_bwd_plain,
    soft_histogram_plain,
)

pytestmark = pytest.mark.cuda

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
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_brute_shoot_matches_plain(dev, name, faces, kw, box, kernel):
    """B1 against its plain version, to the bit, with and without
    exclusions."""
    sc = th.Topology.build(faces()).scene(device=dev)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)

    def agree(rays):
        k = brute_shoot(sc, rays, kernel)
        assert_bit_equal(k, brute_shoot_plain(sc, rays, kernel))
        return k

    first = agree(rays)
    poly = torch.where(first[1] >= 0, sc.tri_poly[first[1].clamp(min=0).long()], -1)
    agree(rays._replace(exclude_poly=torch.stack([poly, torch.full_like(poly, -1)], 1).int()))


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


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("m, n_keys", [(1, 4), (5000, 3), (300_000, 40_000), (1_000_000, 200)])
def test_scatter_matches_cpu(dev, m, n_keys, cols):
    """The fixed-order scatter on the card equals its plain version on the
    CPU to the bit (index_add_ a segment of sorted positions, the segments
    in order), with long runs (few keys), many short ones and unused keys;
    two launches give the same bits."""
    rng = np.random.default_rng(m + cols)
    keys = (rng.zipf(1.5, m) % n_keys).astype(np.int32)  # skewed: long runs
    values = rng.normal(size=(m,) if cols == 1 else (m, cols)).astype(np.float32)
    k_t, v_t = torch.from_numpy(keys), torch.from_numpy(values)
    want = scatter_add_plain(k_t, v_t, n_keys)
    got = scatter_add_ordered(k_t.to(dev), v_t.to(dev), n_keys)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    again = scatter_add_ordered(k_t.to(dev), v_t.to(dev), n_keys)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


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


@pytest.mark.parametrize("rows, cols", [(100, 192), (200_000, 192), (3000, 8)])
def test_column_sum_matches_plain(dev, rows, cols):
    """P1, one band and many bands of rows (each thread several rows)."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(rows, cols)).astype(np.float32)).to(dev)
    before = probes.column_sum.launches
    out = probes.column_sum(x)
    assert probes.column_sum.launches == before + 1
    assert probes.sums_agree(out, probes.column_sum_plain(x), probes.column_sum_plain(x.abs()))
    ones = torch.ones(rows, cols, device=dev)
    assert torch.equal(probes.column_sum(ones), probes.column_sum_plain(ones))


# (table rows, width, table dtype, sum dtype, indices, iters): two shapes for
# each probe, the second with iters > rows (the wrap).
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
    before = probes.gather_sum.launches
    out = probes.gather_sum(tab, idx, iters, out_dtype)
    assert probes.gather_sum.launches == before + 1
    plain = probes.gather_sum_plain(tab, idx, iters, out_dtype)
    assert out.dtype == plain.dtype == out_dtype
    if out_dtype == torch.int32:  # int32 sums that wrap: exact
        assert torch.equal(out, plain)
    else:
        absolute = probes.gather_sum_plain(tab.abs(), idx, iters, torch.float32)
        assert probes.sums_agree(out, plain, absolute)
