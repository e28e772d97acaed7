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
from hare_tpu_torch.accel.common import finalize_hits, finalize_hits_plain  # noqa: E402
from hare_tpu_torch.accel.kdtree import build_kdtree  # noqa: E402
from hare_tpu_torch.accel.octree import build_octree  # noqa: E402
from hare_tpu_torch.accel.ropes import build_kdtree_ropes, ropes_shoot, ropes_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.tree import tree_shoot, tree_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.voxel import build_voxel_grid, grid_shoot, grid_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe as probes  # noqa: E402
from hare_tpu_torch.geom.intersect import ray_triangle_mt, ray_triangle_watertight  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import histogram_kernel, histogram_plain  # noqa: E402

pytestmark = pytest.mark.cuda

# Kernel and plain version run the same f32 arithmetic; nvcc contracts some
# of it into FMAs, so hit distances agree to a few ulps.
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


def assert_same_nearest(kernel_out, plain_out, tie_share=1e-3):
    (tk, ik), (tp, ip) = kernel_out, plain_out
    hit = torch.isfinite(tp)
    assert torch.equal(torch.isfinite(tk), hit)
    torch.testing.assert_close(tk[hit], tp[hit], rtol=RTOL, atol=ATOL)
    flips = (ik != ip) & hit
    assert int(flips.sum()) <= max(1, int(hit.numel() * tie_share))  # equal-t ties only


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
# Share of rays whose tri_id may differ between kernel and plain version,
# per scene (default 1e-3); each such ray must be a genuine tie
# (assert_ties_genuine).  The hall's coincident faces (the stage's underside
# on the floor, the balconies' backs on the walls) tie on equal t between
# polygons, and nvcc's FMA contraction of the watertight test rounds such a
# pair an ulp apart where the plain version does not.  On an H100: 11-12 of
# 4,096 rays for every traversal; 123 once each ray's first polygon is
# excluded, since shooting on through the stage's top reaches the pair.
TIE_SHARE = {"hall": 5e-2}


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_grid_shoot_matches_plain(dev, name, faces, kw, box, kernel):
    top = th.Topology.build(faces())
    grid = build_voxel_grid(top, device=dev, **kw)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    k, p = grid_shoot(rays, grid, kernel), grid_shoot_plain(rays, grid, kernel)
    assert_same_nearest(k, p, TIE_SHARE.get(name, 1e-3))
    assert_ties_genuine(top.scene(device=dev), rays, k, p, kernel)


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
        assert_same_nearest(grid_shoot(rays, sp.struct, top_index=top_index),
                            grid_shoot_plain(rays, sp.struct, top_index=top_index))


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_brute_shoot_matches_plain(dev, name, faces, kw, box, kernel):
    """B1 against its plain version, with and without exclusions."""
    sc = th.Topology.build(faces()).scene(device=dev)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    share = TIE_SHARE.get(name, 1e-3)

    def agree(rays):
        k, p = brute_shoot(sc, rays, kernel), brute_shoot_plain(sc, rays, kernel)
        assert_same_nearest(k, p, share)
        assert_ties_genuine(sc, rays, k, p, kernel)
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
    """B2 (K = 2, 4, 8) and B3 against their plain versions, the pops or
    steps included on all but a few rays (an ulp of t can prune differently).
    Rays that miss the root box take no rope step."""
    top = th.Topology.build(faces())
    tree = TREES[which](top, dev, max_tris_per_node=4)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    share = TIE_SHARE.get(name, 1e-3)
    k, p = walk_pair(which, rays, tree, kernel)
    assert_same_nearest(k[:2], p[:2], share)
    assert_ties_genuine(top.scene(device=dev), rays, k[:2], p[:2], kernel)
    assert int((k[2] != p[2]).sum()) <= max(1, int(rays.origin.shape[0] * share))
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
# same tables and tie rule) a walk flips only where nvcc's FMA contraction
# rounds a tie an ulp apart: 5-6 of 4,096 rays on an H100.
PLANE_TIE_SHARE, PLANE_PLAIN_TIE_SHARE = 1e-2, 2e-3


@pytest.mark.parametrize("which", sorted(TREES))
def test_tree_walks_on_planes(dev, which):
    """Split-plane and face-parallel rays (pad 0, so the root box lies on the
    walls): kernel and plain version take the same walk.  Off the root-box
    faces, they hit what brute force hits; a ray lying in a root-box max face
    with a zero direction component there leaves the stack walk's slab test
    at t = 0 (``where(d == 0, 1e-30, d)``, as in the JAX package), so those
    rays are held to the plain version only.  These rays cross edges and
    vertices on purpose, so the test is the watertight one: Möller-Trumbore
    has no edge rule that survives nvcc's FMA contraction."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3) + shapes.icosphere(2, 0.8, (2.0, 2.5, 1.5)))
    sc = top.scene(device=dev)
    tree = TREES[which](top, dev, pad=0.0, max_tris_per_node=4)
    rays = plane_rays(tree, 0.0, 3.0, 4096, dev)
    o = rays.origin
    inner = ~((o == tree.root_min) | (o == tree.root_max)).any(dim=1)
    assert int(inner.sum()) > 2000
    sub = th.Ray(*(x[inner] for x in rays))
    k, p = walk_pair(which, rays, tree, "watertight")
    assert_same_nearest(k[:2], p[:2], PLANE_PLAIN_TIE_SHARE)
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
            assert_same_nearest(k[:2], p[:2])
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
    g = torch.Generator(device=dev).manual_seed(0)
    energy = torch.rand(3, 50_000, generator=g, device=dev)
    time = torch.rand(3, 50_000, generator=g, device=dev) * 1.2 - 0.1
    hit = torch.rand(3, 50_000, generator=g, device=dev) < 0.9
    for n_bins in (1024, 20_000):  # shared-memory and global-atomic paths
        hk = histogram_kernel(energy, time, hit, n_bins, 1e-3)
        hp = histogram_plain(energy, time, hit, n_bins, 1e-3)
        # Float atomics add in a varying order: per-bin sums agree to f32
        # rounding of the bin total.
        torch.testing.assert_close(hk, hp, rtol=1e-5, atol=1e-5 * float(hp.abs().max()))


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
