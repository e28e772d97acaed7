"""The work counts and bounds the port's kernels are measured against.

``voxel.grid_work`` replays K1's plain march with counts (cells visited,
non-null window slots tested); ``common.tally_runs`` records the runs a
plain traversal hands ``test_runs``; ``benchmarks/bounds.py`` turns counts
and shapes into each kernel's bound.  Hand-counted rays through a small
grid, and the counts against the plain march on the JAX package's parity
scenes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel import common, voxel  # noqa: E402
from hare_tpu_torch.accel.ropes import build_kdtree_ropes, ropes_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.tree import tree_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import bounds  # noqa: E402
from hare_tpu_torch.benchmarks import k1_sweep  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402
from hare_tpu_torch.geom.intersect import MIN_T  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"


def tri(x, y, z, s):
    """A right triangle in the plane x = const, legs ``s`` along +y and +z
    from its corner (x, y, z)."""
    return np.array([[x, y, z], [x, y + s, z], [x, y, z + s]], np.float64)


def line_scene():
    """A 4^3 grid over [0, 4]^3 (two corner triangles fix the extent) with
    targets on the line y = z = 2.5: one triangle at x = 1.5 (cell (1,2,2)),
    and at x = 2.5 twenty triangles in cell (2,2,2) — one across the line,
    nineteen small ones off it — so that cell has two window rows, the
    second with 12 null slots."""
    faces = [tri(0.0, 0.0, 0.0, 0.1), tri(4.0, 3.9, 3.9, 0.1), tri(1.5, 2.3, 2.3, 0.5),
             tri(2.5, 2.3, 2.3, 0.5)]
    faces += [tri(2.5, 2.05 + 0.04 * k, 2.05, 0.03) for k in range(19)]
    top = th.Topology.build(faces)
    grid = voxel.build_voxel_grid(top, domain=4, device=CPU)
    return top, grid


def test_grid_work_hand_counted():
    top, grid = line_scene()
    assert grid.dims == (4, 4, 4) and grid.win_geom.shape[1] == 16
    meta = grid.cell_meta.view(4, 4, 4, 2)
    assert int(meta[1, 2, 2, 1]) >> 8 == 1 and int(meta[2, 2, 2, 1]) >> 8 == 2
    assert all(int(meta[i, 2, 2, 1]) & 0xFF <= 1 for i in range(4))  # no jumps on the line
    sp = th.SpatialPartition(top, domain=4, device=CPU)
    o = torch.tensor([[0.2, 2.5, 2.5], [3.8, 2.5, 2.5]])
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    first = sp.shoot(th.Ray.make(o, d))
    near, far = (int(p) for p in first.poly_id)  # the x = 1.5 and x = 2.5 targets
    assert near != far and bool(first.hit.all())
    rays = th.Ray.make(
        torch.tensor([[0.2, 2.5, 2.5]] * 3 + [[3.8, 2.5, 2.5]]),
        torch.tensor([[1.0, 0.0, 0.0]] * 3 + [[-1.0, 0.0, 0.0]]),
        torch.tensor([[-1, -1], [near, -1], [near, far], [-1, -1]], dtype=torch.int32),
    )
    work = voxel.grid_work(rays, grid)
    # +x: stops after the x = 1.5 cell; past it, tests the 20 of cell
    # (2,2,2) and stops there; past both, crosses all four cells; -x:
    # enters (3,2,2), then stops in (2,2,2).
    assert work.cells.tolist() == [2, 3, 4, 2]
    assert work.slots.tolist() == [1, 21, 21, 20]
    # The slots of the three rows touched: 1 at x = 1.5, 16 + 4 at x = 2.5.
    assert work.cells_touched == 4 and work.slots_touched == 21
    best_t, best_tri = voxel.grid_shoot_plain(rays, grid)
    assert torch.equal(torch.isfinite(best_t), torch.tensor([True, True, False, True]))
    b = bounds.grid_shoot_bound(work)
    assert b["ops"] == 63 * 43 and bounds.TRI_TEST_OPS["watertight"] == 43
    # Each ray (24 + 8 bytes) and its nearest hit (8), each cell_meta entry
    # (8) and each non-null slot (9 f32 + 3 i32) once.
    assert b["bytes"] == 4 * 40 + 4 * 8 + 21 * 48 and b["bound_by"] == "bytes"


SCENES = [
    ("shoebox", lambda: shapes.shoebox(4, 5, 3), dict(domain=4), (0.2, 4.8)),
    ("icosphere", lambda: shapes.shoebox(4, 5, 3) + shapes.icosphere(2, 0.8, (2.0, 2.5, 1.5)),
     dict(domain=6), (0.2, 2.8)),
    ("soup", lambda: shapes.random_soup(300, seed=11), dict(avg_polys=8.0), (-1.0, 11.0)),
    ("hall", shapes.concert_hall, dict(domain=8), (2.0, 16.0)),
]


@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_grid_work_matches_plain_march(name, faces, kw, box):
    """On the rays of three bounces, the slots ``grid_work`` counts are the
    non-null slots of the runs the plain march hands ``test_runs``, and the
    march's answer is the plain version's."""
    top = th.Topology.build(faces())
    sp = th.SpatialPartition(top, device=CPU, **kw)
    rng = np.random.default_rng(7)
    o = torch.from_numpy(rng.uniform(box[0], box[1], (256, 3)).astype(np.float32))
    d = rng.normal(size=(256, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    a = torch.full((top.n_polys,), 0.3)
    for rays in bounce_rays(sp, th.Ray.make(o, d), a):
        work = voxel.grid_work(rays, sp.struct)
        with common.tally_runs() as runs:
            plain = voxel.grid_shoot_plain(rays, sp.struct)
        slots, touched = bounds.runs_work(runs, sp.struct.win_ids)
        assert int(work.slots.sum()) == slots and work.slots_touched == touched
        assert touched <= slots
        assert int(work.cells.max()) <= sum(sp.struct.dims) + 3
        again = voxel._grid_march(rays, sp.struct, "watertight", MIN_T, None, True)
        assert torch.equal(again[0], plain[0]) and torch.equal(again[1], plain[1])


def test_runs_work_counts_overlaps_once():
    ids = torch.full((5, 4, 4), -1, dtype=torch.int32)
    ids[0, :, 0] = torch.tensor([0, 1, 2, 3])
    ids[1, :2, 0] = torch.tensor([4, 5])
    ids[2, :1, 0] = 6
    runs = [(torch.tensor([0, 1]), torch.tensor([2, 2])), (torch.tensor([3]), torch.tensor([1]))]
    # Tested: rows 0-1, 1-2 and 3 (row 1 twice); distinct: rows 0-3 once.
    assert bounds.runs_work(runs, ids) == (4 + 2 + 2 + 1 + 0, 4 + 2 + 1 + 0)


def test_tree_walks_tally_runs():
    """The runs the plain tree and rope walks test lie in their window
    tables and hold the leaves' triangles; the bound is positive."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3) + shapes.icosphere(2, 0.8, (2.0, 2.5, 1.5)))
    rng = np.random.default_rng(2)
    o = torch.from_numpy(rng.uniform(0.3, 2.7, (128, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32)), dim=1)
    rays = th.Ray.make(o, d)
    for tree, shoot, visit_ops in (
        (th.build_octree(top, device=CPU), tree_shoot_plain, 8 * bounds.SLAB_OPS),
        (build_kdtree_ropes(top, device=CPU), ropes_shoot_plain, bounds.EXIT_OPS),
    ):
        with common.tally_runs() as runs:
            _, best_tri, visits = shoot(rays, tree, with_stats=True)
        slots, touched = bounds.runs_work(runs, tree.win_ids)
        assert 0 < touched <= int((tree.win_ids[..., 0] >= 0).sum()) and touched <= slots
        assert slots >= int((best_tri >= 0).sum())
        b = bounds.walk_bound(128, slots, touched, int(visits.sum()), visit_ops)
        assert b["bound_ms"] > 0
        assert b["bytes"] == 128 * 40 + touched * 48
        assert b["ops"] == slots * 43 + int(visits.sum()) * visit_ops
    assert common._tally is None  # the tally ends with its block


def test_bounds_from_shapes():
    # B1 on the bench shoot: 32,768 rays x 81,932 triangles, 43 operations a
    # watertight test, 44 a Möller-Trumbore one.
    b1 = bounds.brute_shoot_bound(32768, 81932)
    assert b1["ops"] == 32768 * 81932 * 43 and b1["bound_by"] == "operations"
    assert b1["bound_ms"] == pytest.approx(32768 * 81932 * 43 / 67e12 * 1e3)
    assert bounds.brute_shoot_bound(32768, 81932, "mt")["ops"] == 32768 * 81932 * 44
    # P1: 120 MB of float32 ones, read once.
    rows = int(120 * 1e6) // 768
    p1 = bounds.column_sum_bound(rows, 192)
    assert p1["bound_by"] == "bytes" and p1["bound_ms"] == pytest.approx((rows + 1) * 768 / 3.35e12 * 1e3)
    # P2-P4: the rows the wrapped gathers reach, counted once.
    tab = torch.zeros(10, 4)
    idx = torch.tensor([0, 8, 1], dtype=torch.int32)  # reach 0,1,2 / 8,9,0 / 1,2,3
    g = bounds.gather_sum_bound(tab, idx, 3, torch.float32)
    assert g["bytes"] == 6 * 16 + 3 * 8 and g["ops"] == 3 * 3 * 4
    # K2: distinct winners' rows once; misses add no operations.
    k2 = bounds.finalize_hits_bound(torch.tensor([5, 5, -1, 7], dtype=torch.int32))
    assert k2["ops"] == 3 * (43 + 17)
    assert k2["bytes"] == 4 * (8 + 24 + bounds.HIT_RECORD_BYTES) + 2 * (36 + 32)
    # K3: the trace record's lanes in, the bins out.
    k3 = bounds.histogram_bound(torch.tensor([[True, False], [True, True]]), 16)
    assert k3["ops"] == 3 * 2 and k3["bytes"] == 4 * 9 + 16 * 4 and k3["bound_by"] == "bytes"


@pytest.mark.parametrize("label, replacements", k1_sweep.CANDIDATES,
                         ids=[c[0] for c in k1_sweep.CANDIDATES])
def test_k1_sweep_candidates_apply(label, replacements):
    """Every design candidate of the sweep is the built K1 with its few
    statements replaced, each found exactly once."""
    from hare_tpu_torch.kernels import build

    src = (build.CSRC / "grid_shoot.cu").read_text()
    out = k1_sweep.variant_source(src, replacements)
    assert (out == src) == (not replacements)
    assert out.count("hare::test_run_group<MT, kGroup>") == 1
    if replacements:
        with pytest.raises(ValueError):  # a statement the kernel does not hold
            k1_sweep.variant_source("", replacements)


def test_k1_sweep_reads_the_entry_point():
    """The sweep calls each candidate, a parent's included, through the
    parameters its source declares."""
    from hare_tpu_torch.kernels import build

    src = (build.CSRC / "grid_shoot.cu").read_text()
    params = k1_sweep._c_params(src)
    assert [n for n, _ in params] == list(k1_sweep._ARG_NAMES) + ["counter", "stream"]
    assert [t for _, t in params] == build._SIGNATURES["hare_grid_shoot"]
    older = ('extern "C" int hare_grid_shoot(const float* o, const float* d, const int* ex, '
             'int n, const int* cell_meta, const float* win_geom, const int* win_ids, '
             'const float* fparams, const int* iparams, float* best_t, int* best_tri, '
             'void* stream) {')
    assert [n for n, _ in k1_sweep._c_params(older)] == list(k1_sweep._ARG_NAMES) + ["stream"]
