"""The work counts and bounds the port's kernels are measured against.

``voxel.grid_work`` replays K1's plain march with counts (cells visited,
non-null window slots tested); ``common.tally_runs`` records the runs a
plain traversal hands ``test_runs``, ``common.tally_rows`` the node rows a
plain tree or rope walk reads; ``benchmarks/bounds.py`` turns counts and
shapes into each kernel's bound.  Hand-counted rays through a small grid
and a two-leaf tree, and the counts against the plain march on the JAX
package's parity scenes.  The design sweep's candidates and A3's planted
faults apply to the built kernel sources, and they are called through the
parameters each source declares; every C entry point's ctypes signature
matches its declaration.  A3's element-by-element agreement counts what
lies outside its tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel import common, voxel  # noqa: E402
from hare_tpu_torch.accel.kdtree import build_kdtree  # noqa: E402
from hare_tpu_torch.accel.ropes import build_kdtree_ropes, ropes_shoot_plain  # noqa: E402
from hare_tpu_torch.accel.tree import tree_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import a3_check, bounds  # noqa: E402
from hare_tpu_torch.benchmarks import kernel_sweep  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402
from hare_tpu_torch.geom.intersect import MIN_T  # noqa: E402
from hare_tpu_torch.kernels import build  # noqa: E402
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
    tables and hold the leaves' triangles; the node rows they read lie in
    their tables; the bound counts both."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3) + shapes.icosphere(2, 0.8, (2.0, 2.5, 1.5)))
    rng = np.random.default_rng(2)
    o = torch.from_numpy(rng.uniform(0.3, 2.7, (128, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32)), dim=1)
    rays = th.Ray.make(o, d)
    for tree, shoot, branch in (
        (th.build_octree(top, device=CPU), tree_shoot_plain, 8),
        (build_kdtree_ropes(top, device=CPU), ropes_shoot_plain, None),
    ):
        with common.tally_runs() as runs, common.tally_rows() as rows:
            _, best_tri, visits = shoot(rays, tree, with_stats=True)
        slots, touched = bounds.runs_work(runs, tree.win_ids)
        assert 0 < touched <= int((tree.win_ids[..., 0] >= 0).sum()) and touched <= slots
        assert slots >= int((best_tri >= 0).sum())
        n_rows = tree.child_box.shape[0] if branch else tree.node.shape[0]
        assert all(bool((i < n_rows).all()) for _, i in rows)
        b = bounds.walk_bound(128, runs, rows, tree.win_ids, branch)
        assert b["bound_ms"] > 0 and (b["slots"], b["slots_touched"]) == (slots, touched)
        # B2 slab-tests K children at each pop that survives its prune; B3
        # takes an exit face at each leaf step: fewer visits than pops or steps.
        assert 0 < b["node_visits"] <= int(visits.sum()) and b["node_bytes"] > 0
        visit_ops = 8 * bounds.SLAB_OPS if branch else bounds.EXIT_OPS
        assert b["bytes"] == 128 * 40 + touched * 48 + b["node_bytes"]
        assert b["ops"] == slots * 43 + b["node_visits"] * visit_ops
    assert common._tally is None and common._rows is None  # the tallies end with their blocks


def two_leaf_scene():
    """Two unit triangles in the planes x = 1 (A, polygon 0) and x = 3 (B,
    polygon 1): with one triangle a leaf, each KD tree is a root split at
    x ~ 1.06 over two leaves."""
    faces = [tri(1.0, 0.0, 0.0, 1.0), tri(3.0, 0.0, 0.0, 1.0)]
    top = th.Topology.build(faces)
    rays = th.Ray.make(
        torch.tensor([[0.0, 0.25, 0.25], [4.0, 0.25, 0.25], [0.0, 0.25, 0.25]]),
        torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
        torch.tensor([[-1, -1], [-1, -1], [0, -1]], dtype=torch.int32),
    )
    return top, rays


def test_walk_work_hand_counted():
    """Three rays through the two-leaf trees: +x (hits A), -x (hits B) and
    +x with A excluded (hits B), counted by hand."""
    top, rays = two_leaf_scene()
    kd = build_kdtree(top, max_tris_per_node=1, device=CPU)
    rp = build_kdtree_ropes(top, max_tris_per_node=1, device=CPU)
    assert kd.branch == 2 and rp.node[0, 1] == 0 and rp.node[1:3, 1].tolist() == [1, 1]

    with common.tally_runs() as runs, common.tally_rows() as rows:
        t, tri_id, pops = tree_shoot_plain(rays, kd, with_stats=True)
    assert t.tolist() == [1.0, 1.0, 3.0] and tri_id.tolist() == [0, 1, 1]
    # Each ray pops the pseudo-root and the root: 6 reads of 2 distinct rows
    # of 2 x 36 B.  At the root every ray tests the low leaf's run; the
    # high leaf's then only where its entry t is not beyond the best hit:
    # not the first ray's (A at t = 1 before x ~ 1.06).  1 + 2 + 2 slots
    # of the 2 non-null ones.
    assert pops.tolist() == [2, 2, 2]
    b = bounds.walk_bound(3, runs, rows, kd.win_ids, 2)
    assert (b["slots"], b["slots_touched"], b["node_visits"], b["node_bytes"]) == (5, 2, 6, 144)
    assert b["ops"] == 5 * 43 + 6 * 2 * 12
    assert b["bytes"] == 3 * 40 + 2 * 48 + 144

    with common.tally_runs() as runs, common.tally_rows() as rows:
        t, tri_id, steps = ropes_shoot_plain(rays, rp, with_stats=True)
    assert t.tolist() == [1.0, 1.0, 3.0] and tri_id.tolist() == [0, 1, 1]
    # The first two rays descend from the root to their leaf, hit, and stop
    # (the exit face lies beyond the hit); the third also follows the rope
    # to the high leaf and leaves the tree: 2 + 2 + 3 steps, 4 of them at
    # leaves.  Distinct rows: 3 node rows (16 B), the root's split (4 B),
    # and both leaves' window, box and rope rows (8 + 24 + 24 B).
    assert steps.tolist() == [2, 2, 3]
    b = bounds.walk_bound(3, runs, rows, rp.win_ids, None)
    assert (b["slots"], b["slots_touched"], b["node_visits"]) == (4, 2, 4)
    assert b["node_bytes"] == 3 * 16 + 4 + 2 * (8 + 24 + 24)
    assert b["ops"] == 4 * 43 + 4 * 6
    assert b["bytes"] == 3 * 40 + 2 * 48 + b["node_bytes"]


def test_rows_work_counts_distinct_rows_once():
    rows = [("node", torch.tensor([0, 1, 1])), ("split", torch.tensor([0])),
            ("node", torch.tensor([2, 0])), ("box", torch.tensor([], dtype=torch.int64))]
    reads, nbytes = bounds.rows_work(rows, bounds.ROPE_ROW_BYTES)
    assert reads == {"node": 5, "split": 1, "box": 0}
    assert nbytes == 3 * 16 + 1 * 4


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


def test_gradient_bounds_from_shapes():
    hit = torch.tensor([[True, False], [True, True]])
    # K3 soft: 7 operations a hit lane, the same bytes as hard.
    soft = bounds.histogram_bound(hit, 16, soft=True)
    assert soft["ops"] == 3 * 7 and soft["bytes"] == 4 * 9 + 16 * 4
    sb = bounds.soft_histogram_bwd_bound(hit, 16)
    assert sb["ops"] == 3 * 8 and sb["bytes"] == 4 * 17 + 16 * 4
    # A3: rays 0 and 1 share triangle 1, ray 2 misses (triangle 0); the
    # two triangles share two of their four vertices.
    tri_meta = torch.zeros(3, 8, dtype=torch.int32)
    tri_meta[0, 4:7] = torch.tensor([0, 1, 2])
    tri_meta[1, 4:7] = torch.tensor([2, 1, 3])
    a3 = bounds.finalize_hits_bwd_bound(torch.tensor([1, 1, -1], dtype=torch.int32),
                                        torch.tensor([True, True, False]), tri_meta)
    assert a3["ops"] == 2 * 201 + 24
    assert a3["bytes"] == 3 * 141 + 2 * 12 + 4 * 12 and a3["bound_by"] == "bytes"
    # The scatter: keys and (M, 3) values in, the sums out.
    sc = bounds.scatter_bound(torch.zeros(10, dtype=torch.int32), 3, 4)
    assert sc["ops"] == 30 and sc["bytes"] == 10 * 16 + 4 * 12


@pytest.mark.parametrize("label, replacements, flags", kernel_sweep.CANDIDATES["k1"],
                         ids=[c[0] for c in kernel_sweep.CANDIDATES["k1"]])
def test_k1_sweep_candidates_apply(label, replacements, flags):
    """Every design candidate of K1 is the built K1 with its few statements
    replaced, each found exactly once, or the built K1 under other flags."""
    from hare_tpu_torch.kernels import build

    src = (build.CSRC / "grid_shoot.cu").read_text()
    out = kernel_sweep.variant_source(src, replacements)
    assert (out == src) == (not replacements)
    built = label == kernel_sweep.CANDIDATES["k1"][0][0]
    assert built == (not replacements and flags is None) and not (replacements and flags)
    assert out.count("hare::test_run_group<MT, kGroup>") == 1
    if replacements:
        with pytest.raises(ValueError):  # a statement the kernel does not hold
            kernel_sweep.variant_source("", replacements)


WALK_CANDIDATES = [(k, *c) for k in ("b1", "b2", "b3") for c in kernel_sweep.CANDIDATES[k]]


@pytest.mark.parametrize("kernel, label, replacements, flags", WALK_CANDIDATES,
                         ids=[f"{c[0]}-{c[1]}" for c in WALK_CANDIDATES])
def test_sweep_candidates_apply(kernel, label, replacements, flags):
    """Every design candidate of B1, B2 and B3 is the built source with its
    statements replaced, each found exactly once, or the built source under
    nvcc's default FMA contraction."""
    from hare_tpu_torch.kernels import build

    src = (build.CSRC / kernel_sweep.SPECS[kernel].source).read_text()
    out = kernel_sweep.variant_source(src, replacements)
    assert (out == src) == (not replacements)
    assert flags in (None, kernel_sweep.FMA_FLAGS)
    built = label == kernel_sweep.CANDIDATES[kernel][0][0]
    assert built == (not replacements and flags is None) and not (replacements and flags)
    if flags is not None:
        assert "-fmad=false" in build.NVCC_FLAGS and "-fmad=false" not in flags
    assert out.count("hare::test_run_group<MT, kGroup>") == (kernel != "b1")
    if replacements:
        with pytest.raises(ValueError):
            kernel_sweep.variant_source("", replacements)


def test_k1_sweep_reads_the_entry_point():
    """The sweep calls each candidate, a parent's included, through the
    parameters its source declares."""
    from hare_tpu_torch.kernels import build

    spec = kernel_sweep.SPECS["k1"]
    src = (build.CSRC / "grid_shoot.cu").read_text()
    params = kernel_sweep._c_params(src, spec.entry)
    assert [n for n, _ in params] == list(spec.args) + ["counter", "stream"]
    assert [t for _, t in params] == build._SIGNATURES["hare_grid_shoot"]
    older = ('extern "C" int hare_grid_shoot(const float* o, const float* d, const int* ex, '
             'int n, const int* cell_meta, const float* win_geom, const int* win_ids, '
             'const float* fparams, const int* iparams, float* best_t, int* best_tri, '
             'void* stream) {')
    assert [n for n, _ in kernel_sweep._c_params(older, spec.entry)] == list(spec.args) + ["stream"]


# The B2 and B3 entry points of the one-thread-per-ray design, which had no
# ray counter.
OLDER_WALKS = {
    "b2": ('extern "C" int hare_tree_shoot(const float* o, const float* d, const int* ex, int n,'
           ' const float* child_box, const int* child_info, const float* win_geom,'
           ' const int* win_ids, float min_t, const int* iparams, float* best_t,'
           ' int* best_tri, int* pops, int* err, void* stream) {'),
    "b3": ('extern "C" int hare_ropes_shoot(const float* o, const float* d, const int* ex, int n,'
           ' const int* node_tab, const float* split, const float* box, const int* leaf_win,'
           ' const int* ropes, const float* win_geom, const int* win_ids, const float* fparams,'
           ' const int* iparams, float* best_t, int* best_tri, int* steps, int* err,'
           ' void* stream) {'),
}


@pytest.mark.parametrize("kernel", ["b1", "b2", "b3"])
def test_sweep_reads_the_walk_entry_points(kernel):
    """B1, B2 and B3 are called, in this tree and in a parent, through the
    parameters each source declares: what the wrapper's *_args function
    gives, then the ray counter (B2, B3) and the stream."""
    from hare_tpu_torch.kernels import build

    spec = kernel_sweep.SPECS[kernel]
    params = kernel_sweep._c_params((build.CSRC / spec.source).read_text(), spec.entry)
    tail = ["stream"] if kernel == "b1" else ["counter", "stream"]
    assert [n for n, _ in params] == list(spec.args) + tail
    assert [t for _, t in params] == build._SIGNATURES[spec.entry]
    if kernel in OLDER_WALKS:
        older = kernel_sweep._c_params(OLDER_WALKS[kernel], spec.entry)
        assert [n for n, _ in older] == list(spec.args) + ["stream"]


def test_sweep_reads_a_checkout_flags(tmp_path):
    """A parent is built with the flags its own build.py names."""
    from hare_tpu_torch.kernels import build

    root = build.CSRC.parents[2]
    assert kernel_sweep._nvcc_flags(root) == build.NVCC_FLAGS
    older = tmp_path / "hare_tpu_torch/kernels"
    older.mkdir(parents=True)
    (older / "build.py").write_text('NVCC_FLAGS = (\n    "-O3",\n    "-Xcompiler", "-fPIC",\n)\n')
    assert kernel_sweep._nvcc_flags(tmp_path) == ("-O3", "-Xcompiler", "-fPIC")


@pytest.mark.parametrize("entry", sorted(build._SIGNATURES))
def test_signatures_match_the_sources(entry):
    """Each C entry point is bound with the argument types its source
    declares, in order, the stream last."""
    decls = [src.read_text() for src in sorted(build.CSRC.glob("*.cu"))]
    found = [d for d in decls if f'extern "C" int {entry}(' in d]
    assert len(found) == 1
    params = kernel_sweep._c_params(found[0], entry)
    assert [t for _, t in params] == build._SIGNATURES[entry]
    assert params[-1][0] == "stream"


@pytest.mark.parametrize("label, replacements", a3_check.FAULTS,
                         ids=[f[0] for f in a3_check.FAULTS])
def test_a3_faults_apply(label, replacements):
    """Each planted fault of A3 is the built finalize_bwd.cu with one
    statement replaced, found exactly once; the fault is called through
    the parameters the source declares."""
    from hare_tpu_torch.kernels import build

    src = (build.CSRC / "finalize_bwd.cu").read_text()
    out = kernel_sweep.variant_source(src, replacements)
    assert out != src and len(replacements) == 1
    params = kernel_sweep._c_params(out, "hare_finalize_hits_bwd")
    assert [n for n, _ in params] == list(a3_check.A3_PARAMS) + ["stream"]
    with pytest.raises(ValueError):
        kernel_sweep.variant_source("", replacements)


def a3_case(rng, n):
    """A3 arguments for ``n`` rays, each hitting its own right triangle of
    the plane z = i nearly square (condition 1 to 1.1), with cotangents
    between 0.5 and 1 in size; and random outputs of that size."""
    corners = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=torch.float32)
    vertices = (corners[None] + torch.arange(n, dtype=torch.float32)[:, None, None]).reshape(-1, 3)
    tri_meta = torch.zeros(n, 8, dtype=torch.int32)
    tri_meta[:, 4:7] = torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)
    d = torch.tensor(rng.uniform(-0.1, 0.1, (n, 3)), dtype=torch.float32)
    d[:, 2] = -1.0
    o = torch.tensor(rng.uniform(0.2, 0.3, (n, 3)), dtype=torch.float32)
    o[:, 2] += torch.arange(n, dtype=torch.float32) + 1.0
    t = o[:, 2] - torch.arange(n, dtype=torch.float32)

    def vals(*shape):
        mag = rng.uniform(0.5, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
        return torch.tensor(mag, dtype=torch.float32)

    args = (vertices, tri_meta, torch.arange(n, dtype=torch.int32), t,
            torch.ones(n, dtype=torch.bool), o, d,
            (vals(n), vals(n), vals(n), vals(n, 3), vals(n, 3)))
    p = (vals(n, 3), vals(n, 3), tri_meta[:, 4:7].reshape(-1).clone(), vals(3 * n, 3))
    return args, p


def test_a3_condition():
    """A ray square to its triangle has condition 1; one at 60 degrees to
    the normal 2; one in the plane, or on a degenerate triangle, inf."""
    vertices = torch.tensor([[0, 0, 0], [2, 0, 0], [0, 3, 0], [4, 0, 0]], dtype=torch.float32)
    tri_meta = torch.zeros(2, 8, dtype=torch.int32)
    tri_meta[0, 4:7] = torch.tensor([0, 1, 2])
    tri_meta[1, 4:7] = torch.tensor([0, 1, 3])  # collinear corners
    d = torch.tensor([[0, 0, -1], [3 ** 0.5 / 2, 0, 0.5], [1, 1, 0], [0, 0, 1]],
                     dtype=torch.float32)
    cond = a3_check.condition(vertices, tri_meta, torch.tensor([0, 0, -1, 1]), d)
    assert cond[0] == 1.0 and abs(float(cond[1]) - 2.0) < 1e-6
    assert torch.isinf(cond[2:]).all()


def test_a3_jacobian_mass():
    """|J|^T |g| bounds |J^T g| element by element, and equals it where
    every cotangent but one is zero and that one is positive."""
    def vjp64(args):
        return common.finalize_hits_bwd_plain(
            *(x.double() if x.is_floating_point() else x for x in args[:-1]),
            tuple(c.double() for c in args[-1]))

    args, _ = a3_case(np.random.default_rng(5), 16)
    got = vjp64(args)
    for m, g in zip(a3_check.jacobian_mass(args), (got[0], got[1], got[3])):
        assert (g.abs() <= m * (1 + 1e-12)).all()
    only_t = (args[-1][0].abs(),) + tuple(torch.zeros_like(c) for c in args[-1][1:])
    one = args[:-1] + (only_t,)
    got = vjp64(one)
    for m, g in zip(a3_check.jacobian_mass(one), (got[0], got[1], got[3])):
        torch.testing.assert_close(m, g.abs(), rtol=1e-12, atol=1e-12 * float(m.max()))


def test_a3_input_sensitivity():
    """The effect of rounding the inputs is finite and non-negative, and
    for d(direction) it grows against |J|^T |g| as the origin nears the
    plane it hits (t from 1.2 to 1e-3): there the rounding of o - v0 moves
    t by far more than t's own size suggests."""
    args, _ = a3_case(np.random.default_rng(6), 16)
    sens = a3_check.input_sensitivity(args)
    assert all(torch.isfinite(x).all() and (x >= 0).all() for x in sens)
    o = args[5].clone()
    o[:, 2] = torch.arange(16, dtype=torch.float32) + 1e-3  # just above each plane
    near = a3_check.input_sensitivity(args[:5] + (o,) + args[6:])
    assert float(near[1].amax(1).min()) > 0
    mass_far = a3_check.jacobian_mass(args)[1].amax(1)
    mass_near = a3_check.jacobian_mass(args[:5] + (o,) + args[6:])[1].amax(1)
    assert (near[1].amax(1) / mass_near > sens[1].amax(1) / mass_far).all()


def test_a3_agreement_counts_outside():
    """agreement holds each ray to A3_TOL x its bound (its condition x its
    largest |J|^T |g| element, plus its largest input sensitivity), and
    each vertex sum to the sum of its corners' bounds; it counts what lies
    beyond, a non-finite element among it."""
    n = 64
    args, p = a3_case(np.random.default_rng(3), n)
    mass = a3_check.jacobian_mass(args)
    sens = a3_check.input_sensitivity(args)
    bounds = a3_check.ray_bounds(args)
    same = a3_check.agreement(p, p, args, bounds)
    assert set(same) == {"d_origin", "d_direction", "d_corner", "d_vertices"}
    assert all(r["outside"] == 0 and r["needed"] == 0 for r in same.values())
    assert all(0 < r["median_over_max"] <= 1 for r in same.values())
    cond = a3_check.condition(args[0], args[1], args[2], args[6])
    assert 1.0 <= float(cond.min()) and float(cond.max()) < 1.1
    for b, m, e in zip(bounds, mass, sens):  # cond x the row's largest mass, + its largest sens
        rows = (cond * m.amax(1) if m.shape[0] == n else cond * m.reshape(n, 9).amax(1))
        rows = rows + e.reshape(n, -1).amax(1)
        torch.testing.assert_close(b.reshape(n, -1), rows[:, None].expand(n, b.numel() // n))
    k = list(p)
    k[0] = p[0].clone()
    k[0][0, 0] += 0.5 * a3_check.A3_TOL * float(bounds[0][0, 0])  # inside
    k[0][1, 1] += 2.0 * a3_check.A3_TOL * float(bounds[0][1, 1])  # outside
    k[0][2, 2] = float("nan")
    k[1] = p[1] + 2.0 * a3_check.A3_TOL * bounds[1].float()
    k[3] = p[3].clone()
    k[3][0] += 1e3 * float(bounds[2].max())  # ray 0's first corner and its vertex
    got = a3_check.agreement(tuple(k), p, args, bounds)
    assert got["d_origin"]["outside"] == 2
    assert got["d_direction"]["outside"] == 3 * n
    assert 1.9 * a3_check.A3_TOL < got["d_direction"]["needed"] < 2.1 * a3_check.A3_TOL
    assert got["d_corner"]["outside"] == 3
    assert got["d_vertices"]["outside"] == 3
