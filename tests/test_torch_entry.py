"""Port parity: the flagship workload and the ray-parallel dry run
(``hare_tpu_torch.entry``) against ``__graft_entry__.py``.

The forward workload traces 1,024 rays 4 bounces through the concert hall,
whose stage and floor are coincident polygons: a ray that meets them where
two triangles lie at the same ``t`` may, from an ulp of rounding (XLA's
fused triangle test against torch's), take the other one, and the two paths
part from there.  So the trace is compared ray by ray: a ray that never
parts from JAX's path agrees on every bounce; a ray that parts must do so
at a genuine equal-``t`` tie, and few may.  A ray the port loses is missed
by brute force too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
import hare_tpu as jh  # noqa: E402
from hare_tpu.dist import make_ray_mesh  # noqa: E402
from hare_tpu.dist import sharded_histogram as jax_sharded  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402
from hare_tpu.trace import uniform_sphere as j_uniform_sphere  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch import entry as pe  # noqa: E402
from hare_tpu_torch.accel.voxel import repack_windows  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# Histograms of the rays that never part: within HIST_TOL of the total.
HIST_TOL = 1e-5
# The dry run's target against JAX's: the same f32 products, summed in
# another order.
RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    """JAX's forward body (trace_rays, then energy_histogram) on its
    ``entry()``'s own arguments, and the port's ``entry(device="cpu")``
    beside it, each traced once."""
    jfwd, (jscene, jaux, o, d, a) = jentry.entry()
    jtop = jh.Topology.build(jshapes.concert_hall())
    jsp = jh.SpatialPartition(jtop, accel="grid", avg_polys=pe.AVG_POLYS)
    res_j = jh.trace_rays(jscene, jh.Ray.make(o, d), a, pe.N_BOUNCES, jsp.shoot_fn, aux=jaux)
    hist_j = jh.energy_histogram(res_j, pe.N_BINS, pe.BIN_DT)
    res_j, hist_j = jax.tree.map(np.asarray, (res_j, hist_j))

    fwd, args = pe.entry(device=CPU)
    with torch.no_grad():
        res = fwd.trace(*args)
        hist = fwd(*args)
    return dict(jax=(res_j, hist_j, jaux, (o, d, a)), port=(res, hist, fwd, args))


def hall_extent(runs):
    """The hall's largest extent in metres."""
    v = runs["port"][3][0].vertices
    return float((v.max(0).values - v.min(0).values).max())


def as_torch(res_j):
    return th.TraceResult(*(torch.from_numpy(np.array(x)) for x in res_j))


def test_entry_arguments_and_grid_match_jax(runs):
    """The port's rays and absorption are JAX's to the bit, and its grid
    tables for this build equal JAX's."""
    _, _, jg, (o, d, a) = runs["jax"]
    _, _, _, (scene, g, o_t, d_t, a_t) = runs["port"]
    for x, y in ((o_t, o), (d_t, d), (a_t, a)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert o_t.shape == (pe.N_RAYS, 3) and o_t.dtype == torch.float32
    np.testing.assert_array_equal(g.cell_meta.numpy(), np.asarray(jg.cell_meta))
    geom, ids = repack_windows(np.asarray(jg.win_data))
    np.testing.assert_array_equal(g.win_geom.numpy(), geom)
    np.testing.assert_array_equal(g.win_ids.numpy(), ids)
    np.testing.assert_array_equal(g.grid_min.numpy(), np.asarray(jg.grid_min))
    np.testing.assert_array_equal(g.voxel_size.numpy(), np.asarray(jg.voxel_size))
    assert (g.dims, g.max_cell_wins, g.n_tris) == (jg.dims, jg.max_cell_wins, jg.n_tris)
    assert g.dims == (16, 16, 16) and scene.n_tris >= 1608


def test_entry_trace_parts_only_at_ties(runs):
    """Ray by ray against JAX (``entry.compare_traces``): rays that never
    part agree on every bounce; each parted ray parts at an equal-t tie or
    at a hop onto a polygon coincident with the one it left; at most 1%
    part.  Of these 1,024 rays 5 part: 202, 210, 311 and 364 at
    ties, 602 at a hop (its floor hit rounds below z = 0 in the port, which
    then meets the coincident polygon 1501 at t = 1.6e-7)."""
    out = pe.compare_traces(runs["port"][0], as_torch(runs["jax"][0]), hall_extent(runs))
    assert len(out["parted"]) <= pe.MAX_PARTED * pe.N_RAYS
    assert set(out["kind"]) <= {"tie", "hop"}


def test_entry_histograms_match_jax(runs):
    """Each package's histogram of its rays that never part agree within
    HIST_TOL of the total; the full totals differ by at most the parted
    rays' energies; each total equals its bounce energies."""
    res_j, hist_j, _, _ = runs["jax"]
    res, hist, _, _ = runs["port"]
    parted = ~pe.compare_traces(res, as_torch(res_j), hall_extent(runs))["same"].numpy()
    keep = ~parted[None, :]
    h_j = np.asarray(jh.energy_histogram(res_j._replace(hit=res_j.hit & keep), pe.N_BINS,
                                         pe.BIN_DT))
    h = th.energy_histogram(res._replace(hit=res.hit & torch.from_numpy(keep)), pe.N_BINS,
                            pe.BIN_DT).numpy()
    total = float(h_j.sum())
    np.testing.assert_allclose(h, h_j, rtol=0, atol=HIST_TOL * total)
    e_parted = max(float(res.energy[:, parted].sum()), float(res_j.energy[:, parted].sum()))
    assert abs(float(hist.sum()) - float(hist_j.sum())) <= e_parted + HIST_TOL * total
    assert hist.shape == (pe.N_BINS,) and bool(torch.isfinite(hist).all())
    np.testing.assert_allclose(float(hist.sum()), float(res.energy.sum()), rtol=1e-5)
    np.testing.assert_allclose(float(hist_j.sum()), float(res_j.energy.sum()), rtol=1e-5)


def test_entry_lost_rays_escape(runs):
    """Every ray the port loses (alive, then no hit) is missed by brute force
    on the same query: origin, direction and exclusions."""
    res, _, fwd, (scene, aux, o, d, a) = runs["port"]
    batches = bounce_rays(fwd.partition, th.Ray.make(o, d), a, pe.N_BOUNCES)
    alive = torch.ones(pe.N_RAYS, dtype=torch.bool)
    brute = th.SpatialPartition(fwd.partition.model, accel="brute", device=CPU)
    n_lost = 0
    for b, r in enumerate(batches):
        lost = alive & ~res.hit[b]
        n_lost += int(lost.sum())
        if bool(lost.any()):
            hr = brute.shoot(th.Ray(*(x[lost] for x in r)))
            assert not bool(hr.hit.any()), torch.nonzero(lost).squeeze(1)[hr.hit].tolist()
        alive = res.hit[b]
    assert 0 < n_lost < pe.N_RAYS // 10


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed afterwards."""
    from hare_tpu_torch import dist as hd

    assert not torch.distributed.is_initialized()
    init = tmp_path_factory.mktemp("gloo") / "init"
    hd.init_distributed(CPU, init_method=f"file://{init}", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_dryrun_matches_unsharded_and_jax(one_rank_group):
    """``dryrun_multichip`` on one gloo rank, on JAX's directions: its loss
    and parameters equal the same step without the group to the bit, and
    its target is JAX's ``sharded_histogram`` on a one-device mesh within
    RTOL."""
    n = pe.DRY_RAYS
    d_j = j_uniform_sphere(jax.random.PRNGKey(0), n)
    d = torch.from_numpy(np.array(d_j))
    out = pe.dryrun_multichip(device=CPU, directions=d)

    ref = pe.dryrun_reference(n, CPU, d)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert float(out.loss) > 0 and bool((out.absorption != 0).all())

    jtop = jh.Topology.build(jshapes.shoebox(4, 5, 3))
    jsp = jh.SpatialPartition(jtop, accel="grid", domain=4)
    o = jnp.tile(jnp.array(pe.DRY_SOURCE, jnp.float32), (n, 1))
    hist_fn = jax_sharded(make_ray_mesh(1), jsp.shoot_fn, n_bounces=pe.DRY_BOUNCES,
                          n_bins=pe.DRY_BINS)
    t_j = np.asarray(hist_fn(jsp.scene, jh.Ray.make(o, d_j),
                             jnp.full(jtop.n_polys, pe.DRY_ABSORPTION, jnp.float32), jsp.aux))
    np.testing.assert_allclose(out.target.numpy(), t_j, rtol=RTOL, atol=RTOL * float(t_j.sum()))


def test_dryrun_needs_matching_directions(one_rank_group):
    with pytest.raises(ValueError, match="directions"):
        pe.dryrun_multichip(device=CPU, directions=torch.ones(pe.DRY_RAYS + 1, 3))
