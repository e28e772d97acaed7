"""Port parity: the eval configs (``hare_tpu_torch/benchmarks/configs.py``)
against the JAX package's ``benchmarks/configs.py``, on the CPU.

``big_scene`` must make the JAX faces to the bit; configs 1 and 5 carry the
reference's constants; config 5's 256^3 grid must be the JAX grid's tables
and trace as JAX traces.  Config 5 at its own size (5.24M triangles) runs
on the card (``chip_smoke.py`` phase 12); here ``big_scene("650k")`` stands
in for its scene, on the same 256^3 grid.
"""

import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import shoot_grid as j_shoot_grid  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.common import repack_windows  # noqa: E402
from hare_tpu_torch.accel.scatter import (  # noqa: E402
    CHUNK,
    MIN_RANGE,
    scatter_add_plain,
    scratch_words,
)
from hare_tpu_torch.accel.voxel import grid_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import configs  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_rays  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"
# Per-bounce energies and times, the histogram and the absorption gradient:
# the same products and sums in f32 in another order.
RTOL = 1e-5
# The triangles of each big scene: a 12-triangle shell and icospheres of
# 20 * 4^subdiv triangles.
BIG_TRIS = {"650k": 655_372, "1.3M": 1_310_732, "5M": 5_242_892}
# A 256-ray trace on config 5's grid, as the reference traces config 5.
TRACE_RAYS, TRACE_BOUNCES, TRACE_BINS, BIN_DT = 256, 2, 1024, 1e-3


def reference_configs():
    """``benchmarks/configs.py``, loaded by path: it imports ``hare_tpu``
    only inside its functions."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "configs.py"
    spec = importlib.util.spec_from_file_location("reference_eval_configs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(chunks):
    """Each chunk's dtype, shape and bytes (hashed, so one scene at a time
    is held)."""
    return [(c.dtype.str, c.shape, hashlib.sha256(c.tobytes()).hexdigest()) for c in chunks]


@pytest.mark.parametrize("n_target", sorted(BIG_TRIS))
def test_big_scene_bit_equal(n_target):
    ours = digest(configs.big_scene(n_target))
    assert sum(shape[0] for _, shape, _ in ours) == BIG_TRIS[n_target]
    assert ours == digest(reference_configs().big_scene(n_target))


def seeded_directions(n, seed=0):
    return th.uniform_sphere(n, torch.Generator().manual_seed(seed), device=CPU)


def test_config1_setup():
    """``benchmarks/configs.py:86-104``: shoebox(4, 5, 3), brute force,
    10,000 rays from (2.0, 2.5, 1.5), absorption 0.3, 3 bounces, 256 bins."""
    c = configs.config1_setup(device=CPU)
    assert c.topology.n_tris == 12 and c.partition.struct is None  # brute: no structure
    assert c.partition.scene.tri_geom.device.type == "cpu"
    assert torch.equal(c.rays.origin, torch.tensor([2.0, 2.5, 1.5]).expand(10_000, 3))
    assert torch.equal(c.rays.direction, seeded_directions(10_000))
    assert torch.equal(c.absorption, torch.full((c.topology.n_polys,), 0.3))
    assert (c.n_bounces, c.n_bins) == (3, 256) and c.build_s > 0


@pytest.fixture(scope="module")
def config5():
    """``config5_setup`` on the CPU with ``big_scene("650k")`` standing in
    for the 5M scene: the same kind (a 40 m shell and icospheres) on the
    same 256^3 grid.  Returns the config and the scenes it asked for."""
    asked, real = [], configs.big_scene

    def stand_in(n_target):
        asked.append(n_target)
        return real("650k")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(configs, "big_scene", stand_in)
        cfg = configs.config5_setup(device=CPU)
    return cfg, asked


@pytest.fixture(scope="module")
def jax_config5():
    """The JAX package's grid over the same scene: ``SpatialPartition(top,
    accel="grid", domain=256)``, as ``benchmarks/configs.py:189`` builds
    config 5's."""
    top = jh.Topology.build(reference_configs().big_scene("650k"))
    return top, jh.SpatialPartition(top, accel="grid", domain=256)


def test_config5_setup(config5):
    """``benchmarks/configs.py:176-218``: big_scene("5M"), a domain-256
    grid, 2^20 rays from (20, 20, 20), absorption 0.3, 2 bounces, 1024
    bins; and the reference line's grid figures."""
    cfg, asked = config5
    assert asked == ["5M"]
    n = 1 << 20
    assert torch.equal(cfg.rays.origin, torch.full((n, 3), 20.0))
    assert torch.equal(cfg.rays.direction, seeded_directions(n))
    assert torch.equal(cfg.absorption, torch.full((cfg.topology.n_polys,), 0.3))
    assert (cfg.n_bounces, cfg.n_bins) == (2, 1024)
    assert cfg.topology_s > 0 and cfg.grid_s > 0
    g, st = cfg.partition.struct, cfg.stats()
    rows, win = g.win_geom.shape[:2]
    assert st["grid_dims"] == g.dims == (256, 256, 256)
    assert st["win_rows"] == rows and st["max_cell_wins"] == g.max_cell_wins
    assert st["dup_slots_per_tri"] == (rows - 1) * win / BIG_TRIS["650k"]
    assert st["win_data_MB"] == rows * win * 12 * 4 / 1e6
    assert st["meta_MB"] == 256 ** 3 * 2 * 4 / 1e6
    assert st["grid_MB"] > st["win_data_MB"] + st["win_ids_MB"] + st["meta_MB"] - 1e-9
    assert st["scene_MB"] > 0


def test_config5_batches():
    """Batch b of the sustained run: 2^20 rays (by default) from (20, 20,
    20), directions from a generator on the device seeded with b."""
    assert configs.config5_batches.__defaults__ == (100, 1 << 20, "cuda")
    batches = list(configs.config5_batches(3, 1000, CPU))
    assert len(batches) == 3
    for b, r in enumerate(batches):
        assert torch.equal(r.origin, torch.full((1000, 3), 20.0))
        assert torch.equal(r.direction, seeded_directions(1000, b))


@pytest.mark.parametrize("name", ["config1_setup", "config5_setup", "config5_batches"])
def test_config_defaults_to_the_card(name):
    """Without ``device`` each places its tensors on the card; without a
    card it raises (config 5 before its host build)."""
    calls = {"config1_setup": lambda: configs.config1_setup().rays.origin,
             "config5_setup": lambda: configs.config5_setup().rays.origin,
             "config5_batches": lambda: next(configs.config5_batches(1, 8)).origin}
    with pytest.MonkeyPatch.context() as mp:
        # A shell alone, should there be a card to build it on.
        mp.setattr(configs, "big_scene",
                   lambda n_target: [np.stack(shapes.shoebox(40.0, 40.0, 40.0))])
        if torch.cuda.is_available():
            assert calls[name]().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                calls[name]()


def test_config5_grid_bit_equal_to_jax(config5, jax_config5):
    """The port's 256^3 grid tables equal the JAX ``build_voxel_grid``'s:
    ``cell_meta`` (window runs and the distance field), the windows after
    ``repack_windows``, the grid's box, dims and ``max_cell_wins``."""
    g, jg = config5[0].partition.struct, jax_config5[1].struct
    meta = np.asarray(jg.cell_meta)
    np.testing.assert_array_equal(g.cell_meta.numpy(), meta)
    assert (meta[:, 1] & 0xFF).max() >= 2  # distance-field jumps exist
    geom, ids = repack_windows(np.asarray(jg.win_data))
    np.testing.assert_array_equal(g.win_geom.numpy(), geom)
    np.testing.assert_array_equal(g.win_ids.numpy(), ids)
    np.testing.assert_array_equal(g.grid_min.numpy(), np.asarray(jg.grid_min))
    np.testing.assert_array_equal(g.voxel_size.numpy(), np.asarray(jg.voxel_size))
    assert (g.dims, g.max_cell_wins, g.n_tris, g.char_step) == (
        jg.dims, jg.max_cell_wins, jg.n_tris, jg.char_step)


def test_config5_trace_matches_jax(config5, jax_config5):
    """A 256-ray, 2-bounce, 1024-bin trace from (20, 20, 20) on config 5's
    grid: the same triangle on each bounce's rays as JAX's grid shoot, the
    same hits and polygons; energies, times, the histogram and the
    absorption gradient within RTOL of JAX's."""
    cfg, (jtop, jsp) = config5[0], jax_config5
    sp = cfg.partition
    rng = np.random.default_rng(5)
    d = rng.normal(size=(TRACE_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.full((TRACE_RAYS, 3), 20.0, np.float32)
    absorption = rng.uniform(0.1, 0.5, jtop.n_polys).astype(np.float32)

    def loss(a):
        res = jh.trace_rays(jsp.scene, jh.Ray.make(o, d), a, TRACE_BOUNCES, jsp.shoot_fn,
                            aux=jsp.aux)
        hist = jh.energy_histogram(res, TRACE_BINS, BIN_DT)
        return jnp.sum(hist), (res, hist)

    (_, (res_j, hist_j)), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(absorption))
    res_j, hist_j, g_j = jax.tree.map(np.asarray, (res_j, hist_j, g_j))

    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    a = torch.from_numpy(absorption).requires_grad_()
    res = th.trace_rays(sp.scene, rays, a, TRACE_BOUNCES, sp.shoot_fn, aux=sp.aux)
    hist = th.energy_histogram(res, TRACE_BINS, BIN_DT)
    hist.sum().backward()

    np.testing.assert_array_equal(res.hit.numpy(), res_j.hit)
    assert res_j.hit.all()  # inside the closed shell, the source outside every sphere
    np.testing.assert_array_equal(res.poly_id.numpy(), res_j.poly_id)
    np.testing.assert_allclose(res.energy.detach().numpy(), res_j.energy, rtol=RTOL)
    np.testing.assert_allclose(res.time.detach().numpy(), res_j.time, rtol=RTOL)
    np.testing.assert_allclose(hist.detach().numpy(), hist_j, rtol=RTOL)
    np.testing.assert_allclose(a.grad.numpy(), g_j, rtol=RTOL)
    with torch.no_grad():
        batches = bounce_rays(sp, rays, a.detach(), TRACE_BOUNCES)
    for r in batches:
        _, tri = grid_shoot_plain(r, sp.struct)
        hr = j_shoot_grid(jsp.scene, jh.Ray.make(*(x.numpy() for x in r)), jsp.struct)
        np.testing.assert_array_equal(tri.numpy(), np.asarray(hr.tri_id))


# Three of the 18 directions (of 104,857,600) that config 5's sustained run
# on the card lost on bounce 1: each has a component within 2e-7 of zero.
LOST = np.array([[0.8620668053627014, -0.5067946314811707, -5.960464477539063e-08],
                 [0.3428290784358978, -1.035315051467478e-07, -0.9393978118896484],
                 [-1.643455647126757e-07, 0.5825172066688538, 0.8128184080123901]], np.float32)


def test_config5_grid_loses_near_axis_rays_as_jax(config5, jax_config5):
    """A reference fault the port keeps for parity: from config 5's source,
    which lies on a cell boundary along every axis, a ray whose direction
    has a component within ~1e-7 of zero is lost by the grid march (that
    axis's next boundary stays at t = 0 and every distance-field jump lands
    in the same cell), by JAX's shoot_grid as by the port's; brute force
    hits each, and the same direction with that component zeroed hits."""
    sp, (_, jsp) = config5[0].partition, jax_config5
    fixed = np.where(np.abs(LOST) < 1e-6, np.float32(0.0), LOST)
    d = np.concatenate([LOST, fixed])
    o = np.full(d.shape, 20.0, np.float32)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    t, _ = grid_shoot_plain(rays, sp.struct)
    hj = j_shoot_grid(jsp.scene, jh.Ray.make(o, d), jsp.struct)
    lost = np.arange(len(d)) < len(LOST)
    np.testing.assert_array_equal(np.isfinite(t.numpy()), ~lost)
    np.testing.assert_array_equal(np.asarray(hj.hit), ~lost)
    assert bool(torch.isfinite(th.shoot_brute(sp.scene, rays).t).all())


def test_scatter_plain_at_config5_keys():
    """The scatter's plain version at config 5's 5,242,892 polygon keys
    (above the 2^22 - 1 that the kernel's 32-bit pairs hold) equals a NumPy
    fold in its fixed order: each chunk of CHUNK positions summed by key
    from +0.0 in index order, a key's chunk sums added in chunk order; runs
    across chunks, on the top keys."""
    n_keys, m = 5_242_892, 3 * CHUNK + 17
    rng = np.random.default_rng(8)
    keys = rng.integers(0, n_keys, m)
    keys[CHUNK - 200:CHUNK + 200] = n_keys - 1 - rng.integers(0, 3, 400)
    values = rng.normal(size=m).astype(np.float32)
    values[::97] = -0.0
    want = np.zeros(n_keys, np.float32)
    for s in range(0, m, CHUNK):
        sums = {}
        for i in range(s, min(s + CHUNK, m)):
            sums[keys[i]] = np.float32(sums.get(keys[i], np.float32(0.0)) + values[i])
        for k, x in sums.items():
            want[k] = np.float32(want[k] + x)
    got = scatter_add_plain(torch.from_numpy(keys.astype(np.int32)), torch.from_numpy(values),
                            n_keys)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


# The transpose of absorption[pid] (hare_tpu/trace/bounce.py:194) against
# the port's in another order: JAX's scatter-add sums each key's values in
# one pass, the port a chunk of CHUNK positions at a time, then the chunks'
# sums.  Each sum is within a few float32 roundings of its |values|' sum.
SCATTER_JAX_RTOL = 1e-5


def test_scatter_plain_at_config5_keys_against_jax():
    """The scatter's plain version at config 5's 5,242,892 polygon keys
    against JAX's transpose of the absorption gather (jax.grad of
    sum(absorption[pid] * v)) on the same seeded keys and values, runs
    across chunks: within SCATTER_JAX_RTOL of the largest per-key sum of
    |values|."""
    n_keys, m = 5_242_892, 3 * CHUNK + 17
    rng = np.random.default_rng(15)
    pid = rng.integers(0, n_keys, m)
    pid[CHUNK - 300:CHUNK + 300] = n_keys - 1 - rng.integers(0, 3, 600)
    pid[2 * CHUNK - 50:] = rng.integers(0, 12, m - 2 * CHUNK + 50)  # the walls: long runs
    v = rng.normal(size=m).astype(np.float32)

    def loss(absorption):
        return jnp.sum(absorption[jnp.asarray(pid, jnp.int32)] * v)

    want = np.asarray(jax.grad(loss)(jnp.zeros(n_keys, jnp.float32)))
    got = scatter_add_plain(torch.from_numpy(pid.astype(np.int32)), torch.from_numpy(v),
                            n_keys).numpy()
    scale = np.zeros(n_keys, np.float64)
    np.add.at(scale, pid, np.abs(v).astype(np.float64))
    assert got.shape == want.shape == (n_keys,)
    assert np.abs(got.astype(np.float64) - want).max() <= SCATTER_JAX_RTOL * scale.max()
    np.testing.assert_array_equal(got != 0, scale != 0)


@pytest.mark.parametrize("m, cols, n_keys", [
    (0, 1, 0), (1, 3, 1), (CHUNK + 1, 1, 4_000), (3 * CHUNK + 17, 3, 5_242_892)])
def test_scatter_scratch_words_cover_the_pairs(m, cols, n_keys):
    """scratch_words holds the kernel's worst case: each chunk's distinct
    keys, their sums and counts, where its pairs start, their places in
    their ranges and their count;
    two words for every (range, chunk) pair, as many as the values where
    every value of a chunk lies in a range of MIN_RANGE keys of its own;
    a count and an offset for every such range, and one offset more.  It
    grows by two words a range of MIN_RANGE keys."""
    n_chunks = -(-m // CHUNK)
    ranges = -(-n_keys // MIN_RANGE)
    pos = np.arange(m)
    keys = pos % CHUNK * MIN_RANGE % max(n_keys, 1)  # distinct ranges in a chunk, where they fit
    pairs = len(set(zip((pos // CHUNK).tolist(), (keys // MIN_RANGE).tolist())))
    chunk_words = n_chunks * (CHUNK * (3 + cols) + 2)
    words = scratch_words(m, cols, n_keys)
    assert words >= chunk_words + 2 * pairs + 2 * ranges + 1
    assert words == chunk_words + 2 * m + 2 * ranges + 1
    if n_keys >= CHUNK * MIN_RANGE:
        assert pairs == m
    assert scratch_words(m, cols, n_keys + MIN_RANGE) == words + 2
