"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped on hosts without an NVIDIA GPU.  The machine with the
card has no JAX, so run these without the repo's conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.common import finalize_hits, finalize_hits_plain  # noqa: E402
from hare_tpu_torch.accel.voxel import build_voxel_grid, grid_shoot, grid_shoot_plain  # noqa: E402
from hare_tpu_torch.benchmarks import pallas_probe as probes  # noqa: E402
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


def assert_same_nearest(kernel_out, plain_out):
    (tk, ik), (tp, ip) = kernel_out, plain_out
    hit = torch.isfinite(tp)
    assert torch.equal(torch.isfinite(tk), hit)
    torch.testing.assert_close(tk[hit], tp[hit], rtol=RTOL, atol=ATOL)
    flips = (ik != ip) & hit
    assert int(flips.sum()) <= max(1, hit.numel() // 1000)  # equal-t ties only


SCENES = [
    ("shoebox", lambda: shapes.shoebox(4, 5, 3), dict(domain=4), (0.2, 4.8)),
    ("icosphere", lambda: shapes.icosphere(2), dict(domain=8), (-4.0, 4.0)),
    ("soup", lambda: shapes.random_soup(300, seed=11), dict(avg_polys=8.0), (-1.0, 11.0)),
]


@pytest.mark.parametrize("kernel", ["watertight", "mt"])
@pytest.mark.parametrize("name, faces, kw, box", SCENES, ids=[s[0] for s in SCENES])
def test_grid_shoot_matches_plain(dev, name, faces, kw, box, kernel):
    top = th.Topology.build(faces())
    grid = build_voxel_grid(top, device=dev, **kw)
    rays = rays_of(np.random.default_rng(3), box[0], box[1], 4096, dev)
    assert_same_nearest(grid_shoot(rays, grid, kernel), grid_shoot_plain(rays, grid, kernel))


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
