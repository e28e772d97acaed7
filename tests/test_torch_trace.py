"""Port parity: the whole slice (trace, histogram, absorption gradient).

JAX ``trace_rays`` + ``energy_histogram`` + ``jax.value_and_grad`` against the
port's plain versions on identical tables and rays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.voxel import shoot_grid  # noqa: E402
from hare_tpu_torch.convert import grid_from_numpy, scene_from_numpy  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace.bounce import histogram_plain  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

N_RAYS, N_BOUNCES, N_BINS, BIN_DT = 512, 4, 64, 1e-3
# Per-bounce energies and times: the same products and sums in f32.
RTOL = 1e-5
# A hit time within an ulp of a bin edge may land in the neighbouring bin:
# per-bin L1 difference, as a share of the total energy.
BIN_FLIP_SHARE = 1e-4
# Absorption gradients sum per-bin incoming gradients over many lanes.
GRAD_RTOL = 1e-4


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def slice_runs():
    """One run of each package on shoebox(4,5,3), grid domain=4."""
    rng = np.random.default_rng(7)
    top = jh.Topology.build(jshapes.shoebox(4, 5, 3))
    sp = jh.SpatialPartition(top, accel="grid", domain=4)
    o = rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (N_RAYS, 3)).astype(np.float32)
    d = rand_dirs(rng, N_RAYS)
    absorption = rng.uniform(0.1, 0.5, top.n_polys).astype(np.float32)

    def loss(a):
        res = jh.trace_rays(sp.scene, jh.Ray.make(o, d), a, N_BOUNCES, sp.shoot_fn, aux=sp.aux)
        hist = jh.energy_histogram(res, N_BINS, BIN_DT)
        return jnp.sum(hist), (res, hist)

    (_, (res_j, hist_j)), g_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(absorption))
    jax_out = jax.tree.map(np.asarray, (res_j, hist_j, g_j))

    scene = scene_from_numpy({k: np.asarray(v) for k, v in sp.scene._asdict().items()}, device=CPU)
    g = sp.struct
    grid = grid_from_numpy(
        {k: np.asarray(getattr(g, k)) for k in ("cell_meta", "win_data", "grid_min", "voxel_size")},
        g.dims, g.char_step, g.max_cell_wins, g.n_tris, device=CPU,
    )
    a_t = torch.tensor(absorption, requires_grad=True)
    res_t = th.trace_rays(
        scene, th.Ray.make(torch.from_numpy(o), torch.from_numpy(d)), a_t,
        N_BOUNCES, lambda sc, r, aux: shoot_grid(sc, r, aux), aux=grid,
    )
    hist_t = th.energy_histogram(res_t, N_BINS, BIN_DT)
    hist_t.sum().backward()
    ours = (
        th.TraceResult(*(x.detach().numpy() for x in res_t)),
        hist_t.detach().numpy(),
        a_t.grad.numpy(),
    )
    return jax_out, ours


def test_slice_trace_parity(slice_runs):
    (rj, _, _), (rt, _, _) = slice_runs
    np.testing.assert_array_equal(rt.hit, rj.hit)
    np.testing.assert_array_equal(rt.poly_id, rj.poly_id)
    assert rj.hit.all()  # closed room: every ray hits on every bounce
    np.testing.assert_allclose(rt.energy, rj.energy, rtol=RTOL)
    np.testing.assert_allclose(rt.time, rj.time, rtol=RTOL)
    # Hit parameters measured from origins that are themselves f32 hit
    # points of up to 5 m: a few ulps (~5e-7 m each) absolute.
    np.testing.assert_allclose(rt.t, rj.t, rtol=RTOL, atol=1e-5)


def test_slice_histogram_and_grad_parity(slice_runs):
    (rj, hj, gj), (rt, ht, gt) = slice_runs
    total = hj.sum()
    np.testing.assert_allclose(ht.sum(), total, rtol=RTOL)
    np.testing.assert_allclose(ht.sum(), rt.energy.sum(), rtol=RTOL)  # conserved
    assert np.abs(ht - hj).sum() <= BIN_FLIP_SHARE * total
    assert (gt < 0).all()
    np.testing.assert_allclose(gt, gj, rtol=GRAD_RTOL)


def test_energy_histogram_parity(rng):
    """Hard binning with dead lanes, negative and past-window times, and its
    backward, against JAX on the same synthetic trace record."""
    b, n, bins = 3, 400, 32
    energy = rng.uniform(0, 1, (b, n)).astype(np.float32)
    time = rng.uniform(-0.005, 0.05, (b, n)).astype(np.float32)
    hit = rng.uniform(size=(b, n)) < 0.8
    ct = rng.normal(size=bins).astype(np.float32)
    zeros = np.zeros((b, n), np.float32)

    def jhist(e):
        res = jh.trace.TraceResult(jnp.asarray(hit), e, jnp.asarray(time),
                                   zeros.astype(np.int32), zeros[..., None], zeros)
        return jh.energy_histogram(res, bins, BIN_DT)

    hj, vjp = jax.vjp(jhist, jnp.asarray(energy))
    (gj,) = vjp(jnp.asarray(ct))
    e_t = torch.tensor(energy, requires_grad=True)
    res = th.TraceResult(torch.from_numpy(hit), e_t, torch.from_numpy(time),
                         None, None, None)
    ht = th.energy_histogram(res, bins, BIN_DT)
    ht.backward(torch.from_numpy(ct))
    # Per-bin sums of the same values in another order.
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(e_t.grad.numpy(), np.asarray(gj))
    np.testing.assert_allclose(
        histogram_plain(e_t.detach(), res.time, res.hit, bins, BIN_DT).sum().item(),
        energy[hit].sum(), rtol=RTOL,
    )


def test_edge_reflection_excludes_coplanar_neighbor(rng):
    """tests/test_exclusion.py on the port: reflections landing ON the
    shared diagonal of two coplanar floor polygons never re-hit either at
    tiny t on the next bounce."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    sp = th.SpatialPartition(top, accel="grid", domain=4, device=CPU)
    v = sp.scene.vertices.numpy()
    tv = sp.scene.tri_v.numpy()[: top.n_tris]
    tp = sp.scene.tri_poly.numpy()
    floor = np.nonzero([np.allclose(v[tv[t]][:, 2], 0.0) for t in range(top.n_tris)])[0]
    assert len(floor) == 2
    shared = np.intersect1d(tv[floor[0]], tv[floor[1]])
    assert len(shared) == 2
    a, b = v[shared[0]], v[shared[1]]
    floor_polys = {int(tp[floor[0]]), int(tp[floor[1]])}

    n = 32
    lam = rng.uniform(0.1, 0.9, n).astype(np.float32)
    targets = a[None] + lam[:, None] * (b - a)[None]
    origins = np.tile(np.array([[2.0, 2.5, 2.0]], np.float32), (n, 1))
    origins[:, 0] += rng.uniform(-1, 1, n)
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res = th.trace_rays(
        sp.scene, th.Ray.make(torch.from_numpy(origins), torch.from_numpy(d.astype(np.float32))),
        torch.zeros(top.n_polys), 2, sp.shoot_fn, aux=sp.aux,
    )
    assert res.hit[0].all()
    assert all(int(p) in floor_polys for p in res.poly_id[0])
    for i in range(n):
        if res.hit[1, i] and int(res.poly_id[1, i]) in floor_polys:
            assert res.t[1, i] > 0.05, (i, res.t[1, i], res.poly_id[1, i])


def test_uniform_sphere():
    g = torch.Generator().manual_seed(0)
    d = th.uniform_sphere(4096, g, device=CPU)
    assert d.shape == (4096, 3) and d.dtype == torch.float32
    np.testing.assert_allclose(d.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    assert abs(d.mean(0)).max() < 0.05  # uniform: no preferred direction
    again = th.uniform_sphere(4096, torch.Generator().manual_seed(0), device=CPU)
    assert torch.equal(d, again)
