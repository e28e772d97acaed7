"""K4, the bounce step's wrapper, on the CPU.

``fused_bounce_step`` (``hare_tpu_torch.trace.bounce``) is the
``torch.autograd.Function`` that ``trace_rays`` calls: on CUDA tensors it
launches K4 forward and backward, on CPU tensors it runs ``bounce_step``
and autograd through it.  Here, on the CPU: the wrapper against
``bounce_step`` and its autograd to the bit on records from brute and the
grid (specular and scattering; absorption, scattering and vertex losses),
which gradients its backward is asked for, whole traces against the plain
step's loop and against the JAX package (JAX's draws patched in, as
``tests/test_torch_scattering.py`` does), remat to the bit, and K4's bound.
The kernel itself is held against these on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.benchmarks import bounds  # noqa: E402
from hare_tpu_torch.benchmarks.bench_scene import bounce_inputs  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace import bounce  # noqa: E402
from hare_tpu_torch.trace.bounce import BounceState  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise.
CPU = "cpu"
ROOM = (4, 5, 3)
N_RAYS, N_BOUNCES, N_BINS, BIN_DT = 1024, 3, 64, 1e-3
# tests/test_torch_trace.py's and test_torch_scattering.py's tolerances
# against JAX: per-bounce energies and times the same products and sums in
# f32 (XLA may fuse them otherwise); a time at a bin edge may bin apart;
# gradients sum over many lanes in another order.
RTOL, GRAD_RTOL = 1e-5, 1e-4
# Lanes whose arrival times agree within RTOL yet fall on either side of a
# bin edge (scattering weights a lane's energy up to 2^3, so one such lane
# can outweigh a share of the total): at most this share of the lanes,
# left out of both histograms before they are compared.
BIN_EDGE_SHARE = 2e-3
# The losses: which of the step's differentiable inputs take a gradient.
LOSSES = {
    "absorption": ("energy", "absorption"),
    "scattering": ("energy", "absorption", "scattering"),
    "vertices": ("dist", "origin", "direction", "t", "point", "normal"),
    "all": bounce.GRADS,
}


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(x, y):
    return x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def room_faces():
    return shapes.shoebox(*ROOM) + shapes.icosphere(2, radius=0.7, center=(2.0, 3.5, 1.2))


@pytest.fixture(scope="module", params=["brute", "grid"])
def steps(request):
    """Each bounce's step inputs of a scattering trace (and of a specular
    one) through brute or the grid on the room with a sphere: the records
    and states the bounce step receives."""
    top = th.Topology.build(room_faces())
    kw = {"domain": 6} if request.param == "grid" else {}
    sp = th.SpatialPartition(top, accel=request.param, device=CPU, **kw)
    rng = np.random.default_rng(5)
    o = rng.uniform(0.3, 2.7, (N_RAYS, 3)).astype(np.float32)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(rand_dirs(rng, N_RAYS)))
    a = torch.from_numpy(rng.uniform(0.1, 0.5, top.n_polys).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.2, 0.8, top.n_polys).astype(np.float32))
    out = {"specular": (a, None, bounce_inputs(sp, rays, a, N_BOUNCES))}
    out["scattering"] = (a, s, bounce_inputs(sp, rays, a, N_BOUNCES, scattering=s,
                                             generator=torch.Generator().manual_seed(3)))
    return out


def step_outputs(nxt, outs):
    return list(nxt) + list(outs)


@pytest.mark.parametrize("branch", ["specular", "scattering"])
def test_wrapper_forward_is_bounce_step(steps, branch):
    """The wrapper on CPU tensors gives bounce_step's outputs to the bit,
    every bounce; a record without edge_nbr reads the scene's tri_meta."""
    a, s, inputs = steps[branch]
    assert len(inputs) == N_BOUNCES
    for state, hr, draws, ss, tri_meta in inputs:
        want = step_outputs(*bounce.bounce_step(state, hr, a, s, draws, ss))
        for rec in (hr, hr._replace(edge_nbr=None)):
            got = step_outputs(*bounce.fused_bounce_step(state, rec, a, s, draws, ss, tri_meta))
            assert len(got) == len(want) == 12
            assert all(same(x, y) for x, y in zip(got, want))


def leaves_of(state, hr, a, s, loss):
    """The step's differentiable inputs as leaves, those of ``loss``
    requiring grad."""
    named = dict(zip(bounce.GRADS, (state.energy, state.dist, state.origin, state.direction,
                                     hr.t, hr.point, hr.normal, a, s)))
    return {k: None if v is None else v.detach().clone().requires_grad_(k in LOSSES[loss])
            for k, v in named.items()}


def run_step(fn, state, hr, leaves, draws, ss, tri_meta=None):
    st = state._replace(energy=leaves["energy"], dist=leaves["dist"], origin=leaves["origin"],
                        direction=leaves["direction"])
    rec = hr._replace(t=leaves["t"], point=leaves["point"], normal=leaves["normal"])
    args = (st, rec, leaves["absorption"], leaves["scattering"], draws, ss)
    nxt, outs = fn(*args, tri_meta) if tri_meta is not None else fn(*args)
    return (nxt.origin, nxt.direction, nxt.energy, nxt.dist, outs[1], outs[2], outs[5])


def cotangents(n, seed, last):
    """Seeded cotangents of the step's seven differentiable outputs, some
    of them -0.0 and +0.0; the next state's absent on the last bounce."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for k, shape in enumerate([(n, 3), (n, 3), (n,), (n,), (n,), (n,), (n,)]):
        x = torch.randn(shape, generator=g)
        x.view(-1)[:5] = -0.0
        x.view(-1)[5:9] = 0.0
        out.append(None if last and k < 4 else x)
    return out


@pytest.mark.parametrize("branch, loss", [
    (b, loss) for b in ("specular", "scattering") for loss in LOSSES
    if not (b == "specular" and loss == "scattering")])
def test_wrapper_backward_is_autograd(steps, branch, loss):
    """The wrapper's backward on CPU tensors against autograd through
    bounce_step, from the same cotangents: every gradient to the bit,
    signed zeros included, and None exactly where autograd's is."""
    a, s, inputs = steps[branch]
    for b, (state, hr, draws, ss, tri_meta) in enumerate(inputs):
        cot = cotangents(state.energy.shape[0], b, last=b == len(inputs) - 1)
        got = []
        for fn, meta in ((bounce.fused_bounce_step, tri_meta), (bounce.bounce_step, None)):
            leaves = leaves_of(state, hr, a, s, loss)
            ys = run_step(fn, state, hr, leaves, draws, ss, meta)
            pairs = [(y, g) for y, g in zip(ys, cot) if g is not None and y.requires_grad]
            want = [v for v in leaves.values() if v is not None and v.requires_grad]
            got.append(torch.autograd.grad([y for y, _ in pairs], want, [g for _, g in pairs],
                                           allow_unused=True))
        for x, y in zip(*got):
            assert (x is None) == (y is None)
            assert x is None or same(x, y)


def test_backward_asks_only_what_the_loss_needs(steps, monkeypatch):
    """A loss w.r.t. absorption alone asks the backward for the energy
    chain only (the state's energy and the table), and the trace's
    geometric outputs stay out of the graph, so A3 is never reached."""
    a, _, inputs = steps["specular"]
    asked = []

    def spy(state, hr, absorption, scattering, draws, cot, wanted, ss):
        asked.append(bounce._reached(cot, wanted, scattering))
        return bounce.bounce_bwd_plain(state, hr, absorption, scattering, draws, cot, wanted, ss)

    monkeypatch.setattr(bounce, "bounce_step_bwd", spy)
    state, hr, draws, ss, tri_meta = inputs[1]
    leaves = leaves_of(state, hr, a, None, "absorption")
    ys = run_step(bounce.fused_bounce_step, state, hr, leaves, draws, ss, tri_meta)
    assert [y.requires_grad for y in ys] == [False, False, True, False, True, False, False]
    (ys[2].sum() + ys[4].sum()).backward()
    assert asked == [tuple(k in ("energy", "absorption") for k in bounce.GRADS)]


def plain_trace(scene, rays, absorption, n_bounces, shoot_fn, aux, scattering=None, draws=None):
    """trace_rays' loop with bounce_step and autograd through it, the
    wrapper left out."""
    o = rays.origin
    n = o.shape[0]
    state = BounceState(o, bounce.normalize(rays.direction), rays.exclude_poly,
                        torch.ones(n), torch.zeros(n), torch.ones(n, dtype=torch.bool))
    outs = []
    for b in range(n_bounces):
        hr = shoot_fn(scene, th.Ray(state.origin, state.direction, state.exclude), aux)
        state, out = bounce.bounce_step(state, hr, absorption, scattering,
                                        None if draws is None else tuple(x[b] for x in draws))
        outs.append(out)
    return th.TraceResult(*(torch.stack(x) for x in zip(*outs)))


@pytest.mark.parametrize("accel", ["brute", "grid"])
def test_trace_through_wrapper_is_the_plain_loop(accel):
    """trace_rays (the wrapper each bounce) against the same loop over
    bounce_step, with scattering: every output, the hard histogram, the
    gradients w.r.t. absorption and scattering and the soft histogram's
    vertex gradient, to the bit."""
    top = th.Topology.build(room_faces())
    kw = {"domain": 6} if accel == "grid" else {}
    sp = th.SpatialPartition(top, accel=accel, device=CPU, **kw)
    rng = np.random.default_rng(8)
    o = rng.uniform(0.3, 2.7, (512, 3)).astype(np.float32)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(rand_dirs(rng, 512)))
    a0 = torch.from_numpy(rng.uniform(0.1, 0.5, top.n_polys).astype(np.float32))
    s0 = torch.from_numpy(rng.uniform(0.2, 0.8, top.n_polys).astype(np.float32))
    draws = bounce.scatter_draws(torch.Generator().manual_seed(6), 4, 512, torch.float32, CPU)
    out = []
    for wrapped in (True, False):
        a, s = a0.clone().requires_grad_(), s0.clone().requires_grad_()
        v = sp.scene.vertices.clone().requires_grad_()
        scene = sp.scene.with_vertices(v)
        if wrapped:
            res = th.trace_rays(scene, rays, a, 4, sp.shoot_fn, aux=sp.aux, scattering=s,
                                draws=draws)
        else:
            res = plain_trace(scene, rays, a, 4, sp.shoot_fn, sp.aux, s, draws)
        h = th.energy_histogram(res, N_BINS, BIN_DT)
        hs = th.energy_histogram(res, N_BINS, BIN_DT, soft=True)
        (h.sum() + (hs * torch.arange(N_BINS)).sum()).backward()
        out.append([x.detach() for x in res] + [h.detach(), a.grad, s.grad, v.grad])
    for x, y in zip(*out):
        assert same(x, y)


@pytest.mark.parametrize("scattering", [False, True], ids=["specular", "scattering"])
def test_remat_through_wrapper_is_bitwise(scattering):
    """Per-bounce remat with the wrapper: the vertex and absorption
    gradients (and scattering's) equal the plain trace's to the bit."""
    top = th.Topology.build(room_faces())
    sp = th.SpatialPartition(top, domain=6, device=CPU)
    rng = np.random.default_rng(9)
    o = rng.uniform(0.3, 2.7, (256, 3)).astype(np.float32)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(rand_dirs(rng, 256)))
    out = []
    for remat in (False, True):
        a = torch.full((top.n_polys,), 0.3, requires_grad=True)
        s = torch.full((top.n_polys,), 0.4, requires_grad=True) if scattering else None
        v = sp.scene.vertices.clone().requires_grad_()
        res = th.trace_rays(sp.scene.with_vertices(v), rays, a, 5, sp.shoot_fn, aux=sp.aux,
                            scattering=s, generator=torch.Generator().manual_seed(2),
                            remat=remat)
        hs = th.energy_histogram(res, N_BINS, BIN_DT, soft=True)
        (hs * torch.arange(N_BINS)).sum().backward()
        out.append([hs.detach(), a.grad, v.grad] + ([s.grad] if scattering else []))
    for x, y in zip(*out):
        assert same(x, y)


def jax_draws(key, n_bounces, n):
    """JAX's scattering draws as scatter_draws lays them out (the key split
    as hare_tpu/trace/bounce.py:198-206 and :76-78 split it)."""
    coin, r1, r2 = [], [], []
    for k in jax.random.split(key, n_bounces):
        kb, kd = jax.random.split(k)
        coin.append(jax.random.bernoulli(kb, 0.5, (n,)))
        k1, k2 = jax.random.split(kd)
        r1.append(jax.random.uniform(k1, (n,), jnp.float32))
        r2.append(jax.random.uniform(k2, (n,), jnp.float32))
    return tuple(torch.from_numpy(np.array(jnp.stack(x))) for x in (coin, r1, r2))


@pytest.mark.parametrize("accel", ["brute", "grid"])
@pytest.mark.parametrize("scattering", [False, True], ids=["specular", "scattering"])
def test_trace_through_wrapper_matches_jax(accel, scattering):
    """trace_rays through the wrapper against hare_tpu.trace_rays on the
    shoebox (JAX on the CPU, its draws handed to the port): hits and
    polygons equal; energies and times within RTOL; the totals within RTOL
    and the histograms bin by bin, lanes binned apart (at most
    BIN_EDGE_SHARE) left out of both; the histogram sum's gradients w.r.t.
    absorption (and scattering), which no binning moves, within
    GRAD_RTOL."""
    rng = np.random.default_rng(11)
    n = 512
    o = rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (n, 3)).astype(np.float32)
    d = rand_dirs(rng, n)
    absorption = rng.uniform(0.1, 0.5, 12).astype(np.float32)
    scat = rng.uniform(0.2, 0.8, 12).astype(np.float32) if scattering else None
    key = jax.random.PRNGKey(31)
    kw = {"domain": 4} if accel == "grid" else {}
    jsp = jh.SpatialPartition(jh.Topology.build(jshapes.shoebox(*ROOM)), accel=accel, **kw)

    def loss(a, s):
        res = jh.trace_rays(jsp.scene, jh.Ray.make(o, d), a, N_BOUNCES, jsp.shoot_fn,
                            aux=jsp.aux, scattering=s, key=key if scattering else None)
        hist = jh.energy_histogram(res, N_BINS, BIN_DT)
        return jnp.sum(hist), (res, hist)

    args = (jnp.asarray(absorption), None if scat is None else jnp.asarray(scat))
    (_, (rj, hj)), gj = jax.value_and_grad(loss, argnums=(0, 1) if scattering else 0,
                                           has_aux=True)(*args)
    rj, hj = jax.tree.map(np.asarray, rj), np.asarray(hj)
    gj = [np.asarray(g) for g in (gj if scattering else (gj,))]

    sp = th.SpatialPartition(th.Topology.build(shapes.shoebox(*ROOM)), accel=accel, device=CPU,
                             **kw)
    a = torch.tensor(absorption, requires_grad=True)
    s = None if scat is None else torch.tensor(scat, requires_grad=True)
    res = th.trace_rays(sp.scene, th.Ray.make(torch.from_numpy(o), torch.from_numpy(d)), a,
                        N_BOUNCES, sp.shoot_fn, aux=sp.aux, scattering=s,
                        draws=jax_draws(key, N_BOUNCES, n) if scattering else None)
    hist = th.energy_histogram(res, N_BINS, BIN_DT)
    hist.sum().backward()
    rt = th.TraceResult(*(x.detach().numpy() for x in res))
    np.testing.assert_array_equal(rt.hit, rj.hit)
    np.testing.assert_array_equal(rt.poly_id, rj.poly_id)
    np.testing.assert_allclose(rt.energy, rj.energy, rtol=RTOL)
    np.testing.assert_allclose(rt.time, rj.time, rtol=RTOL)
    ht = hist.detach().numpy()
    np.testing.assert_allclose(ht.sum(), hj.sum(), rtol=RTOL)
    bins = [np.clip((r.time / BIN_DT).astype(np.int64), 0, N_BINS - 1) for r in (rt, rj)]
    apart = rj.hit & (bins[0] != bins[1])
    assert apart.sum() <= BIN_EDGE_SHARE * apart.size, int(apart.sum())
    keep = rj.hit & ~apart
    kept = []
    for r, b in zip((rt, rj), bins):
        h = np.zeros(N_BINS)
        np.add.at(h, b[keep], r.energy[keep])
        kept.append(h)
    np.testing.assert_allclose(kept[0], kept[1], rtol=RTOL, atol=RTOL * hj.max())
    for got, want in zip([a.grad] + ([s.grad] if scattering else []), gj):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(want).max()))


def test_record_without_edge_nbr_needs_tri_meta(steps):
    a, _, inputs = steps["specular"]
    state, hr, draws, ss, _ = inputs[0]
    with pytest.raises(ValueError, match="tri_meta"):
        bounce.fused_bounce_step(state, hr._replace(edge_nbr=None), a, None, draws, ss)


def test_kernel_wrappers_need_the_card(steps):
    """On a host without CUDA the kernel launchers raise, never running the
    plain version in their place."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    a, _, inputs = steps["specular"]
    state, hr, draws, ss, tri_meta = inputs[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        bounce.bounce_kernel(state, hr, a, None, draws, ss, tri_meta)
    cot = cotangents(state.energy.shape[0], 0, last=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bounce.bounce_bwd_kernel(state, hr, a, None, draws, cot, (True,) * 8 + (False,), ss)


@pytest.mark.parametrize("branch", ["specular", "scattering"])
def test_bounce_step_bounds(steps, branch):
    """K4's bound counts what the step must move: the record, the state and
    the next state a ray, each distinct polygon's table entries, the draws
    with scattering; the backward the cotangents given and the gradients
    asked for.  Bytes bound it."""
    a, s, inputs = steps[branch]
    state, hr, draws, ss, _ = inputs[0]
    n = state.energy.shape[0]
    polys = int(torch.unique(torch.clamp(hr.poly_id, min=0)).numel())
    diffuse = None if s is None else draws[0]
    fwd = bounds.bounce_step_bound(hr.poly_id, diffuse)
    per_ray = (bounds.BOUNCE_IN_BYTES + bounds.BOUNCE_OUT_BYTES
               + (bounds.BOUNCE_DRAW_BYTES if s is not None else 0))
    assert fwd["bytes"] == n * per_ray + polys * 4 * (2 if s is not None else 1)
    assert fwd["bound_by"] == "bytes" and fwd["bound_ms"] > 0
    cot = cotangents(n, 1, last=False)
    wanted = tuple(k in ("energy", "absorption") for k in bounce.GRADS)
    bwd = bounds.bounce_step_bwd_bound(hr.poly_id, cot, wanted, diffuse)
    # energy, alive, hit, poly (and the coin); the two energy cotangents;
    # d(energy), d(a).
    extra = 1 if s is not None else 0
    assert bwd["bytes"] == n * (4 + 1 + 1 + 4 + 8 + 8 + extra) + polys * 4 * (
        2 if s is not None else 1)
    assert bwd["bound_by"] == "bytes"
