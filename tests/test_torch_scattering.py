"""Port parity: scattering, per-bounce remat, the surface samplers.

Mirrors ``tests/test_trace.py``'s scattering, remat and sampler tests on the
port.  ``torch.Generator`` streams differ from ``jax.random``'s, so the
parity tests patch ``hare_tpu_torch.trace.bounce.scatter_draws`` to return
JAX's own draws (the coin and the lobe's uniforms of every bounce, split
from the key as JAX's ``trace_rays`` splits them); the port then traces
what JAX traces.  Statistics, repeats, finite differences and recovery run
on the port's own generator.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.accel import shoot_brute as jax_shoot_brute  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402
from hare_tpu.trace import cosine_lobe as jax_cosine_lobe  # noqa: E402
from hare_tpu.trace import triangle_points as jax_triangle_points  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.geom.math import normalize  # noqa: E402
from hare_tpu_torch.geom.primitives import NO_POLY  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402
from hare_tpu_torch.trace import bounce  # noqa: E402
from hare_tpu_torch.trace.sampler import warp_triangle  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

ROOM = (4, 5, 3)
SOURCE = (2.0, 2.5, 1.5)
N_RAYS, N_BOUNCES, N_BINS, BIN_DT = 512, 4, 64, 1e-3
# The lobe: the same arithmetic, where XLA's and torch's sqrt, cos and sin
# may differ by an ulp of a unit vector's component.
LOBE_ATOL = 1e-6
# tests/test_torch_trace.py's tolerances: per-bounce energies and times the
# same products and sums in f32; a time within an ulp of a bin edge may land
# in the neighbouring bin; gradients sum per-bin gradients over many lanes.
RTOL = 1e-5
BIN_FLIP_SHARE = 1e-4
GRAD_RTOL = 1e-4
# Vertex gradients: tests/test_torch_vertex_grads.py's descent test.
VERTEX_RTOL = 1e-4
# assert_t_close: the incidence cosine below which a hit grazes, and the
# share of lanes whose t may follow such a hit beyond RTOL.
GRAZING, MAX_GRAZED = 0.05, 1e-2


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def jax_draws(key, n_bounces, n):
    """JAX's scattering draws as ``scatter_draws`` returns them: the key
    split into one key a bounce, each split into the coin's and the lobe's,
    the lobe's into its two uniforms (``hare_tpu/trace/bounce.py:198-206,
    :76-78``)."""
    coin, r1, r2 = [], [], []
    for k in jax.random.split(key, n_bounces):
        kb, kd = jax.random.split(k)
        coin.append(jax.random.bernoulli(kb, 0.5, (n,)))
        k1, k2 = jax.random.split(kd)
        r1.append(jax.random.uniform(k1, (n,), jnp.float32))
        r2.append(jax.random.uniform(k2, (n,), jnp.float32))
    return tuple(torch.from_numpy(np.array(jnp.stack(x))) for x in (coin, r1, r2))


def patch_draws(mp, key, n_bounces, n):
    draws = jax_draws(key, n_bounces, n)
    mp.setattr(bounce, "scatter_draws", lambda *args: draws)


def port_partition(accel):
    kw = {"domain": 4} if accel == "grid" else {}
    return th.SpatialPartition(th.Topology.build(shapes.shoebox(*ROOM)), accel=accel,
                               device=CPU, **kw)


def jax_partition(accel):
    kw = {"domain": 4} if accel == "grid" else {}
    return jh.SpatialPartition(jh.Topology.build(jshapes.shoebox(*ROOM)), accel=accel, **kw)


def room_rays(seed, n, spread=True):
    rng = np.random.default_rng(seed)
    if spread:
        o = rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (n, 3)).astype(np.float32)
    else:
        o = np.tile(np.array([SOURCE], np.float32), (n, 1))
    return o, rand_dirs(rng, n)


def torch_rays(o, d):
    return th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))


def seeded(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- the lobe


def lobe_cases():
    """Unit normals (as the trace's ``n_hat``) with nz < 0, nz = +-0.0
    (after orientation too), nz = +-1, axis normals and random ones, each
    against an incoming ray from either side."""
    rng = np.random.default_rng(3)
    special = np.array([
        [0, 0, 1], [0, 0, -1], [1, 0, 0], [1, 0, -0.0], [-1, 0, 0], [0, 1, 0], [0, -1, -0.0],
        [0.6, 0, -0.8], [0, 0.8, -0.6], [0.3, -0.4, -0.866], [1e-4, 0, -1], [0, 0, 1 - 1e-7],
    ], np.float32)
    rand = rng.normal(0, 1, (244, 3))
    rand = (rand / np.linalg.norm(rand, axis=1, keepdims=True)).astype(np.float32)
    normals = np.concatenate([special / np.linalg.norm(special, axis=1, keepdims=True), rand])
    incoming = rand_dirs(rng, normals.shape[0])
    normals = np.concatenate([normals, normals])
    incoming = np.concatenate([incoming, -incoming])
    return normals, incoming


def test_cosine_lobe_matches_jax():
    normals, incoming = lobe_cases()
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_cosine_lobe(key, jnp.asarray(normals), jnp.asarray(incoming)))
    k1, k2 = jax.random.split(key)
    n = normals.shape[0]
    r1 = torch.from_numpy(np.array(jax.random.uniform(k1, (n,), jnp.float32)))
    r2 = torch.from_numpy(np.array(jax.random.uniform(k2, (n,), jnp.float32)))
    got = th.cosine_lobe(torch.from_numpy(normals), torch.from_numpy(incoming), r1, r2).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOBE_ATOL)
    # Unit, and on the reflection side.
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    side = np.sign(np.sum(normals * incoming, axis=1)) * np.sum(normals * got, axis=1)
    assert (side <= 1e-6).all()


def test_cosine_lobe_gradient_matches_jax():
    """d/d(normal) of the lobe (the diffuse direction's path to the
    vertices), sign(dot) contributing 0 in both packages."""
    normals, incoming = lobe_cases()
    key = jax.random.PRNGKey(8)
    k1, k2 = jax.random.split(key)
    n = normals.shape[0]
    r1 = jax.random.uniform(k1, (n,), jnp.float32)
    r2 = jax.random.uniform(k2, (n,), jnp.float32)
    w = np.random.default_rng(5).normal(0, 1, (n, 3)).astype(np.float32)
    want = np.asarray(jax.grad(lambda nm: jnp.sum(
        jax_cosine_lobe(key, nm, jnp.asarray(incoming)) * w))(jnp.asarray(normals)))
    nm = torch.from_numpy(normals).requires_grad_()
    lobe = th.cosine_lobe(nm, torch.from_numpy(incoming), torch.from_numpy(np.array(r1)),
                          torch.from_numpy(np.array(r2)))
    (lobe * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(nm.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# ------------------------------------------------------- the trace, parity


def assert_t_close(rt, rj, o, poly_normal):
    """Hit parameters within RTOL (atol 1e-5), except on rays whose path
    grazed a wall before: an ulp of a lobe direction (XLA's and torch's cos
    and sin) moves a hit at incidence cosine c by about the path length x
    ulp / c, and the next bounce's t by as much.  Such rays are at most
    MAX_GRAZED of the lanes, each after a hit of JAX's path with incidence
    cosine below GRAZING."""
    bad = np.abs(rt.t - rj.t) > 1e-5 + RTOL * np.abs(rj.t)
    assert bad.sum() <= MAX_GRAZED * bad.size, int(bad.sum())
    prev = np.concatenate([o[None], rj.point[:-1]])
    d = rj.point - prev
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cos = np.abs(np.sum(d * poly_normal[np.maximum(rj.poly_id, 0)], axis=-1))
    for b, i in np.argwhere(bad):
        assert b > 0 and cos[:b, i].min() < GRAZING, (b, i, rt.t[b, i], rj.t[b, i])


@pytest.fixture(scope="module", params=["brute", "grid"])
def scatter_runs(request):
    """One scattering trace of each package on shoebox(4,5,3), the port on
    JAX's draws; the hard histogram and the gradients w.r.t. absorption,
    scattering and vertices of its sum plus the soft histogram's first
    moment (the vertices' gradient comes from the soft bins alone, through
    the hit records and the lobe's directions)."""
    accel = request.param
    o, d = room_rays(7, N_RAYS)
    rng = np.random.default_rng(17)
    absorption = rng.uniform(0.1, 0.5, 12).astype(np.float32)
    scattering = rng.uniform(0.2, 0.8, 12).astype(np.float32)
    w = np.arange(N_BINS, dtype=np.float32) / N_BINS
    key = jax.random.PRNGKey(21)

    jsp = jax_partition(accel)

    def loss(a, s, verts):
        res = jh.trace_rays(jsp.scene.with_vertices(verts), jh.Ray.make(o, d), a, N_BOUNCES,
                            jsp.shoot_fn, aux=jsp.aux, scattering=s, key=key)
        hist = jh.energy_histogram(res, N_BINS, BIN_DT)
        soft = jh.energy_histogram(res, N_BINS, BIN_DT, soft=True)
        return jnp.sum(hist) + jnp.sum(soft * w), (res, hist)

    (_, (res_j, hist_j)), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(absorption), jnp.asarray(scattering), jsp.scene.vertices)
    jax_out = jax.tree.map(np.asarray, (res_j, hist_j) + grads_j)

    sp = port_partition(accel)
    a = torch.tensor(absorption, requires_grad=True)
    s = torch.tensor(scattering, requires_grad=True)
    v = sp.scene.vertices.clone().requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        patch_draws(mp, key, N_BOUNCES, N_RAYS)
        res = th.trace_rays(sp.scene.with_vertices(v), torch_rays(o, d), a, N_BOUNCES,
                            sp.shoot_fn, aux=sp.aux, scattering=s, generator=seeded(0))
    hist = th.energy_histogram(res, N_BINS, BIN_DT)
    soft = th.energy_histogram(res, N_BINS, BIN_DT, soft=True)
    (hist.sum() + (soft * torch.from_numpy(w)).sum()).backward()
    ours = (th.TraceResult(*(x.detach().numpy() for x in res)), hist.detach().numpy(),
            a.grad.numpy(), s.grad.numpy(), v.grad.numpy())
    return jax_out, ours, o, sp


def test_scattering_trace_matches_jax(scatter_runs):
    (rj, *_), (rt, *_), o, sp = scatter_runs
    np.testing.assert_array_equal(rt.hit, rj.hit)
    np.testing.assert_array_equal(rt.poly_id, rj.poly_id)
    assert rj.hit.all()  # closed room
    assert (rj.poly_id >= 0).all()
    np.testing.assert_allclose(rt.energy, rj.energy, rtol=RTOL)
    np.testing.assert_allclose(rt.time, rj.time, rtol=RTOL)
    poly_normal = th.Topology.build(shapes.shoebox(*ROOM)).poly_normal
    assert_t_close(rt, rj, o, poly_normal)


def test_scattering_histogram_and_grads_match_jax(scatter_runs):
    (rj, hj, gaj, gsj, gvj), (rt, ht, gat, gst, gvt), _, _ = scatter_runs
    total = hj.sum()
    np.testing.assert_allclose(ht.sum(), total, rtol=RTOL)
    np.testing.assert_allclose(ht.sum(), rt.energy.sum(), rtol=RTOL)  # conserved
    assert np.abs(ht - hj).sum() <= BIN_FLIP_SHARE * total
    assert (gat < 0).all()
    np.testing.assert_allclose(gat, gaj, rtol=GRAD_RTOL)
    np.testing.assert_allclose(gst, gsj, rtol=GRAD_RTOL)
    assert np.isfinite(gvt).all() and np.abs(gvt).max() > 0
    np.testing.assert_allclose(gvt, gvj, rtol=VERTEX_RTOL,
                               atol=VERTEX_RTOL * float(np.abs(gvt).max()))


# ------------------------------------------- statistics, repeats, descent


def source_trace(s_val, seed, n=4096, bounces=3):
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    o = torch.tensor([SOURCE]).expand(n, 3).contiguous()
    d = th.uniform_sphere(n, seeded(1), device=CPU)
    return th.trace_rays(sc, th.Ray.make(o, d), torch.full((12,), 0.3), bounces, th.shoot_brute,
                         scattering=torch.full((12,), s_val), generator=seeded(seed))


@pytest.mark.parametrize("s_val", [0.0, 0.5, 1.0])
def test_scattering_unbiased(s_val):
    """First-bounce mean energy ~ (1 - a) = 0.7 for any s (the unbiased
    split; per-ray std 0.7 at the extremes, SE ~0.011 at n = 4096)."""
    res = source_trace(s_val, 5)
    assert bool(res.hit.all())
    assert abs(float(res.energy[0].mean()) - 0.7) < 0.05


def test_scattering_deterministic():
    """The same seed gives a bitwise-identical trace; another seed another."""
    r1, r2 = source_trace(0.4, 5), source_trace(0.4, 5)
    for x, y in zip(r1, r2):
        assert torch.equal(x, y)
    assert not torch.equal(source_trace(0.4, 6).energy, r1.energy)


def test_scattering_requires_generator():
    top = th.Topology.build(shapes.shoebox(*ROOM))
    rays = th.Ray.make(torch.tensor([SOURCE]), torch.tensor([[0.0, 0.0, 1.0]]))
    with pytest.raises(ValueError, match="Generator"):
        th.trace_rays(top.scene(device=CPU), rays, torch.zeros(12), 2, th.shoot_brute,
                      scattering=torch.zeros(12))


def test_scatter_draws_layout():
    """Ray-major draws: a sub-batch's draws are the head of the batch's
    from the same seed; the coin is fair."""
    full = bounce.scatter_draws(seeded(2), 3, 4096, torch.float32, CPU)
    head = bounce.scatter_draws(seeded(2), 3, 100, torch.float32, CPU)
    for x, y in zip(full, head):
        assert x.shape[0] == 3 and torch.equal(x[:, :100], y)
    assert full[0].dtype == torch.bool and abs(float(full[0].float().mean()) - 0.5) < 0.02


def test_grad_scattering_fd():
    """d(histogram)/d(scattering) matches finite differences (fixed seed)."""
    rng = np.random.default_rng(1234)
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    a = torch.from_numpy(rng.uniform(0.1, 0.5, 12).astype(np.float32))
    o = rng.uniform((1.0, 1.0, 1.0), (3.0, 4.0, 2.0), (64, 3)).astype(np.float32)
    rays = torch_rays(o, rand_dirs(rng, 64))

    def loss(s):
        res = th.trace_rays(sc, rays, a, 3, th.shoot_brute, scattering=s, generator=seeded(11))
        return th.energy_histogram(res, 256, 1e-3).sum()

    s0 = torch.full((12,), 0.35, requires_grad=True)
    loss(s0).backward()
    g = s0.grad.numpy()
    assert np.isfinite(g).all() and (np.abs(g) > 1e-6).any()
    with torch.no_grad():
        f0 = float(loss(s0))
        for k in np.argsort(-np.abs(g))[:3]:
            s1 = s0.detach().clone()
            s1[k] += 1e-3
            fd = (float(loss(s1)) - f0) / 1e-3
            np.testing.assert_allclose(g[k], fd, rtol=0.05, atol=1e-3)


def test_joint_absorption_scattering_recovery():
    """Recover hidden (absorption, scattering) jointly from a target
    histogram with Adam (lr 0.1, 120 steps), one seed throughout."""
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    n = 256
    o = torch.tensor([SOURCE]).expand(n, 3).contiguous()
    rays = th.Ray.make(o, th.uniform_sphere(n, seeded(2), device=CPU))

    def hist(a, s):
        res = th.trace_rays(sc, rays, a, 4, th.shoot_brute, scattering=s, generator=seeded(9))
        return th.energy_histogram(res, 64, 2e-3)

    with torch.no_grad():
        target = hist(torch.full((12,), 0.35), torch.full((12,), 0.6))
    la = torch.zeros(12, requires_grad=True)
    ls = torch.zeros(12, requires_grad=True)
    opt = torch.optim.Adam([la, ls], lr=0.1)
    for _ in range(120):
        opt.zero_grad()
        loss = torch.mean((hist(torch.sigmoid(la), torch.sigmoid(ls)) - target) ** 2)
        loss.backward()
        opt.step()
    a_fit, s_fit = torch.sigmoid(la).detach().numpy(), torch.sigmoid(ls).detach().numpy()
    assert np.abs(a_fit - 0.35).mean() < 0.05, a_fit
    assert np.abs(s_fit - 0.6).mean() < 0.15, s_fit


# ------------------------------------------------------------------ remat


def remat_run(remat, scattering, calls=None, grad=True):
    """8 bounces of 32 rays through brute: the trace, the histogram and the
    gradients w.r.t. absorption (and scattering), ``calls`` counting the
    shoots."""
    rng = np.random.default_rng(1234)
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    a = torch.from_numpy(rng.uniform(0.1, 0.5, 12).astype(np.float32)).requires_grad_(grad)
    s = torch.full((12,), 0.45, requires_grad=grad) if scattering else None
    o = rng.uniform((1.0, 1.0, 1.0), (3.0, 4.0, 2.0), (32, 3)).astype(np.float32)
    rays = torch_rays(o, rand_dirs(rng, 32))

    def shoot(scene, r):
        if calls is not None:
            calls.append(1)
        return th.shoot_brute(scene, r)

    with torch.set_grad_enabled(grad):
        res = th.trace_rays(sc, rays, a, 8, shoot, scattering=s,
                            generator=seeded(3) if scattering else None, remat=remat)
        h = th.energy_histogram(res, 256, 1e-3)
        if grad:
            h.sum().backward()
    grads = [] if not grad else [a.grad] + ([s.grad] if scattering else [])
    return [x.detach() for x in res] + [h.detach()] + grads


@pytest.mark.parametrize("scattering", [False, True], ids=["specular", "scattering"])
def test_remat_matches_plain(scattering):
    """Per-bounce checkpointing: values and gradients to the bit, the
    scattering draws included (they are inputs of each bounce, so the
    recompute sees the forward's numbers)."""
    plain, calls = remat_run(False, scattering), []
    remat = remat_run(True, scattering, calls)
    assert len(plain) == len(remat) == (9 if scattering else 8)
    for x, y in zip(plain, remat):
        assert x.dtype == y.dtype and torch.equal(x, y)
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert len(calls) == 2 * 8  # each bounce's shoot runs again in the backward


def test_remat_without_grad_changes_nothing():
    calls = []
    plain = remat_run(False, True, grad=False)
    remat = remat_run(True, True, calls, grad=False)
    assert len(calls) == 8
    for x, y in zip(plain, remat):
        assert torch.equal(x, y)


# ----------------------------------------- the specular step, unchanged


def glue_trace(scene, rays, absorption, n_bounces, shoot_fn, aux):
    """The bounce loop as the port traced it before ``bounce_step`` was
    factored out: its torch glue, verbatim."""
    o = rays.origin
    n = o.shape[0]
    direction = normalize(rays.direction)
    origin, exclude = o, rays.exclude_poly
    energy = torch.ones(n, dtype=o.dtype, device=o.device)
    dist = torch.zeros(n, dtype=o.dtype, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    outs = []
    for _ in range(n_bounces):
        r = th.Ray(origin, direction, exclude)
        hr = shoot_fn(scene, r, aux)
        live_hit = hr.hit & alive
        n_hat = normalize(hr.normal)
        pid = torch.clamp(hr.poly_id, min=0)
        a = th.accel.scatter.gather_rows(absorption, pid)
        new_energy = torch.where(live_hit, energy * (1.0 - a), energy)
        dist = dist + torch.where(live_hit, hr.t, 0.0)
        outs.append((
            live_hit,
            torch.where(live_hit, new_energy, 0.0),
            dist / bounce.SOUND_SPEED,
            torch.where(live_hit, hr.poly_id, NO_POLY),
            hr.point,
            torch.where(live_hit, hr.t, float("inf")),
        ))
        nbr = hr.edge_nbr
        w_b = 1.0 - hr.u - hr.v
        b0, b1, b2 = hr.v, w_b, hr.u
        n01 = torch.where(b0 <= b1, nbr[:, 0], nbr[:, 1])
        d01 = torch.minimum(b0, b1)
        nb = torch.where(d01 <= b2, n01, nbr[:, 2])
        on_edge = torch.minimum(d01, b2) < bounce.EDGE_EPS
        ex2 = torch.where(live_hit & on_edge & (nb >= 0), nb, NO_POLY)
        exclude = torch.stack([torch.where(live_hit, hr.poly_id, NO_POLY), ex2], dim=-1)
        origin = torch.where(live_hit[:, None], hr.point, origin)
        direction = torch.where(live_hit[:, None], bounce.reflect(direction, n_hat), direction)
        energy, alive = new_energy, live_hit
    return th.TraceResult(*(torch.stack(x) for x in zip(*outs)))


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_bounce_step_specular_is_the_glue(accel):
    """tests/test_torch_trace.py's slice (shoebox(4,5,3), 512 rays, 4
    bounces, its seed) through trace_rays and through the glue it replaced:
    every output, the hard histogram's absorption gradient and the soft
    histogram's vertex gradient, to the bit."""
    rng = np.random.default_rng(7)
    o = rng.uniform((0.3, 0.3, 0.3), (3.7, 4.7, 2.7), (N_RAYS, 3)).astype(np.float32)
    d = rand_dirs(rng, N_RAYS)
    absorption = torch.from_numpy(rng.uniform(0.1, 0.5, 12).astype(np.float32))
    sp = port_partition(accel)
    out = []
    for trace in (th.trace_rays, glue_trace):
        a = absorption.clone().requires_grad_()
        v = sp.scene.vertices.clone().requires_grad_()
        res = trace(sp.scene.with_vertices(v), torch_rays(o, d), a, N_BOUNCES, sp.shoot_fn,
                    aux=sp.aux)
        h = th.energy_histogram(res, N_BINS, BIN_DT)
        hs = th.energy_histogram(res, N_BINS, BIN_DT, soft=True)
        (h.sum() + (hs * torch.arange(N_BINS)).sum()).backward()
        out.append([x.detach() for x in res] + [h.detach(), a.grad, v.grad])
    for x, y in zip(*out):
        assert torch.equal(x, y)
        if x.is_floating_point():
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_trace_without_edge_nbr():
    """A shoot_fn whose record has no edge_nbr: the neighbours come from the
    scene's tri_meta by tri_id, as JAX reads them by tri_id.  Brute on the
    room, random rays and rays aimed at the floor's shared diagonal (the
    second exclusion's case): the port's trace with the field to the bit,
    and JAX's trace."""
    rng = np.random.default_rng(19)
    top = th.Topology.build(shapes.shoebox(*ROOM))
    sc = top.scene(device=CPU)
    v = sc.vertices.numpy()
    tv = sc.tri_v.numpy()[: top.n_tris]
    floor = [t for t in range(top.n_tris) if np.allclose(v[tv[t]][:, 2], 0.0)]
    shared = np.intersect1d(tv[floor[0]], tv[floor[1]])
    lam = rng.uniform(0.1, 0.9, 32).astype(np.float32)
    targets = v[shared[0]] + lam[:, None] * (v[shared[1]] - v[shared[0]])
    o_edge = np.tile(np.array([[2.0, 2.5, 2.0]], np.float32), (32, 1))
    o_edge[:, 0] += rng.uniform(-1, 1, 32).astype(np.float32)
    d_edge = targets - o_edge
    o_rand, d_rand = room_rays(19, 96)
    o = np.concatenate([o_edge, o_rand]).astype(np.float32)
    d = np.concatenate([d_edge / np.linalg.norm(d_edge, axis=1, keepdims=True),
                        d_rand]).astype(np.float32)
    absorption = rng.uniform(0.1, 0.5, 12).astype(np.float32)

    def dropped(scene, r):
        return th.shoot_brute(scene, r)._replace(edge_nbr=None)

    a = torch.from_numpy(absorption)
    runs = [th.trace_rays(sc, torch_rays(o, d), a, 3, fn) for fn in (dropped, th.shoot_brute)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    res = runs[0]
    assert (res.poly_id[0, :32] >= 0).all() and bool(res.hit.all())
    jsc = jh.Topology.build(jshapes.shoebox(*ROOM)).scene()
    rj = jax.tree.map(np.asarray, jh.trace_rays(jsc, jh.Ray.make(o, d), jnp.asarray(absorption),
                                                3, jax_shoot_brute))
    np.testing.assert_array_equal(res.hit.numpy(), rj.hit)
    np.testing.assert_array_equal(res.poly_id.numpy(), rj.poly_id)
    np.testing.assert_allclose(res.energy.numpy(), rj.energy, rtol=RTOL)
    np.testing.assert_allclose(res.time.numpy(), rj.time, rtol=RTOL)
    np.testing.assert_allclose(res.t.numpy(), rj.t, rtol=RTOL, atol=1e-5)


# --------------------------------------------------------------- samplers


def test_tri_vertices_match_jax():
    """Scene.tri_vertices: the same corners as JAX's to the bit, and its
    gradient through gather_rows the same sums."""
    faces = shapes.shoebox(*ROOM) + shapes.icosphere(1, radius=0.5, center=SOURCE)
    sc = th.Topology.build(faces).scene(device=CPU)
    jsc = jh.Topology.build(faces).scene()
    got = [x.numpy() for x in sc.tri_vertices()]
    want = [np.asarray(x) for x in jsc.tri_vertices()]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    w = np.random.default_rng(2).normal(0, 1, (3,) + want[0].shape).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda vt: sum(jnp.sum(c * wk) for c, wk in zip(
        jsc._replace(vertices=vt).tri_vertices(), w)))(jsc.vertices))
    vt = sc.vertices.clone().requires_grad_()
    sum((c * torch.from_numpy(wk)).sum() for c, wk in zip(
        sc._replace(vertices=vt).tri_vertices(), w)).backward()
    np.testing.assert_allclose(vt.grad.numpy(), g_j, rtol=1e-6, atol=1e-6)


def test_triangle_points_match_jax():
    """The sqrt warp on JAX's uniforms gives JAX's points."""
    rng = np.random.default_rng(6)
    v0, v1, v2 = rng.uniform(-3, 3, (3, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_triangle_points(key, *(jnp.asarray(x) for x in (v0, v1, v2)), 1000))
    k1, k2 = jax.random.split(key)
    r1, r2 = (torch.from_numpy(np.array(jax.random.uniform(k, (1000,)))) for k in (k1, k2))
    got = warp_triangle(*(torch.from_numpy(x) for x in (v0, v1, v2)), r1, r2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The port's own draws: inside the triangle (barycentric weights >= 0).
    pts = th.triangle_points(*(torch.from_numpy(x) for x in (v0, v1, v2)), 1000, seeded(1),
                             device=CPU).double().numpy()
    m = np.stack([v1 - v0, v2 - v0], axis=1).astype(np.float64)
    uv = np.linalg.lstsq(m, (pts - v0).T, rcond=None)[0]
    assert (uv >= -1e-5).all() and (uv.sum(0) <= 1 + 1e-5).all()


def test_polygon_points_quad_parity():
    """Quadrilateral.GetRandomPoint: points on the floor quad's plane inside
    its bounds, about a quarter in each quadrant; the triangle path too."""
    top = th.Topology.build(shapes.shoebox_quads(*ROOM))
    pts = th.polygon_points(top, 0, 4000, seeded(2), device=CPU).numpy()
    corners = top.vertices[top.poly_verts[0]]
    assert abs(corners[:, 2]).max() < 1e-12  # the floor
    assert pts.shape == (4000, 3) and np.abs(pts[:, 2]).max() < 1e-5
    assert (pts[:, 0] >= -1e-5).all() and (pts[:, 0] <= 4 + 1e-5).all()
    assert (pts[:, 1] >= -1e-5).all() and (pts[:, 1] <= 5 + 1e-5).all()
    qx, qy = pts[:, 0] > 2.0, pts[:, 1] > 2.5
    for m in (qx & qy, qx & ~qy, ~qx & qy, ~qx & ~qy):
        assert 0.2 < m.mean() < 0.3
    top3 = th.Topology.build(shapes.shoebox(*ROOM))
    pts3 = th.polygon_points(top3, 0, 500, seeded(3), device=CPU)
    assert pts3.shape == (500, 3) and bool(torch.isfinite(pts3).all())
    assert torch.equal(pts3, th.polygon_points(top3, 0, 500, seeded(3), device=CPU))


def test_scene_surface_points():
    """Area-weighted points on the room's walls: each on a wall inside its
    bounds, each wall's share of points within 3 standard errors of its
    share of the area, and one seed the same points."""
    n = 20000
    sc = th.Topology.build(shapes.shoebox(*ROOM)).scene(device=CPU)
    pts = th.scene_surface_points(sc, n, seeded(4), device=CPU)
    assert torch.equal(pts, th.scene_surface_points(sc, n, seeded(4), device=CPU))
    p = pts.numpy()
    size = np.array(ROOM, np.float32)
    assert ((p >= -1e-5) & (p <= size + 1e-5)).all()
    on = (np.abs(p) < 1e-5) | (np.abs(p - size) < 1e-5)  # (n, 3): on a wall of that axis
    assert on.any(axis=1).all()
    total = 2 * (size[0] * size[1] + size[1] * size[2] + size[0] * size[2])
    for axis in range(3):
        area = np.prod(np.delete(size, axis)) / total  # one wall of this axis
        for at in (0.0, size[axis]):
            share = float((np.abs(p[:, axis] - at) < 1e-5).mean())
            se = np.sqrt(area * (1 - area) / n)
            assert abs(share - area) < 3 * se, (axis, at, share, area)
