"""The port's ray-parallel path (``hare_tpu_torch.dist``) over gloo, on the CPU.

Mirrors ``tests/test_dist.py`` (the JAX package on its 8-device CPU mesh)
and ``tests/test_multiprocess.py`` (two processes): two ranks, spawned as
processes that meet through a file in the test's own directory (so
parallel test workers never share a port), each trace their half of the
rays and write what they computed; the parent holds it against the
single-process port and against the JAX package's ``sharded_histogram``
and ``make_train_step``.  The NCCL path runs on the card at one rank a
device (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 10).
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.dist import make_ray_mesh  # noqa: E402
from hare_tpu.dist import make_train_step as jax_train_step  # noqa: E402
from hare_tpu.dist import sharded_histogram as jax_sharded  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch import dist as hd  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ACCELS = ("grid", "octree", "kdtree")
WORLD = 2
N_RAYS, N_BOUNCES, N_BINS = 256, 3, 256
# Sharded against single-process: the same lanes, the histogram's sums cut
# at the rank boundary (tests/test_dist.py's tolerances).
HIST_TOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-4, 1e-5
# The port against the JAX package: tests/test_torch_trace.py's (energies
# the same f32 products; a time at a bin edge may bin apart; gradients sum
# many lanes in another order).
RTOL, BIN_FLIP_SHARE, JAX_GRAD_RTOL = 1e-5, 1e-4, 1e-4
# One Adam step (lr 0.1) from the same parameters: torch's Adam and optax's
# form m / (sqrt(v) + eps) in other orders, and the gradients agree within
# JAX_GRAD_RTOL; the first step moves each parameter by about lr.
STEP_ATOL, LOSS_RTOL = 1e-5, 1e-4
LR, STEPS = 0.1, 20
SETUP = r'''
import numpy as np
import torch
import hare_tpu_torch as th
from hare_tpu_torch.mesh import shapes


def rays_np(n, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.tile(np.array([[2.0, 2.5, 1.5]], np.float32), (n, 1)), d


def absorption_np(n_polys):
    return np.random.default_rng(0).uniform(0.1, 0.5, n_polys).astype(np.float32)


def port_setup(accel, n):
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    kw = {"domain": 4} if accel == "grid" else {}
    sp = th.SpatialPartition(top, accel=accel, device="cpu", **kw)
    o, d = rays_np(n)
    rays = th.Ray.make(torch.from_numpy(o), torch.from_numpy(d))
    return top, sp, torch.from_numpy(absorption_np(top.n_polys)), rays
'''
WORKER = SETUP + r'''
import sys
from hare_tpu_torch import dist as hd

init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
hd.init_distributed("cpu", init_method="file://" + init, world_size=2, rank=rank)
res = {}
for accel in ("grid", "octree", "kdtree"):
    top, sp, a, rays = port_setup(accel, 256)
    fn = hd.sharded_histogram(sp.shoot_fn, 3, 256)
    a = a.clone().requires_grad_()
    h = fn(sp.scene, rays, a, sp.aux)
    (h ** 2).sum().backward()
    res[accel] = (h.detach(), a.grad)

# Absorption: one Adam step (held against JAX), then descent.
top, sp, a_true, rays = port_setup("grid", 512)
with torch.no_grad():
    target = hd.sharded_histogram(sp.shoot_fn, 3, 128)(sp.scene, rays, a_true)
params = {"absorption": torch.zeros(top.n_polys, requires_grad=True)}
opt = torch.optim.Adam(params.values(), lr=0.1)
step = hd.make_train_step(sp.shoot_fn, opt, 3, 128)
losses = [float(step(params, sp.scene, rays, target))]
res["adam_one_step"] = (losses[0], params["absorption"].detach().clone())
losses += [float(step(params, sp.scene, rays, target)) for _ in range(19)]
res["absorption_losses"] = losses

# Vertices (soft bins), as tests/test_dist.py:87.
top, sp, _, rays = port_setup("grid", 256)
v_build = sp.scene.vertices
a_raw = torch.full((top.n_polys,), 0.3)
with torch.no_grad():
    target = hd.sharded_histogram(sp.shoot_fn, 2, 64, bin_dt=2e-3, soft=True)(
        sp.scene.with_vertices(v_build * 1.03), rays, a_raw)
params = {"absorption": torch.full((top.n_polys,), float(np.log(0.3 / 0.7))),
          "vertices": v_build.clone().requires_grad_()}
opt = torch.optim.Adam([params["vertices"]], lr=2e-2)
step = hd.make_train_step(sp.shoot_fn, opt, 2, 64, bin_dt=2e-3, fit_vertices=True)
res["vertex_losses"] = [float(step(params, sp.scene, rays, target)) for _ in range(30)]
res["vertex_moved"] = float((params["vertices"] - v_build).abs().max())

# Scattering, as tests/test_dist.py:128: the whole batch's draws of one
# seed, each rank its rays' columns.
top, sp, a_true, rays = port_setup("grid", 512)
s_true = torch.full((top.n_polys,), 0.6)
fn = hd.sharded_histogram(sp.shoot_fn, 3, 128, use_scattering=True)
gen = lambda: torch.Generator().manual_seed(3)
with torch.no_grad():
    target = fn(sp.scene, rays, a_true, None, s_true, gen())
    again = fn(sp.scene, rays, a_true, None, s_true, gen())
res["scattering_hist"] = (target, again)
params = {"absorption": torch.zeros(top.n_polys, requires_grad=True),
          "scattering": torch.zeros(top.n_polys, requires_grad=True)}
opt = torch.optim.Adam(params.values(), lr=0.1)
step = hd.make_train_step(sp.shoot_fn, opt, 3, 128, use_scattering=True)
res["scattering_losses"] = [float(step(params, sp.scene, rays, target, None, gen()))
                            for _ in range(15)]
res["scattering_params"] = params["scattering"].detach()

try:
    hd.sharded_histogram(sp.shoot_fn, 3, 128)(sp.scene, th.Ray(*(x[:255] for x in rays)), a_true)
    res["uneven"] = None
except ValueError as e:
    res["uneven"] = str(e)
torch.save(res, out)
torch.distributed.destroy_process_group()
'''

setup = {}
exec(SETUP, setup)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results, ``[rank 0's, rank 1's]``."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(tmp / "init"), str(r),
                               str(outs[r])], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo rank timed out")
        assert p.returncode == 0, err[-3000:]
    return [torch.load(o) for o in outs]


@functools.lru_cache(maxsize=None)
def single(accel):
    """The single-process port: histogram and gradient of sum(h^2)."""
    _, sp, a, rays = setup["port_setup"](accel, N_RAYS)
    a = a.clone().requires_grad_()
    h = th.energy_histogram(th.trace_rays(sp.scene, rays, a, N_BOUNCES, sp.shoot_fn,
                                          aux=sp.aux), N_BINS)
    (h ** 2).sum().backward()
    return h.detach().numpy(), a.grad.numpy()


def jax_setup(accel, n):
    top = jh.Topology.build(jshapes.shoebox(4, 5, 3))
    kw = {"domain": 4} if accel == "grid" else {}
    sp = jh.SpatialPartition(top, accel=accel, **kw)
    o, d = setup["rays_np"](n)
    return top, sp, jnp.asarray(setup["absorption_np"](top.n_polys)), jh.Ray.make(o, d)


@functools.lru_cache(maxsize=None)
def jax_sharded_runs(accel):
    """The JAX package's sharded histogram on its 8-device mesh and the
    gradient of sum(h^2) w.r.t. absorption."""
    _, jsp, a, rays = jax_setup(accel, N_RAYS)
    fn = jax_sharded(make_ray_mesh(8), jsp.shoot_fn, N_BOUNCES, N_BINS)

    def loss(a_):
        h = fn(jsp.scene, rays, a_, jsp.aux)
        return jnp.sum(h ** 2), h

    (_, h), g = jax.value_and_grad(loss, has_aux=True)(a)
    return np.asarray(h), np.asarray(g)


def test_backend_follows_the_device():
    assert hd.backend_for("cuda") == hd.backend_for("cuda:1") == "nccl"
    assert hd.backend_for("cpu") == hd.backend_for(torch.device("cpu")) == "gloo"
    with pytest.raises(ValueError, match="meta"):
        hd.backend_for("meta")


def test_ranks_agree(ranks):
    """Both ranks hold the same histograms, gradients, losses and
    parameters, to the bit."""
    a, b = ranks
    for accel in ACCELS:
        for x, y in zip(a[accel], b[accel]):
            assert torch.equal(x, y)
    for key in ("absorption_losses", "vertex_losses", "scattering_losses"):
        assert a[key] == b[key]
    assert torch.equal(a["scattering_params"], b["scattering_params"])


@pytest.mark.parametrize("accel", ACCELS)
def test_sharded_histogram_matches(ranks, accel):
    """Two ranks' histogram against the single-process port's and the JAX
    package's sharded histogram on its 8-device mesh."""
    h2 = ranks[0][accel][0].numpy()
    h1, _ = single(accel)
    np.testing.assert_allclose(h2, h1, rtol=HIST_TOL, atol=HIST_TOL)
    hj, _ = jax_sharded_runs(accel)
    np.testing.assert_allclose(h2.sum(), hj.sum(), rtol=RTOL)
    assert np.abs(h2 - hj).sum() <= BIN_FLIP_SHARE * hj.sum()


@pytest.mark.parametrize("accel", ACCELS)
def test_sharded_grad_matches(ranks, accel):
    """The gradient of sum(h^2) w.r.t. absorption on two ranks (every
    rank's the sum over ranks) against the single-process port's and JAX's
    sharded gradient: not multiplied by the world size."""
    g2 = ranks[0][accel][1].numpy()
    _, g1 = single(accel)
    np.testing.assert_allclose(g2, g1, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    _, gj = jax_sharded_runs(accel)
    np.testing.assert_allclose(g2, gj, rtol=JAX_GRAD_RTOL, atol=JAX_GRAD_RTOL * np.abs(gj).max())


def test_adam_step_matches_jax(ranks):
    """One step of make_train_step (Adam, lr 0.1) from sigmoid(0) = 0.5
    against the JAX package's with optax.adam on the same parameters and
    target: the loss and the updated parameters."""
    loss, params = ranks[0]["adam_one_step"]
    top, jsp, a_true, rays = jax_setup("grid", 512)
    mesh = make_ray_mesh(8)
    target = jax_sharded(mesh, jsp.shoot_fn, N_BOUNCES, 128)(jsp.scene, rays, a_true)
    opt = optax.adam(LR)
    step = jax_train_step(mesh, jsp.shoot_fn, opt, N_BOUNCES, 128)
    p = {"absorption": jnp.zeros(top.n_polys)}
    p, _, jloss = step(p, opt.init(p), jsp.scene, rays, target)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(params.numpy(), np.asarray(p["absorption"]), rtol=0,
                               atol=STEP_ATOL)
    assert np.abs(params.numpy()).min() > 0.5 * LR  # every parameter moved


def test_train_step_descends(ranks):
    losses = ranks[0]["absorption_losses"]
    assert len(losses) == STEPS and losses[-1] < 0.1 * losses[0], losses


def test_vertex_train_step_descends(ranks):
    """fit_vertices (soft bins by default): the loss falls and the vertices
    move, as tests/test_dist.py:87 asks of the JAX package."""
    losses = ranks[0]["vertex_losses"]
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert ranks[0]["vertex_moved"] > 1e-3


def test_scattering_train_step_descends(ranks):
    losses = ranks[0]["scattering_losses"]
    assert losses[-1] < 0.2 * losses[0], losses
    assert bool(torch.isfinite(ranks[0]["scattering_params"]).all())


def test_sharded_scattering_is_the_single_trace(ranks):
    """With one seed each rank traces its rays' columns of the whole
    batch's draws: the two ranks' histogram is the single-process trace's
    of that seed up to the sum order, and repeats to the bit."""
    target, again = ranks[0]["scattering_hist"]
    assert torch.equal(target, again)
    _, sp, a, rays = setup["port_setup"]("grid", 512)
    with torch.no_grad():
        res = th.trace_rays(sp.scene, rays, a, N_BOUNCES, sp.shoot_fn, aux=sp.aux,
                            scattering=torch.full((12,), 0.6),
                            generator=torch.Generator().manual_seed(3))
        h1 = th.energy_histogram(res, 128)
    np.testing.assert_allclose(target.numpy(), h1.numpy(), rtol=HIST_TOL, atol=HIST_TOL)


def test_uneven_split_raises(ranks):
    assert ranks[0]["uneven"] is not None and "255 rays" in ranks[0]["uneven"]
