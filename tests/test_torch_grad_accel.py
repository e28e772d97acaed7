"""Port parity: absorption gradients through the tree and rope backends.

Mirrors ``tests/test_grad_accel.py::test_absorption_grads_match_brute`` on
the port: ``trace_rays`` + ``energy_histogram`` + ``backward()`` through the
port's facade against ``jax.grad`` through the JAX facade, and against the
port's brute force.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# Absorption gradients: per-polygon sums of per-ray energy products, in
# another order (tests/test_torch_trace.py).
GRAD_RTOL = 1e-4


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("accel", ["octree", "kdtree", "kdtree_ropes"])
def test_absorption_grads_match_jax(accel):
    """test_absorption_grads_match_brute: the port's trace + histogram +
    backward against JAX's gradient through the same backend, and against
    the port's brute force."""
    n, bounces = 64, 3
    rng = np.random.default_rng(11)
    o = np.tile(np.array([[2.0, 2.5, 1.5]], np.float32), (n, 1))
    d = rand_dirs(rng, n)
    a0 = np.full(12, 0.3, np.float32)

    jt = jh.Topology.build(jshapes.shoebox(4, 5, 3))
    jsp = jh.SpatialPartition(jt, accel=accel)

    def jloss(a):
        res = jh.trace_rays(jsp.scene, jh.Ray.make(o, d), a, bounces, jsp.shoot_fn, aux=jsp.aux)
        return jnp.sum(jh.energy_histogram(res, 64, 1e-3))

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(a0)))

    tt = th.Topology.build(shapes.shoebox(4, 5, 3))
    grads = {}
    for which in (accel, "brute"):
        sp = th.SpatialPartition(tt, accel=which)
        a = torch.tensor(a0, requires_grad=True)
        res = th.trace_rays(sp.scene, th.Ray.make(torch.from_numpy(o), torch.from_numpy(d)),
                            a, bounces, sp.shoot_fn, aux=sp.aux)
        th.energy_histogram(res, 64, 1e-3).sum().backward()
        assert res.hit.all()
        grads[which] = a.grad.numpy()
    assert (grads[accel] < 0).all()
    np.testing.assert_allclose(grads[accel], g_j, rtol=GRAD_RTOL)
    np.testing.assert_allclose(grads[accel], grads["brute"], rtol=GRAD_RTOL)
