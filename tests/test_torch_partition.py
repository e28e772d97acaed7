"""Port parity: the ``SpatialPartition`` facade over all five backends.

Mirrors ``tests/test_partition.py`` on the port: each backend through the
port's facade against the same backend through the JAX facade (the JAX tree
and rope shoots, on bit-equal tables), ``char_step`` equal to JAX's, and
tracing through ``shoot_fn``.  The absorption gradients through each
backend are in ``tests/test_torch_grad_accel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.partition import ACCELS  # noqa: E402
from hare_tpu_torch.mesh import shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# Same hit re-solved in f32 by two compilers: a few ulps.
RTOL = ATOL = 1e-5
# The concert hall's coincident overlapping polygons (stage and floor) make
# equal-t ties common; XLA rounds them one ulp apart (test_torch_brute.py).
HALL_TIE_SHARE = 0.02


def rand_dirs(rng, n):
    d = rng.normal(0, 1, (n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def halls():
    return jh.Topology.build(jshapes.concert_hall()), th.Topology.build(shapes.concert_hall())


@pytest.mark.parametrize("accel", ACCELS)
def test_partition_backends_agree(halls, rng, accel):
    """Each backend through both facades on the concert hall: the same hits,
    t within ulps, tri_id equal except at equal-t ties; char_step equal."""
    jt, tt = halls
    jsp, tsp = jh.SpatialPartition(jt, accel=accel), th.SpatialPartition(tt, accel=accel, device=CPU)
    assert tsp.char_step == jsp.char_step > 0
    o = rng.uniform((2, 2, 1), (28, 48, 16), (64, 3)).astype(np.float32)
    d = rand_dirs(rng, 64)
    hj = jax.tree.map(np.asarray, jsp.shoot(jh.Ray.make(o, d)))
    ht = tsp.shoot(th.Ray.make(torch.from_numpy(o), torch.from_numpy(d)))
    h = hj.hit
    np.testing.assert_array_equal(ht.hit.numpy(), h)
    np.testing.assert_allclose(ht.t.numpy()[h], hj.t[h], rtol=RTOL, atol=ATOL)
    flips = h & (ht.tri_id.numpy() != hj.tri_id)
    assert flips.sum() <= HALL_TIE_SHARE * len(h)


@pytest.mark.parametrize("accel", ACCELS)
def test_partition_trace_integration(rng, accel):
    """trace_rays through shoot_fn in a closed room: every ray hits on every
    bounce, energy 0.75^3 after three; shoot_fn is memoized."""
    top = th.Topology.build(shapes.shoebox(4, 5, 3))
    sp = th.SpatialPartition(top, accel=accel, device=CPU, **({"domain": 4} if accel == "grid" else {}))
    assert sp.shoot_fn is sp.shoot_fn
    a = torch.full((top.n_polys,), 0.25)
    o = torch.tensor([[2.0, 2.5, 1.5]]).repeat(32, 1)
    d = torch.from_numpy(rand_dirs(rng, 32))
    res = th.trace_rays(sp.scene, th.Ray.make(o, d), a, 3, sp.shoot_fn, aux=sp.aux)
    assert res.hit.all()
    np.testing.assert_allclose(res.energy[-1].numpy(), 0.75 ** 3, rtol=1e-5)
