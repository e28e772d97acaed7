"""Port parity: the soft (tent) histogram and the fixed-order scatter.

Mirrors ``tests/test_trace.py::test_soft_histogram_conserves_and_differentiates``
on the port's plain versions, and holds them and the scatter-add of the
gradients against the JAX package on the same NumPy inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.scatter import SEGMENT, gather_rows, scatter_add_ordered  # noqa: E402
from hare_tpu_torch.trace.bounce import soft_histogram_bwd_plain  # noqa: E402

# Bin sums and their gradients: the same f32 products, summed in another
# order.
RTOL = 1e-5
SCATTER_RTOL = 1e-6


def traces(hit, energy, time):
    """The same trace record for both packages (only hit, energy and time
    are read)."""
    z = np.zeros(hit.shape, np.float32)
    pt = np.zeros(hit.shape + (3,), np.float32)
    jres = jh.TraceResult(jnp.asarray(hit), jnp.asarray(energy), jnp.asarray(time),
                          jnp.asarray(z.astype(np.int32)), jnp.asarray(pt), jnp.asarray(z))
    return jres, (torch.from_numpy(hit), torch.from_numpy(energy), torch.from_numpy(time))


def port_soft(hit, energy, time, n_bins, bin_dt, weight):
    """The port's soft histogram and d(sum(h * weight))/d(energy, time)."""
    e = energy.clone().requires_grad_()
    t = time.clone().requires_grad_()
    res = th.TraceResult(hit, e, t, None, None, None)
    h = th.energy_histogram(res, n_bins, bin_dt, soft=True)
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), e.grad.numpy(), t.grad.numpy()


def jax_soft(jres, n_bins, bin_dt, weight, soft=True):
    def f(e, t):
        h = jh.energy_histogram(jres._replace(energy=e, time=t), n_bins, bin_dt, soft=soft)
        return jnp.sum(h * weight), h

    (_, h), (ge, gt) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jres.energy, jres.time)
    return np.asarray(h), np.asarray(ge), np.asarray(gt)


def centre_time(k, bin_dt):
    """An f32 time whose f32 ``time / bin_dt`` is exactly ``k + 0.5``: bin
    k's centre, where the tent's clip sits on its lower bound."""
    dt = np.float32(bin_dt)
    t = np.float32((k + 0.5) * bin_dt)
    for _ in range(64):
        q = t / dt
        if q == np.float32(k + 0.5):
            return t
        t = np.nextafter(t, np.float32(np.inf) if q < k + 0.5 else np.float32(-np.inf))
    raise AssertionError("no f32 time at the bin centre")


def test_soft_histogram_matches_jax():
    """test_soft_histogram_conserves_and_differentiates on the port: totals
    conserved (the clamped overflow included), the 0.2 / 0.3 split, the dead
    lane dropped, d(moment)/dt = energy / bin_dt; a time exactly at a bin
    centre takes JAX's clip gradient (1/2); and a random 3 x 512 trace's bins
    and d/d(energy), d/d(time) equal JAX's."""
    c = centre_time(3, 1e-3)
    hit = np.array([[True, True, True, False, True]])
    energy = np.array([[0.5, 0.25, 1.0, 7.0, 0.75]], np.float32)
    #              bin0/1 split  bin12/13  clamped into the last bin  dead  centre of bin 3
    time = np.array([[0.0011, 0.0129, 99.0, 1.0, c]], np.float32)
    jres, (h_t, e_t, t_t) = traces(hit, energy, time)
    moment = np.arange(16, dtype=np.float32)
    hs, ge, gt = port_soft(h_t, e_t, t_t, 16, 1e-3, moment)
    hh = th.energy_histogram(th.TraceResult(h_t, e_t, t_t, None, None, None), 16, 1e-3).numpy()
    np.testing.assert_allclose(hh.sum(), 2.5, rtol=1e-6)
    np.testing.assert_allclose(hs.sum(), 2.5, rtol=1e-6)
    # t = 1.1 ms, centres at 0.5 / 1.5 ms: frac 0.6, bin 0 gets 0.2, bin 1 0.3.
    np.testing.assert_allclose(hs[0], 0.2, rtol=1e-5)
    np.testing.assert_allclose(hs[1], 0.3, rtol=1e-5)
    np.testing.assert_allclose(hs[15], 1.0, rtol=1e-6)
    np.testing.assert_allclose(hs[3], 0.75, rtol=1e-6)
    # d(moment)/dt of the split ray = energy / bin_dt = 500; at the bin
    # centre, half of 0.75 / bin_dt (JAX's clip; torch.clamp would give all).
    np.testing.assert_allclose(gt[0, 0], 0.5 / 1e-3, rtol=1e-4)
    np.testing.assert_allclose(gt[0, 4], 0.5 * 0.75 / 1e-3, rtol=1e-4)
    assert gt[0, 3] == 0.0 and ge[0, 3] == 0.0  # the dead lane
    # The clamped overflow: frac clipped at 1, so no time gradient.
    assert gt[0, 2] == 0.0
    jh_s, jge, jgt = jax_soft(jres, 16, 1e-3, moment)
    _, _, jgt_hard = jax_soft(jres, 16, 1e-3, moment, soft=False)
    np.testing.assert_array_equal(jgt_hard, 0.0)
    for got, want in ((hs, jh_s), (ge, jge), (gt, jgt)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))

    rng = np.random.default_rng(17)
    shape, n_bins = (3, 512), 64
    hit = rng.uniform(size=shape) < 0.9
    energy = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    time = rng.uniform(-0.005, 0.07, shape).astype(np.float32)
    weight = rng.normal(size=n_bins).astype(np.float32)
    jres, (h_t, e_t, t_t) = traces(hit, energy, time)
    got = port_soft(h_t, e_t, t_t, n_bins, 1e-3, weight)
    want = jax_soft(jres, n_bins, 1e-3, weight)
    for what, g, w in zip(("bins", "d/d(energy)", "d/d(time)"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=what)
    # The backward's plain version is what the Function returns on the CPU.
    de, dt = soft_histogram_bwd_plain(e_t, t_t, h_t, torch.from_numpy(weight), n_bins, 1e-3)
    assert np.array_equal(de.numpy(), got[1]) and np.array_equal(dt.numpy(), got[2])


@pytest.mark.parametrize("cols", [1, 3])
def test_scatter_add_ordered_plain(cols):
    """The fixed-order scatter's plain version against JAX's segment_sum on
    random keys with repeats and unused keys; to the bit, each key's values
    in a segment of SEGMENT sorted positions added in increasing index order
    (a float32 left fold from zero), then the segments' sums in order; and
    the gather whose gradient it is."""
    rng = np.random.default_rng(5)
    m, n_keys = 3000, 40
    keys = rng.choice(np.arange(0, n_keys, 2), m).astype(np.int32)  # odd keys unused
    shape = (m,) if cols == 1 else (m, cols)
    values = (rng.normal(size=shape) * rng.uniform(0, 1e3, (m,) + (1,) * (cols > 1))).astype(
        np.float32)
    got = scatter_add_ordered(torch.from_numpy(keys), torch.from_numpy(values), n_keys).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(keys),
                                          num_segments=n_keys))
    np.testing.assert_allclose(got, want, rtol=SCATTER_RTOL,
                               atol=SCATTER_RTOL * float(np.abs(want).max()))
    assert (got[1::2] == 0).all()
    order = np.argsort(keys, kind="stable")
    fold = np.zeros((n_keys,) + shape[1:], np.float32)
    for s in range(0, m, SEGMENT):
        part = np.zeros_like(fold)
        for i in order[s:s + SEGMENT]:
            part[keys[i]] = part[keys[i]] + values[i]
        fold = fold + part
    assert np.array_equal(got.view(np.uint32), fold.view(np.uint32))
    table = torch.from_numpy(rng.normal(size=(n_keys,) + shape[1:]).astype(np.float32))
    table.requires_grad_()
    gather_rows(table, torch.from_numpy(keys)).backward(torch.from_numpy(values))
    assert np.array_equal(table.grad.numpy(), got)
